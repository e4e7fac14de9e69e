"""The online serving entry point on one card (no reference analogue).

    python -m mpi_cuda_largescaleknn_torch.cli.serve_main points.float3 \
        -k 100 [--port 8080] [--engine auto] [--merge auto] [--shards R] \
        [--max-batch 1024] [--max-delay-ms 2] [--max-queue-rows 4096] \
        [--timeout-ms 5000] [--device cpu]
    python -m mpi_cuda_largescaleknn_torch.cli.serve_main points.float3 \
        -k 100 --num-slabs 8 --device-slab-budget 2g [--host-pool-bytes 4g]
    python -m mpi_cuda_largescaleknn_torch.cli.serve_main -k 100 \
        --tenant a=a.float3 --tenant b=b.npy [--num-slabs 4] \
        [--device-slab-budget 2g] [--tenant-quota-rows 1024]
    python -m mpi_cuda_largescaleknn_torch.cli.serve_main points.float3 \
        -k 100 --routing bounds --num-hosts 4 --host-id I [--wire auto] \
        [--num-slabs 2 --device-slab-budget 2g]
    python -m mpi_cuda_largescaleknn_torch.cli.serve_main points.float3 \
        -k 100 --routing bounds --num-hosts 4 --standby
    python -m mpi_cuda_largescaleknn_torch.cli.serve_main points.float3 \
        -k 100 --merge device --coordinator 127.0.0.1:C --num-hosts 4 \
        --host-id I [--shards 4] [--seq-timeout-s 120]

Loads a point set, builds the resident index on the card, builds every
shape bucket's launch plan (and the kernels, at their first launch), and
serves queries over HTTP until interrupted. Endpoints: POST /knn (JSON or
binary), GET /healthz, /stats, /metrics (Prometheus text). With
``--num-slabs`` the index streams through the tiered slab pool
(serve/slabpool.py): only ``--device-slab-budget`` bytes of slab engines
live on the card. With ``--tenant`` (repeatable) one process serves many
indexes from one slab pool (serve/tenancy.py): POST /v1/<tenant>/knn,
per-tenant /stats and ``{tenant=}`` metrics, per-tenant admission quotas.
With ``--routing bounds`` the process is one host of a routed pod: it
loads only its row slab ``[N*i/H, N*(i+1)/H)`` and serves full candidate
rows on ``POST /route_knn`` to the pod front end (``python -m
mpi_cuda_largescaleknn_torch.serve.frontend --hosts ...``); with
``--standby`` it holds no slab until the front end's replica manager
directs it to adopt one (``POST /adopt_slab``). With ``--coordinator``
and ``--num-hosts`` (no ``--routing bounds``) it is one process of a
replicate pod: the processes join one ``torch.distributed`` group before
any work on the card, each uploads the slabs of its own ring positions,
and the device merge of every batch runs across them; each serves its
rows of the pod-final answer on ``POST /shard_knn?seq=N``. The port of
the JAX package's ``cli/serve_main.py``.
"""

from __future__ import annotations

import math
import sys

SERVE_FLAGS = """
  -k N              neighbors per query (required)
  -r R              max search radius (default inf)
  --port P          HTTP port (default 8080; 0 = pick a free port)
  --host H          bind address (default 127.0.0.1)
  --device D        cuda (default) | cpu (the kernels' plain PyTorch
                    versions; for tests and small inputs)
  --engine E        tiled | pallas_tiled | bruteforce | auto (default auto
                    = pallas_tiled, the traversal kernel; tiled is its
                    twin in PyTorch ops, bruteforce the flat twin)
  --merge M         host | device | auto (default auto): where the R-way
                    cross-shard top-k merge runs — device merges on the
                    card (one final [Q,k] fetch, no numpy merge), host
                    fetches R partials; auto = device at a power-of-two
                    shard count
  --shards N        virtual shards on the one card (default 1)
  --bucket-size N   points per spatial bucket (0 = engine-tuned auto)
  --score-dtype T   distance scoring: f32 (exact elementwise, the default)
                    | bf16 (matmul-form score on the tensor cores + exact
                    f32 rescore of the survivors, at D >= 16)
  --query-buckets N query-side buckets per padded batch (0 = auto, ~k
                    queries per bucket; 1 = single whole-batch bucket AND
                    disables the Morton admission sort). Served batches
                    are Morton-sorted so the buckets are spatially tight
  --max-batch N     widest padded query batch / shape bucket (default 1024)
  --min-batch N     narrowest shape bucket (default 8)
  --num-slabs N     tiered slab index (default 0 = fully resident): split
                    the index into N row slabs and serve them through the
                    device / host-RAM / file slab pool (serve/slabpool.py),
                    bit-identical to fully resident at every budget; a
                    cold slab STALLS, never approximates
  --device-slab-budget B  device-memory budget in bytes of the resident
                    slab engines (suffixes k/m/g; 0 = unbounded), counted
                    against each slab engine's device_bytes; least
                    recently used slabs evict, pinned ones never
  --host-pool-bytes B  host-RAM row-pool budget in bytes (suffixes k/m/g;
                    0 = unbounded); slabs past it are read again from the
                    file (mmap for .npy)
  --host-pool-slabs N  the same cap counted in slabs (0 = unbounded);
                    both caps apply when both are set
  --tenant NAME=PATH  multi-index tenancy (repeatable; serve/tenancy.py):
                    serve PATH's index as tenant NAME at POST
                    /v1/NAME/knn. All tenants share ONE slab pool (the
                    budgets above), one launch-plan cache and one
                    admission controller. The FIRST --tenant is the
                    default tenant: legacy /knn routes to it. Each
                    tenant's index is split into --num-slabs slabs
                    (default 1); no positional input in this mode
  --tenant-quota-rows N  per-tenant admission quota: each tenant may hold
                    at most N queued+in-flight rows of --max-queue-rows
                    (0 = global cap only); over quota is a 429 with
                    Retry-After
  --prefetch-depth N  next-nearest slabs promoted in the background for
                    each dispatched batch (default 1; the batcher also
                    announces the next batch's slabs a batch ahead)
  --max-delay-ms F  micro-batch flush deadline (default 2.0)
  --pipeline-depth N  batches in flight between dispatch and demux
                    (default 2: the next batch's traversal overlaps the
                    previous batch's fetch and merge; 1 = serialized)
  --max-queue-rows N  admission cap on queued+running rows (default 4096)
  --timeout-ms F    default per-request deadline (default 5000)
  --qcache-rows N   certified query cache capacity in cached rows
                    (default 4096; 0 disables the cache): byte-identical
                    exact-hit reuse plus in-flight dedup of concurrent
                    duplicates
  --qcache-seed-rows N  triangle-inequality seed pool rows (default 512;
                    0 disables radius seeding while keeping the hit/dedup
                    tiers): near-duplicates of a cached query start their
                    rows at a certified radius
  --recall-policy PATH  recall-SLO plan table (JSON) replacing the
                    built-in defaults; requests carrying "recall": 0.95
                    (or ?recall= for binary) are served by the cheapest
                    plan whose measured recall meets the target
  --seq-timeout-s F how long a pod host waits for its turn in the
                    /shard_knn sequence order before answering 503 +
                    Retry-After (default 120; replicate mode only — a
                    lower seq that never arrives means the pod stream is
                    stalled). Fault injection for failure drills rides the
                    KNN_FAULTS env var / POST /faults (serve/faults.py)
  --no-warmup       skip building all shape buckets before serving
  --timings         print engine phase timings as JSON on shutdown
  --verbose         log each HTTP request to stderr

Pod mode — launch ONE copy per host with the same arguments plus
--host-id. The replicate pod (default --routing off): the processes join
one torch.distributed group (NCCL when each has a card of its own, gloo
when they share one or run on the CPU) and each serves its rows of the
pod-final answer over POST /shard_knn to the pod front end
(python -m mpi_cuda_largescaleknn_torch.serve.frontend --hosts ...);
--shards (default: one per host) must be a power of two of at least
--num-hosts, and --merge device is the only merge:
  --coordinator A   coordinator address host:port
  --num-hosts N     number of cooperating serving processes
  --host-id I       this process's id in [0, N)
  --routing M       off | bounds (default off). bounds = shard-local
                    routing: the hosts stay INDEPENDENT (no coordinator,
                    no shared mesh) — each loads only its row slab
                    [N*i/H, N*(i+1)/H) of the input, serves full candidate
                    rows on POST /route_knn, and the front end routes each
                    query by the hosts' shard bounding boxes. Routing wins
                    need a spatially-ordered input file (Morton order); an
                    unordered file stays exact but routes every query
                    everywhere. With --num-slabs the host streams its slab
                    through the tiered slab pool
  --standby         routed mode only: start as a WARM STANDBY — load no
                    slab, build no engine, and wait for the pod front
                    end's replica manager to direct an adoption (POST
                    /adopt_slab). The standby then builds the named slab
                    from this process's input file (or pulls it from a
                    surviving replica), warms every shape bucket on its
                    card, and serves it — fingerprint-gated by the front
                    end before any query routes here
  --wire M          auto | f32 (default auto). Host-side wire-codec
                    capability: auto advertises the compressed codecs
                    (q16 candidate rows, d16 slab transfer — served only
                    when the peer asks); f32 advertises and serves only
                    the uncompressed codec
"""


def usage(error: str) -> "NoReturn":  # noqa: F821
    sys.stderr.write(f"Error: {error}\n\n")
    sys.stderr.write(f"torchknn-serve -k <k> [options] <input>\n{SERVE_FLAGS}")
    sys.exit(1)


def parse_bytes(text: str) -> int:
    """'268435456', '256m', '2g', '64k' -> bytes (suffixes are binary)."""
    t = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(t[-1:], 1)
    return int(float(t[:-1] if mult > 1 else t) * mult)


def parse_serve_args(argv: list[str]) -> dict:
    """The JAX CLI's option dict plus ``device``."""
    opt = {"k": 0, "max_radius": math.inf, "in_path": "", "port": 8080,
           "host": "127.0.0.1", "engine": "auto", "merge": "auto",
           "score_dtype": "f32", "shards": None,
           "bucket_size": 0, "query_buckets": 0,
           "max_batch": 1024, "min_batch": 8,
           "num_slabs": 0, "device_slab_budget": 0,
           "host_pool_slabs": 0, "host_pool_bytes": 0,
           "tenants": [], "tenant_quota_rows": 0,
           "prefetch_depth": 1,
           "max_delay_ms": 2.0, "pipeline_depth": 2,
           "max_queue_rows": 4096, "seq_timeout_s": None,
           "qcache_rows": 4096, "qcache_seed_rows": 512,
           "recall_policy": None,
           "timeout_ms": 5000.0, "warmup": True, "timings": False,
           "verbose": False,
           "coordinator": None, "num_hosts": 1, "host_id": 0,
           "routing": "off", "standby": False, "wire": "auto",
           "device": None}
    i = 0
    try:
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("-"):
                opt["in_path"] = arg
            elif arg == "-k":
                i += 1; opt["k"] = int(argv[i])
            elif arg == "-r":
                i += 1; opt["max_radius"] = float(argv[i])
            elif arg == "--port":
                i += 1; opt["port"] = int(argv[i])
            elif arg == "--host":
                i += 1; opt["host"] = argv[i]
            elif arg == "--device":
                i += 1; opt["device"] = argv[i]
            elif arg == "--engine":
                i += 1; opt["engine"] = argv[i]
            elif arg == "--merge":
                i += 1; opt["merge"] = argv[i]
            elif arg == "--score-dtype":
                i += 1; opt["score_dtype"] = argv[i]
            elif arg == "--shards":
                i += 1; opt["shards"] = int(argv[i])
            elif arg == "--bucket-size":
                i += 1; opt["bucket_size"] = int(argv[i])
            elif arg == "--query-buckets":
                i += 1; opt["query_buckets"] = int(argv[i])
            elif arg == "--max-batch":
                i += 1; opt["max_batch"] = int(argv[i])
            elif arg == "--min-batch":
                i += 1; opt["min_batch"] = int(argv[i])
            elif arg == "--num-slabs":
                i += 1; opt["num_slabs"] = int(argv[i])
            elif arg == "--device-slab-budget":
                i += 1; opt["device_slab_budget"] = parse_bytes(argv[i])
            elif arg == "--host-pool-slabs":
                i += 1; opt["host_pool_slabs"] = int(argv[i])
            elif arg == "--host-pool-bytes":
                i += 1; opt["host_pool_bytes"] = parse_bytes(argv[i])
            elif arg == "--tenant":
                i += 1
                name, sep, path = argv[i].partition("=")
                if not sep or not name or not path:
                    usage(f"--tenant wants NAME=PATH, got '{argv[i]}'")
                opt["tenants"].append((name, path))
            elif arg == "--tenant-quota-rows":
                i += 1; opt["tenant_quota_rows"] = int(argv[i])
            elif arg == "--prefetch-depth":
                i += 1; opt["prefetch_depth"] = int(argv[i])
            elif arg == "--max-delay-ms":
                i += 1; opt["max_delay_ms"] = float(argv[i])
            elif arg == "--pipeline-depth":
                i += 1; opt["pipeline_depth"] = int(argv[i])
            elif arg == "--max-queue-rows":
                i += 1; opt["max_queue_rows"] = int(argv[i])
            elif arg == "--timeout-ms":
                i += 1; opt["timeout_ms"] = float(argv[i])
            elif arg == "--seq-timeout-s":
                i += 1; opt["seq_timeout_s"] = float(argv[i])
            elif arg == "--qcache-rows":
                i += 1; opt["qcache_rows"] = int(argv[i])
            elif arg == "--qcache-seed-rows":
                i += 1; opt["qcache_seed_rows"] = int(argv[i])
            elif arg == "--recall-policy":
                i += 1; opt["recall_policy"] = argv[i]
            elif arg == "--coordinator":
                i += 1; opt["coordinator"] = argv[i]
            elif arg == "--num-hosts":
                i += 1; opt["num_hosts"] = int(argv[i])
            elif arg == "--host-id":
                i += 1; opt["host_id"] = int(argv[i])
            elif arg == "--routing":
                i += 1; opt["routing"] = argv[i]
            elif arg == "--standby":
                opt["standby"] = True
            elif arg == "--wire":
                i += 1; opt["wire"] = argv[i]
            elif arg == "--no-warmup":
                opt["warmup"] = False
            elif arg == "--timings":
                opt["timings"] = True
            elif arg == "--verbose":
                opt["verbose"] = True
            else:
                usage(f"unknown cmdline arg '{arg}'")
            i += 1
    except (IndexError, ValueError):
        usage(f"invalid or missing value for '{argv[i - 1] if i else ''}'")
    if opt["tenants"]:
        if opt["in_path"]:
            usage("tenancy mode takes its inputs from --tenant NAME=PATH "
                  f"— drop the positional input '{opt['in_path']}'")
        if opt["num_hosts"] > 1 or opt["routing"] != "off" or opt["standby"]:
            usage("--tenant (multi-index tenancy) is single-process "
                  "serving — it does not combine with pod, routed, or "
                  "standby modes")
        names = [n for n, _p in opt["tenants"]]
        if len(set(names)) != len(names):
            usage(f"duplicate tenant names in {names}")
    elif not opt["in_path"]:
        usage("no input file name specified")
    if opt["k"] < 1:
        usage("no k specified, or invalid k value")
    if opt["routing"] not in ("off", "bounds"):
        usage(f"--routing must be off or bounds, got '{opt['routing']}'")
    if opt["wire"] not in ("auto", "f32"):
        usage(f"--wire must be auto or f32, got '{opt['wire']}'")
    if opt["routing"] == "bounds" and opt["coordinator"]:
        usage("--routing bounds hosts are independent processes — they "
              "never join a global mesh, so --coordinator is a config "
              "error (use --routing off for the pod-collective mode)")
    if opt["standby"] and opt["routing"] != "bounds":
        usage("--standby is the routed tier's slab-handoff target — "
              "launch with --routing bounds")
    if opt["num_slabs"] < 0:
        usage(f"--num-slabs must be >= 0, got {opt['num_slabs']}")
    if opt["num_slabs"] > 0:
        if opt["num_hosts"] > 1 and opt["routing"] != "bounds":
            usage("--num-slabs (tiered slab streaming) does not combine "
                  "with the pod-collective mode — the streamed slab set "
                  "varies per batch, a pod-wide SPMD program cannot; use "
                  "--routing bounds hosts (each streams its own slab)")
        if opt["standby"]:
            usage("--standby hosts materialize their engine at adoption "
                  "time — launch the adopted engine without --num-slabs")
    return opt


def main(argv: list[str] | None = None, ready=None) -> int:
    """Serve until interrupted. ``ready`` (for callers that run the CLI in
    process) is called with the server once it is warm and listening; the
    caller stops it with ``server.shutdown()`` from another thread."""
    opt = parse_serve_args(sys.argv[1:] if argv is None else argv)

    from mpi_cuda_largescaleknn_torch.io.reader import read_points
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.server import (
        build_server,
        serve_forever,
    )

    engine_kw = dict(
        num_shards=opt["shards"] or 1, engine=opt["engine"],
        bucket_size=opt["bucket_size"], max_radius=opt["max_radius"],
        max_batch=opt["max_batch"], min_batch=opt["min_batch"],
        merge=opt["merge"], query_buckets=opt["query_buckets"],
        score_dtype=opt["score_dtype"], device=opt["device"])
    tier_kw = dict(device_slab_budget=opt["device_slab_budget"],
                   host_pool_slabs=opt["host_pool_slabs"],
                   host_pool_bytes=opt["host_pool_bytes"],
                   prefetch_depth=opt["prefetch_depth"])
    if opt["routing"] == "bounds":
        if opt["standby"]:
            return serve_standby(opt, ready)
        return serve_routed_host(opt, engine_kw, tier_kw, ready)
    if opt["num_hosts"] > 1:
        return serve_pod_host(opt, engine_kw, ready)
    if opt["tenants"]:
        # many indexes behind ONE slab pool, one plan cache and one
        # admission controller; each tenant's index streams as
        # --num-slabs slabs (default 1)
        from mpi_cuda_largescaleknn_torch.serve.tenancy import (
            MultiTenantEngine,
            TenantSpec,
        )

        engine = MultiTenantEngine(
            [TenantSpec(name, path=path,
                        num_slabs=max(1, opt["num_slabs"]))
             for name, path in opt["tenants"]],
            k=opt["k"], **tier_kw, **engine_kw)
        print(f"multi-index tenancy: {len(opt['tenants'])} tenants "
              f"({', '.join(n for n, _p in opt['tenants'])}), "
              f"{engine.n_points} points total, default tenant "
              f"'{engine.default_tenant}', quota "
              f"{opt['tenant_quota_rows'] or 'unsliced'} rows/tenant")
    elif opt["num_slabs"] > 0:
        # the index stays in the source file (the cold tier) and a
        # bounded host-RAM pool; only --device-slab-budget bytes of slab
        # engines are on the card at once
        from mpi_cuda_largescaleknn_torch.serve.slabpool import (
            StreamingKnnEngine,
        )

        engine = StreamingKnnEngine(
            opt["in_path"], num_slabs=opt["num_slabs"], k=opt["k"],
            **tier_kw, **engine_kw)
        print(f"tiered index: {engine.n_points} points from "
              f"{opt['in_path']} in {opt['num_slabs']} slabs "
              f"({engine.slab_device_bytes} B per resident slab; device "
              f"budget {opt['device_slab_budget'] or 'unbounded'} B, host "
              "pool "
              + (f"{opt['host_pool_bytes']} B" if opt["host_pool_bytes"]
                 else f"{opt['host_pool_slabs'] or 'unbounded'} slabs")
              + ")")
    else:
        points = read_points(opt["in_path"])
        print(f"loaded {len(points)} points from {opt['in_path']}")
        engine = ResidentKnnEngine(points, opt["k"], **engine_kw)
    recall_policy = None
    if opt["recall_policy"]:
        from mpi_cuda_largescaleknn_torch.serve.recall import RecallPolicy

        recall_policy = RecallPolicy.from_file(opt["recall_policy"])
        print(f"recall policy from {opt['recall_policy']}: "
              + ", ".join(f"{p.name} (est {p.recall_estimated:g})"
                          for p in recall_policy.plans))
    server = build_server(
        engine, host=opt["host"], port=opt["port"],
        max_delay_s=opt["max_delay_ms"] / 1e3,
        pipeline_depth=opt["pipeline_depth"],
        max_queue_rows=opt["max_queue_rows"],
        default_timeout_s=opt["timeout_ms"] / 1e3,
        verbose=opt["verbose"],
        recall_policy=recall_policy,
        tenant_quota_rows=opt["tenant_quota_rows"],
        qcache_rows=opt["qcache_rows"],
        qcache_seed_rows=opt["qcache_seed_rows"])
    try:
        serve_forever(server, warmup=opt["warmup"], ready=ready)
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.close()
        close = getattr(engine, "close", None)
        if close is not None:
            close()
        if opt["timings"]:
            sys.stderr.write(engine.timers.dump() + "\n")
    return 0


def _serve_host(server, engine, opt: dict, banner: str, ready) -> int:
    """Warm the engine (a standby has none yet), flip ready, print
    ``banner`` and serve until interrupted."""
    try:
        if opt["warmup"] and engine is not None:
            info = engine.warmup()
            print(f"warmup plans built: {info['per_bucket_s']}")
        server.ready = engine is not None
        host, port = server.server_address[:2]
        print(banner.replace("{url}", f"http://{host}:{port}"), flush=True)
        if ready is not None:
            ready(server)
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.close()
        engine = server.engine
        close = getattr(engine, "close", None)
        if close is not None:
            close()
        if opt["timings"] and engine is not None:
            sys.stderr.write(engine.timers.dump() + "\n")
    return 0


def serve_standby(opt: dict, ready=None) -> int:
    """A warm standby of a routed pod: no slab and no engine, only the
    engine's knobs, until the front end's replica manager directs an
    adoption (``POST /adopt_slab``); then it builds the named slab on its
    card from ``in_path`` (or pulls it from a surviving replica), warms
    every shape bucket and serves it (serve/frontend.py)."""
    from mpi_cuda_largescaleknn_torch.serve.frontend import HostSliceServer

    standby_config = {
        "path": opt["in_path"], "num_hosts": opt["num_hosts"],
        "k": opt["k"], "shards": opt["shards"],
        "engine": opt["engine"], "merge": opt["merge"],
        "bucket_size": opt["bucket_size"],
        "max_radius": opt["max_radius"],
        "max_batch": opt["max_batch"], "min_batch": opt["min_batch"],
        "query_buckets": opt["query_buckets"],
        "score_dtype": opt["score_dtype"], "device": opt["device"]}
    server = HostSliceServer((opt["host"], opt["port"]), None,
                             routing="bounds",
                             standby_config=standby_config,
                             wire=opt["wire"], verbose=opt["verbose"])
    return _serve_host(
        server, None, opt,
        "standby host on {url} — no slab adopted yet; waiting for POST "
        f"/adopt_slab ({opt['in_path']}, {opt['num_hosts']} slabs)", ready)


def serve_pod_host(opt: dict, engine_kw: dict, ready=None) -> int:
    """One process of a replicate pod: check the ring positions (the same
    arithmetic on every process), join the process group BEFORE any work
    on the card, load the whole point set, upload the slabs of this
    process's positions, warm every shape bucket in lock-step with the
    other hosts (each warmup batch is a collective) and serve this
    process's rows of every batch on ``POST /shard_knn`` in ``seq``
    order."""
    import torch.distributed as dist

    from mpi_cuda_largescaleknn_torch.io.reader import read_points
    from mpi_cuda_largescaleknn_torch.parallel.mesh import (
        Mesh,
        initialize_distributed,
        my_mesh_positions,
    )
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.frontend import HostSliceServer

    num_hosts, host_id = opt["num_hosts"], opt["host_id"]
    num_shards = opt["shards"] or num_hosts
    positions = my_mesh_positions(num_shards, num_hosts, host_id)
    device, backend, why = initialize_distributed(
        opt["coordinator"], num_hosts, host_id, device=opt["device"])
    print(f"# host {host_id} of {num_hosts}: torch.distributed {backend} "
          f"({why}) on {device}, positions {positions} of {num_shards}",
          flush=True)
    try:
        points = read_points(opt["in_path"])
        print(f"loaded {len(points)} points from {opt['in_path']}")
        engine = ResidentKnnEngine(
            points, opt["k"], mesh=Mesh(num_shards, device),
            **dict(engine_kw, num_shards=num_shards, device=device))
        server = HostSliceServer((opt["host"], opt["port"]), engine,
                                 routing="off",
                                 seq_timeout_s=opt["seq_timeout_s"],
                                 wire=opt["wire"], verbose=opt["verbose"])
        return _serve_host(
            server, engine, opt,
            f"serving pod slice {engine.process_index}/"
            f"{engine.process_count} on {{url}} (mesh positions "
            f"{engine.stats()['my_positions']})", ready)
    finally:
        dist.destroy_process_group()


def serve_routed_host(opt: dict, engine_kw: dict, tier_kw: dict,
                      ready=None) -> int:
    """One host of a routed pod: this process owns row slab ``host_id`` of
    ``num_hosts`` and serves it independently (no shared mesh), with
    global neighbor ids through the engine's id offset and full candidate
    rows for the front end's cross-host fold. Only the slab is read. With
    ``--num-slabs`` the slab streams through the tiered pool as that many
    sub-slabs, so the card's budget no longer caps the slab's size."""
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        load_slab_rows,
        materialize_slab_engine,
    )
    from mpi_cuda_largescaleknn_torch.serve.frontend import HostSliceServer

    host_id, num_hosts = opt["host_id"], opt["num_hosts"]
    if not (0 <= host_id < num_hosts):
        usage(f"--host-id {host_id} outside [0, {num_hosts})")
    if opt["num_slabs"] > 0:
        from mpi_cuda_largescaleknn_torch.serve.slabpool import (
            StreamingKnnEngine,
        )

        rows, id_offset, n_total = load_slab_rows(opt["in_path"], host_id,
                                                  num_hosts)
        engine = StreamingKnnEngine(
            points=rows, num_slabs=opt["num_slabs"], k=opt["k"],
            id_offset=id_offset, emit="candidates", **tier_kw, **engine_kw)
        print(f"routed host {host_id}/{num_hosts}: streaming rows "
              f"[{id_offset}:{id_offset + engine.n_points}) of {n_total} as "
              f"{opt['num_slabs']} slabs (device budget "
              f"{opt['device_slab_budget'] or 'unbounded'} B)")
    else:
        engine, id_offset, n_total = materialize_slab_engine(
            opt["in_path"], host_id, num_hosts, k=opt["k"], **engine_kw)
        print(f"routed host {host_id}/{num_hosts}: loaded rows "
              f"[{id_offset}:{id_offset + engine.n_points}) of {n_total} "
              f"from {opt['in_path']}")
    server = HostSliceServer((opt["host"], opt["port"]), engine,
                             routing="bounds", wire=opt["wire"],
                             verbose=opt["verbose"])
    return _serve_host(
        server, engine, opt,
        f"serving routed slab host {host_id}/{num_hosts} on {{url}} (rows "
        f"[{id_offset}:{id_offset + engine.n_points}) of {n_total})", ready)


if __name__ == "__main__":
    sys.exit(main())
