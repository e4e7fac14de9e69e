"""CLI parsing — the reference's exact 5-flag surface plus the port's flags.

The reference's argv loop: positional input path, ``-o`` output, ``-k``
int (required), ``-r`` float max search radius (default inf), ``-g``
GPU-affinity modulus, anything else -> usage error + exit(1). Every
double-dash option of the JAX package's batch CLIs is ported.
"""

from __future__ import annotations

import math
import sys

from mpi_cuda_largescaleknn_torch.core.config import KnnConfig

PORT_FLAGS = """
Port options (no reference analogue):
  --device D        cuda (default) | cpu (the kernels' plain PyTorch
                    versions; for tests and small inputs)
  --shards N        virtual shards on the one card (default 1; the
                    pre-partitioned CLI: one per listed file)
  --engine E        auto (= pallas_tiled) | pallas_tiled (the
                    nearest-first traversal kernel) | tiled (its XLA twin,
                    PyTorch ops) | pallas (the flat brute-force kernel) |
                    bruteforce (its XLA twin) | tree (the stack-free
                    kd-tree traversal, D=3 only)
  --query-tile N    pallas / bruteforce: queries per tile (default 2048;
                    results do not change; pallas at D=3: the kernel's
                    rows per block, clamped; other D take the ring
                    kernel's 128-row blocks)
  --point-tile N    pallas / bruteforce: points per tile (default 2048;
                    results do not change; pallas at D=3: the kernel's
                    staged lanes, clamped; other D take 64-lane chunks)
  --bucket-size N   points per spatial bucket (tiled engines; default
                    auto: 256 for pallas_tiled, 128 for tiled)
  --point-group N   coarsen the resident point side by this power-of-two
                    factor (tiled engines; default auto: 2 for
                    pallas_tiled, 1 for tiled; 1 disables)
  --score-dtype T   f32 (exact elementwise, default) | bf16 (matmul-form
                    scores at D >= 16, survivors rescored exactly: on the
                    tensor cores for pallas_tiled, PyTorch matmuls for
                    tiled and bruteforce; pallas and tree refuse it, the
                    pre-partitioned pipeline scores f32)
  --query-chunk N   stream queries in chunks of N rows a shard: candidate
                    rows held for N*k a shard (e.g. -k 100 at 100M points)
  --merge M         chunked runs: host (the ring per chunk, default) |
                    device (every shard folds the whole chunk, the partial
                    rows merged on the card) | auto (device at a
                    power-of-two shard count, else host with a warning)
  --checkpoint-dir D  snapshot the rounds' state (chunked runs: the
                    finished chunks) in D; a run relaunched with the same
                    arguments resumes where it stopped
  --checkpoint-every N  rounds (chunks) between snapshots (default 1)
  --timings         print phase timings as JSON to stderr (pre-partitioned
                    chunked runs: rounds_per_chunk too)
  --selfcheck N     after the run, verify N random outputs against an exact
                    streamed recomputation and fail loudly on mismatch
  --write-indices P  also write the k neighbor ids per point (int32,
                    ascending by distance, -1 = fewer than k found)
  --profile-dir P   trace the run with torch.profiler (host operators and
                    the card's kernels) into P as a Chrome trace; the
                    program's phases are spans in it, lsk.<phase>:
                    shard_and_pad, upload, partition, warm_start,
                    traverse (box_order: each fold's bucket order),
                    extract, download, trim (obs/trace.py)
  --coordinator A   several processes (the reference's mpirun): host:port
                    of process 0's store. Launch ONE copy of this CLI per
                    process with the same arguments plus --host-id; each
                    reads and writes only its own slabs (cli/multihost.py)
  --num-hosts N     the number of cooperating processes (default 1)
  --host-id I       this process's id in [0, N); its card is
                    cuda:(I % cards); NCCL when every process has its own
                    card, gloo when they share one or run on the CPU
"""


def usage(program: str, error: str) -> "NoReturn":  # noqa: F821
    sys.stderr.write(f"Error: {error}\n\n")
    sys.stderr.write(
        f"{program} -k <k> [-r <maxRadius>] <input> -o <output>\n{PORT_FLAGS}")
    sys.exit(1)


def parse_args(program: str, argv: list[str]):
    """Returns (config, in_path, out_path, extras dict). Without
    ``--shards`` the config's ``num_shards`` is 0: one shard for the
    unordered pipeline, one per file for the pre-partitioned one."""
    k = 0
    max_radius = math.inf
    affinity = 0
    in_path = ""
    out_path = ""
    extras = {"device": None, "shards": None, "engine": "auto",
              "query_tile": 2048, "point_tile": 2048, "bucket_size": 0,
              "point_group": 0, "score_dtype": "f32", "timings": False,
              "selfcheck": 0, "write_indices": None, "profile_dir": None,
              "query_chunk": 0, "merge": "host", "checkpoint_dir": None,
              "checkpoint_every": 1, "coordinator": None, "num_hosts": 1,
              "host_id": 0}
    i = 0
    try:
        while i < len(argv):
            arg = argv[i]
            if arg == "-o":
                i += 1; out_path = argv[i]
            elif not arg.startswith("-"):
                in_path = arg
            elif arg == "-r":
                i += 1; max_radius = float(argv[i])
            elif arg == "-g":
                i += 1; affinity = int(argv[i])
            elif arg == "-k":
                i += 1; k = int(argv[i])
            elif arg == "--device":
                i += 1; extras["device"] = argv[i]
            elif arg == "--shards":
                i += 1; extras["shards"] = int(argv[i])
            elif arg == "--engine":
                i += 1; extras["engine"] = argv[i]
            elif arg == "--query-tile":
                i += 1; extras["query_tile"] = int(argv[i])
            elif arg == "--point-tile":
                i += 1; extras["point_tile"] = int(argv[i])
            elif arg == "--bucket-size":
                i += 1; extras["bucket_size"] = int(argv[i])
            elif arg == "--point-group":
                i += 1; extras["point_group"] = int(argv[i])
            elif arg == "--score-dtype":
                i += 1; extras["score_dtype"] = argv[i]
            elif arg == "--timings":
                extras["timings"] = True
            elif arg == "--selfcheck":
                i += 1; extras["selfcheck"] = int(argv[i])
            elif arg == "--write-indices":
                i += 1; extras["write_indices"] = argv[i]
            elif arg == "--profile-dir":
                i += 1; extras["profile_dir"] = argv[i]
            elif arg == "--query-chunk":
                i += 1; extras["query_chunk"] = int(argv[i])
            elif arg == "--merge":
                i += 1; extras["merge"] = argv[i]
            elif arg == "--checkpoint-dir":
                i += 1; extras["checkpoint_dir"] = argv[i]
            elif arg == "--checkpoint-every":
                i += 1; extras["checkpoint_every"] = int(argv[i])
            elif arg == "--coordinator":
                i += 1; extras["coordinator"] = argv[i]
            elif arg == "--num-hosts":
                i += 1; extras["num_hosts"] = int(argv[i])
            elif arg == "--host-id":
                i += 1; extras["host_id"] = int(argv[i])
            else:
                usage(program, f"unknown cmdline arg '{arg}'")
            i += 1
    except (IndexError, ValueError):
        usage(program, f"invalid or missing value for '{argv[i - 1] if i else ''}'")

    if not in_path:
        usage(program, "no input file name specified")
    if not out_path:
        usage(program, "no output file name specified")
    if k < 1:
        usage(program, "no k specified, or invalid k value")

    cfg = KnnConfig(k=k, max_radius=max_radius, device_affinity=affinity,
                    device=extras["device"], engine=extras["engine"],
                    query_tile=extras["query_tile"],
                    point_tile=extras["point_tile"],
                    bucket_size=extras["bucket_size"],
                    point_group=extras["point_group"],
                    num_shards=extras["shards"] or 0,
                    score_dtype=extras["score_dtype"],
                    profile_dir=extras["profile_dir"],
                    query_chunk=extras["query_chunk"],
                    merge=extras["merge"],
                    checkpoint_dir=extras["checkpoint_dir"],
                    checkpoint_every=extras["checkpoint_every"])
    return cfg, in_path, out_path, extras


def launch_counts() -> dict:
    """The process's kernel launches so far, by their ``--timings`` keys:
    the traversal (any route; the ring kernel with resident queries, with D
    streamed; the D=3 kernels, and of those the wide fold's; the bf16
    kernel, and of those with resident query halves, with D streamed) and
    the flat fold (any route; the D=3 kernels, and of those the wide
    fold's; the ring kernel); the self-join's warm start on the traversal
    kernels (any route; the D=3 kernels, and of those the wide fold's; the
    ring kernel, with D streamed); then the work of the engines that
    launch no kernel of their own: the twin's chunk merges (``tiled``) and
    the tree's folds and lockstep steps (``tree``)."""
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda,
        warm_start_self_cuda,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import knn_update_tiled
    from mpi_cuda_largescaleknn_torch.ops.traverse import knn_update_tree

    kt, bf = knn_update_tiled_cuda, knn_update_bf_cuda
    ws = warm_start_self_cuda
    return {"knn_tiled_launches": kt.launches,
            "knn_tiled_ring_launches": kt.ring_launches,
            "knn_tiled_stream_launches": kt.stream_launches,
            "knn_tiled_d3_launches": kt.d3_launches,
            "knn_tiled_d3_wide_launches": kt.d3_wide_launches,
            "knn_tiled_mxu_launches": kt.mxu_launches,
            "knn_tiled_wgmma_launches": kt.wgmma_launches,
            "knn_tiled_wgmma_stream_launches": kt.wgmma_stream_launches,
            "knn_bf_launches": bf.launches,
            "knn_bf_d3_launches": bf.d3_launches,
            "knn_bf_d3_wide_launches": bf.d3_wide_launches,
            "knn_bf_ring_launches": bf.ring_launches,
            "warm_start_launches": ws.launches,
            "warm_start_d3_launches": ws.d3_launches,
            "warm_start_d3_wide_launches": ws.d3_wide_launches,
            "warm_start_ring_launches": ws.ring_launches,
            "warm_start_stream_launches": ws.stream_launches,
            "tiled_folds": knn_update_tiled.folds,
            "tree_folds": knn_update_tree.folds,
            "tree_steps": knn_update_tree.steps}
