"""The port's routed pod (``serve/frontend.py``: two ``HostSliceServer``
slab hosts with ``device="cpu"`` engines behind ``build_frontend``) against
the same pod built from the JAX package (engine ``tiled``), on
``tests/test_routing.py``'s adversarial 600-row fixture: host 0 owns
cluster A plus five copies of host 1's last rows (distance-0 ties across
hosts, a box that overlaps host 1's region, so B-region queries escalate),
host 1 owns cluster B. ``/knn`` bodies are byte-equal between the pods, in
JSON and binary, with ragged batches; the wave and escalation counts are
equal; the port's pod is byte-equal to one port engine over all 600 rows;
``PodBoundsTable`` and the pod validation agree with JAX's."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_routing import K, _routed_points


def _post(base, q, binary):
    q = np.ascontiguousarray(q, np.float32)
    if binary:
        data, ctype = q.tobytes(), "application/octet-stream"
    else:
        data = json.dumps({"queries": q.tolist(), "neighbors": True}).encode()
        ctype = "application/json"
    req = urllib.request.Request(base + "/knn", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv.ready = True
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _engine(pkg, points, **kw):
    """One engine of either package at the fixture's knobs."""
    kw = dict(dict(bucket_size=64, max_batch=32, min_batch=16), **kw)
    if pkg == "torch":
        from mpi_cuda_largescaleknn_torch.serve.engine import (
            ResidentKnnEngine,
        )

        return ResidentKnnEngine(points, K, num_shards=2, device="cpu", **kw)
    from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
    from mpi_cuda_largescaleknn_tpu.serve.engine import ResidentKnnEngine

    return ResidentKnnEngine(points, K, mesh=get_mesh(2), engine="tiled",
                             **kw)


def _frontend_module(pkg):
    if pkg == "torch":
        from mpi_cuda_largescaleknn_torch.serve import frontend
    else:
        from mpi_cuda_largescaleknn_tpu.serve import frontend
    return frontend


def build_pod(pkg, points, num_hosts=2, **fe_kw):
    """``num_hosts`` routed slab hosts of ``pkg`` and its front end:
    (front-end base url, host urls, servers to close, front end)."""
    from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds

    fe_mod = _frontend_module(pkg)
    hosts, urls = [], []
    for b, e in slab_bounds(len(points), num_hosts):
        eng = _engine(pkg, points[b:e], id_offset=b, emit="candidates")
        eng.warmup()
        srv = fe_mod.HostSliceServer(("127.0.0.1", 0), eng, routing="bounds")
        urls.append(_serve(srv))
        hosts.append(srv)
    fe = fe_mod.build_frontend(urls, port=0, **fe_kw)
    return _serve(fe), urls, hosts, fe


@pytest.fixture(scope="module")
def pods():
    points = _routed_points()
    built = {pkg: build_pod(pkg, points, pipeline_depth=2)
             for pkg in ("torch", "jax")}
    ref = _engine("torch", points, merge="device")
    ref.warmup()
    yield points, built, ref
    for base, _urls, hosts, fe in built.values():
        fe.close()
        for h in hosts:
            h.close()


def _ragged(n, points):
    from tests.oracle import random_points

    q = random_points(n, seed=300 + n)  # spans A, B and the gap
    q[: n // 3] = points[295: 295 + n // 3]  # ON the cross-host copies
    return q


def _both(pods, q, binary):
    _points, built, _ref = pods
    got = _post(built["torch"][0], q, binary)
    want = _post(built["jax"][0], q, binary)
    return got, want


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 32])
def test_ragged_bodies_equal_jax_pod(pods, n, binary):
    points, _built, ref = pods
    q = _ragged(n, points)
    got, want = _both(pods, q, binary)
    assert got == want and got[0] == 200
    want_d, want_n = ref.query(q)
    if binary:
        assert got[1] == np.asarray(want_d, "<f4").tobytes()
    else:
        obj = json.loads(got[1])
        assert obj["exact"] is True
        assert np.asarray(obj["dists"], np.float32).tobytes() \
            == want_d.tobytes()
        assert np.array_equal(np.asarray(obj["neighbors"], np.int32),
                              want_n)


def _workloads():
    rng = np.random.default_rng(77)
    gap = np.random.default_rng(88)
    return {"cluster_a": (rng.random((24, 3)) * 0.4).astype(np.float32),
            "cluster_b": (rng.random((24, 3)) * 0.4 + 0.6).astype(
                np.float32),
            "uniform": rng.random((32, 3)).astype(np.float32),
            "gap_escalates": (0.5 + 0.08 * gap.random((24, 3))).astype(
                np.float32),
            "deep_a": _routed_points()[10:34].copy()}


WORKLOADS = _workloads()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workloads_equal_jax_pod_and_one_engine(pods, name):
    _points, _built, ref = pods
    q = WORKLOADS[name]
    got, want = _both(pods, q, False)
    assert got == want
    obj = json.loads(got[1])
    want_d, want_n = ref.query(q)
    assert np.asarray(obj["dists"], np.float32).tobytes() == want_d.tobytes()
    assert np.array_equal(np.asarray(obj["neighbors"], np.int32), want_n)


def test_wave_and_escalation_counts_equal_jax(pods):
    """The same request sequence, sent one request at a time, takes the
    same waves in both pods: escalations, escalation waves, the
    hosts-visited histogram, rows routed to each host, the q16 exact
    re-merge's verbatim and re-fetched rows."""
    points, built, _ref = pods
    for name in sorted(WORKLOADS):
        _both(pods, WORKLOADS[name], False)
    for n in (3, 9, 31):
        _both(pods, _ragged(n, points), True)
    stats = {pkg: built[pkg][3].fanout.stats() for pkg in built}
    for key in ("escalations", "escalation_waves", "degraded_rows",
                "host_loss_events", "hosts_per_query",
                "hosts_per_query_mean"):
        assert stats["torch"]["routing"][key] \
            == stats["jax"]["routing"][key], key
    assert list(stats["torch"]["routing"]["routed_rows"].values()) \
        == list(stats["jax"]["routing"]["routed_rows"].values())
    for key in ("verbatim_rows", "refetch_rows", "refetch_posts",
                "refetch_failed_rows"):
        assert stats["torch"]["wire"][key] == stats["jax"]["wire"][key], key
    assert stats["torch"]["routing"]["escalations"] > 0
    hpq = stats["torch"]["routing"]["hosts_per_query"]
    assert "1" in hpq and "2" in hpq


def test_concurrent_clients_equal_one_engine(pods):
    from tests.oracle import random_points

    _points, built, ref = pods
    base = built["torch"][0]
    results = {}

    def client(i):
        q = random_points(3 + 2 * i, seed=900 + i)
        results[i] = (q, _post(base, q, i % 2 == 1))

    ths = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert len(results) == 6
    for i, (q, (status, body)) in results.items():
        assert status == 200
        want_d, want_n = ref.query(q)
        if i % 2:
            assert body == want_d.tobytes()
        else:
            obj = json.loads(body)
            assert np.asarray(obj["dists"], np.float32).tobytes() \
                == want_d.tobytes()
            assert np.array_equal(np.asarray(obj["neighbors"]), want_n)


def test_h1_pod_matches_one_engine(pods):
    """One routed host owning all 600 rows: routing is the identity, the
    bodies still byte-equal to one engine's answer."""
    points, _built, ref = pods
    base, _urls, hosts, fe = build_pod("torch", points, num_hosts=1,
                                       pipeline_depth=2)
    try:
        from tests.oracle import random_points

        q = random_points(17, seed=5)
        q[:4] = points[295:299]
        status, body = _post(base, q, True)
        assert status == 200
        assert body == ref.query(q)[0].tobytes()
    finally:
        fe.close()
        for h in hosts:
            h.close()


def _tables(seed):
    rng = np.random.default_rng(seed)
    hosts = []
    for h in range(3):
        shards = []
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.3:
                shards.append({"lo": None, "hi": None, "count": 0})
            else:
                lo = rng.random(3) * 2
                shards.append({"lo": lo.tolist(),
                               "hi": (lo + rng.random(3)).tolist(),
                               "count": int(rng.integers(1, 50))})
        hosts.append({"row_offset": 100 * h, "n_points": 100,
                      "shards": shards})
    hosts.append({"row_offset": 300, "n_points": 0,
                  "shards": [{"lo": None, "hi": None, "count": 0}]})
    return hosts


@pytest.mark.parametrize("seed", range(4))
def test_bounds_table_equals_jax(seed):
    from mpi_cuda_largescaleknn_torch.serve.frontend import PodBoundsTable
    from mpi_cuda_largescaleknn_tpu.serve.frontend import (
        PodBoundsTable as JaxTable,
    )

    hosts = _tables(seed)
    q = np.random.default_rng(100 + seed).random((40, 3)).astype(
        np.float32) * 3
    got = PodBoundsTable(hosts, 3).lower_bounds(q)
    want = JaxTable(hosts, 3).lower_bounds(q)
    assert got.tobytes() == want.tobytes()
    assert np.all(np.isinf(got[:, 3]))  # the empty host: never routed
    assert PodBoundsTable(hosts, 3).lower_bounds(
        np.zeros((0, 3), np.float32)).shape == (0, 4)
    bad = [{"row_offset": 0, "n_points": 5,
            "shards": [{"lo": None, "hi": None, "count": 5}]}]
    for table in (PodBoundsTable, JaxTable):
        with pytest.raises(ValueError, match="malformed"):
            table(bad, 3)


def test_pod_config_equals_jax(pods):
    from mpi_cuda_largescaleknn_torch.serve.frontend import (
        pod_config_from_hosts,
    )
    from mpi_cuda_largescaleknn_tpu.serve.frontend import (
        pod_config_from_hosts as jax_config,
    )

    points, built, _ref = pods
    got = pod_config_from_hosts(built["torch"][1])
    want = jax_config(built["jax"][1])
    assert got["routing"] == "bounds" and got["n_points"] == len(points)
    for key in ("k", "dim", "max_batch", "min_batch", "n_points",
                "bounds_hosts", "slab_fingerprints"):
        assert got[key] == want[key], key
    # asking a routed pod for the replicate fan-out: the same refusal
    errors = []
    for config in (pod_config_from_hosts, jax_config):
        with pytest.raises(ValueError, match="routing='off'") as e:
            config(built["torch"][1], routing="off")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="tile the index"):
        pod_config_from_hosts([built["torch"][1][1]], routing="bounds")


def test_host_and_frontend_surfaces(pods):
    """Per-shard AABBs, routed-row counters and the wire caps on the
    hosts; escalations, routed rows, hosts-per-query and wire bytes on
    the front end's /stats and /metrics."""
    _points, built, _ref = pods
    base, urls, _hosts, _fe = built["torch"]
    for url in urls:
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["routing"] == "bounds" and "wire" in st
        sb = st["engine"]["shard_bounds"]
        assert sum(s["count"] for s in sb) == st["engine"]["n_points"]
        m = urllib.request.urlopen(url + "/metrics", timeout=30).read()
        assert b"knn_routed_rows_total" in m and b"knn_host_routed 1" in m
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["role"] == "host-routed"
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    routing = stats["fanout"]["routing"]
    assert routing["mode"] == "bounds" and routing["escalations"] > 0
    assert set(routing["routed_rows"]) == set(urls)
    assert stats["fanout"]["wire"]["traffic"]["candidates"]
    m = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    assert "knn_routing_escalations_total" in m
    assert 'knn_hosts_per_query_bucket{le="+Inf"}' in m
    assert "knn_wire_bytes_total" in m
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_fold_radius_capped_rows_equal_jax():
    """The fold alone: radius-capped, under-full slab rows folded across
    two port slab engines equal one port engine and JAX's fold."""
    from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds
    from mpi_cuda_largescaleknn_torch.serve.frontend import fold_candidates
    from mpi_cuda_largescaleknn_tpu.serve.frontend import (
        fold_candidates as jax_fold,
    )
    from tests.oracle import random_points

    points = random_points(40, seed=11)
    kw = dict(bucket_size=32, max_batch=8, min_batch=8, max_radius=0.15)
    ref = _engine("torch", points, **kw)
    q = random_points(8, seed=12)
    want_d, want_n = ref.query(q)
    assert np.any(want_n == -1)
    rows = np.arange(len(q))
    outs = []
    for fold in (fold_candidates, jax_fold):
        cur_d2 = np.full((len(q), K), np.inf, np.float32)
        cur_idx = np.full((len(q), K), -1, np.int32)
        for b, e in slab_bounds(len(points), 2)[::-1]:
            eng = _engine("torch", points[b:e], id_offset=b,
                          emit="candidates", **kw)
            d2, idx = eng.complete_candidates(eng.dispatch(q))
            fold(cur_d2, cur_idx, rows, d2, idx, K)
        outs.append((np.sqrt(cur_d2[:, K - 1]), cur_idx))
    for d, n in outs:
        assert d.tobytes() == want_d.tobytes()
        assert np.array_equal(n, want_n)


def test_pieces_not_ported_name_their_item(pods, capsys):
    """The pieces of the replicate pod and slab handoff that were refused
    before they were ported behave as the JAX package's: a replicate host
    builds over any engine; a standby needs ``routing='bounds'``; a
    front end with ``standbys`` gets a replica manager holding them idle;
    ``--standbys`` / ``--handoff-floor`` parse; a ``PodFanout`` whose host
    is gone breaks its stream with ``PodBrokenError`` and drains the host;
    a routed host answers ``/adopt_slab`` 409 and ``/shard_knn`` 404."""
    from mpi_cuda_largescaleknn_torch.serve import frontend as tf
    from mpi_cuda_largescaleknn_tpu.serve import frontend as jf

    points, built, _ref = pods
    for mod, pkg in ((tf, "torch"), (jf, "jax")):
        eng = built[pkg][2][0].engine
        srv = mod.HostSliceServer(("127.0.0.1", 0), eng, routing="off")
        assert srv.routing == "off" and srv.next_seq_snapshot() == 0
        srv.close()
        with pytest.raises(ValueError, match="routed tier"):
            mod.HostSliceServer(("127.0.0.1", 0), None,
                                standby_config={"path": "x"})
    handoff = []
    for mod, pkg in ((tf, "torch"), (jf, "jax")):
        fe = mod.build_frontend(built[pkg][1], port=0,
                                standbys=["http://127.0.0.1:9"],
                                handoff_floor=2, start_monitor=False)
        try:
            handoff.append(fe.monitor.stats()["handoff"])
        finally:
            fe.close()
    assert handoff[0] == handoff[1]
    assert handoff[0]["standbys"][0]["state"] == "idle"
    assert handoff[0]["handoff_floor"] == 2
    for argv, said in (
            (["--standbys", "http://x:1", "--handoff-floor", "2"],
             "--hosts is required"),
            (["--standbys", "http://x:1", "--handoff-floor", "two"],
             "invalid literal")):
        lines = []
        for mod in (tf, jf):
            assert mod.main(argv) == 1
            lines.append(capsys.readouterr().err.splitlines()[0])
        assert lines[0] == lines[1] and said in lines[0]
    broken = []
    for mod in (tf, jf):
        fan = mod.PodFanout(["http://127.0.0.1:9"], k=K, max_batch=8)
        try:
            h = fan.dispatch(np.zeros((1, 3), np.float32))
            assert h["seq"] == 0
            with pytest.raises(mod.PodBrokenError, match="unreachable"):
                fan.complete(h)
            assert fan.endpoints[0].health.state == "drained"
            with pytest.raises(mod.PodBrokenError):
                fan.dispatch(np.zeros((1, 3), np.float32))
            broken.append(fan.stats()["next_seq"])
        finally:
            fan.close()
    assert broken == [1, 1]
    for path, code in (("/adopt_slab", 409), ("/shard_knn?seq=0", 404)):
        bodies = []
        for pkg in ("torch", "jax"):
            req = urllib.request.Request(
                built[pkg][1][0] + path, data=b'{"host_id": 0}',
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == code
            bodies.append(e.value.read())
        assert bodies[0] == bodies[1]


def test_streaming_routed_hosts_equal_one_engine(tmp_path):
    """``serve_main --routing bounds --num-slabs 2`` hosts (each streams
    its slab through the tiered pool) behind ``serve.frontend.main``:
    bodies byte-equal to one engine over all the points."""
    import queue

    from mpi_cuda_largescaleknn_torch.cli import serve_main
    from mpi_cuda_largescaleknn_torch.serve import frontend as tf
    from tests.oracle import random_points

    points = _routed_points()
    path = tmp_path / "pts.float3"
    points.tofile(path)
    ready = queue.Queue()
    servers = []
    try:
        for i in range(2):
            threading.Thread(target=serve_main.main, args=(
                [str(path), "-k", str(K), "--routing", "bounds",
                 "--num-hosts", "2", "--host-id", str(i), "--num-slabs",
                 "2", "--device-slab-budget", "1", "--max-batch", "32",
                 "--port", "0", "--device", "cpu"],),
                kwargs={"ready": ready.put}, daemon=True).start()
            servers.append(ready.get(timeout=300))
        urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        assert [s.engine.num_slabs for s in servers] == [2, 2]
        threading.Thread(target=tf.main, args=(
            ["--hosts", ",".join(urls), "--port", "0"],),
            kwargs={"ready": ready.put}, daemon=True).start()
        fe = ready.get(timeout=300)
        servers.append(fe)
        base = f"http://127.0.0.1:{fe.server_address[1]}"
        ref = _engine("torch", points, merge="device")
        for n, binary in ((1, False), (17, True), (32, False)):
            q = _ragged(n, points)
            status, body = _post(base, q, binary)
            want_d, want_n = ref.query(q)
            assert status == 200
            if binary:
                assert body == want_d.tobytes()
            else:
                obj = json.loads(body)
                assert obj["exact"] is True
                assert np.asarray(obj["dists"], np.float32).tobytes() \
                    == want_d.tobytes()
                assert np.array_equal(np.asarray(obj["neighbors"]), want_n)
        q = random_points(9, seed=6)
        assert _post(base, q, True)[1] == ref.query(q)[0].tobytes()
    finally:
        for s in servers:
            s.shutdown()
