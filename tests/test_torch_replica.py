"""Slab handoff on the port (``serve/replica.py`` ``ReplicaManager``, the
standby half of ``serve/frontend.py`` ``HostSliceServer`` and ``POST
/adopt_slab``) against the JAX package's.

Unit layer: the manager of each package driven with the same fake
transports and explicit ``check_once`` calls (no HTTP, no sleeps), case
for case with ``tests/test_replica.py``'s ``TestReplicaManagerUnit``: the
two managers' requests and ``stats()`` are equal at every step.

Integration layer: a 2-slab x 2-replica routed pod of port hosts with
``device="cpu"`` engines over ``tests/test_replica.py``'s two disjoint
clusters (replicas of a slab share one engine in process, so the ADOPTED
engine is the parity subject). A warm standby adopts a lost slab by both
paths, pulled from a surviving replica and read again from the file; with
the original hosts of that slab down, the front end's bodies are byte-equal
to one port engine over all the points and to the JAX engine of the same
config. A standby built with another config is rejected and never serves;
``POST /adopt_slab`` answers 202 / 400 / 409 as JAX's does; a failed
adoption surfaces on /healthz and may be retried."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_replica import K, _replica_points
from tests.test_torch_routing import _frontend_module, _serve

KW = dict(bucket_size=64, max_batch=32, min_batch=16)


def _replica_module(pkg):
    if pkg == "torch":
        from mpi_cuda_largescaleknn_torch.serve import replica
    else:
        from mpi_cuda_largescaleknn_tpu.serve import replica
    return replica


def _health_module(pkg):
    if pkg == "torch":
        from mpi_cuda_largescaleknn_torch.serve import health
    else:
        from mpi_cuda_largescaleknn_tpu.serve import health
    return health


# ---------------------------------------------------------------- unit layer


def _fake_routed_fanout(pkg, urls, groups):
    """A real ``RoutedPodFanout`` of ``pkg`` (no HTTP at construction)
    over fake bounds."""
    fe = _frontend_module(pkg)
    bounds = fe.PodBoundsTable([
        {"row_offset": g["row_offset"], "n_points": g["n_points"],
         "shards": [{"lo": [0, 0, 0], "hi": [1, 1, 1],
                     "count": g["n_points"]}]} for g in groups], dim=3)
    return fe.RoutedPodFanout(
        urls, k=K, max_batch=32, bounds=bounds, replica_groups=groups,
        health_config={"fail_threshold": 1, "jitter": 0.0})


def _harness(pkg, *, stats_engine, probes, adopts):
    groups = [{"row_offset": 0, "n_points": 300, "urls": ["http://a"]},
              {"row_offset": 300, "n_points": 300, "urls": ["http://b"]}]
    fan = _fake_routed_fanout(pkg, ["http://a", "http://b"], groups)
    want = _health_module(pkg).host_fingerprint(
        {"row_offset": 300, "n_points": 300, "k": K}, "bounds")
    registry = {}
    mgr = _replica_module(pkg).ReplicaManager(
        fan, slabs=groups, slab_fingerprints=[None, want],
        standbys=["http://sb"], handoff_floor=1,
        probe_fn=lambda url: probes[url].pop(0),
        stats_fn=lambda url: {"engine": stats_engine},
        adopt_fn=lambda url, req: adopts.append((url, req)) or {},
        fingerprint_registry=registry, clock=lambda: 0.0)
    return fan, mgr, want, registry


def _both(run):
    """``run(pkg)`` for each package: the port's result, then JAX's."""
    return [run(pkg) for pkg in ("torch", "jax")]


def test_handoff_triggers_validates_and_binds():
    def run(pkg):
        adopts, steps = [], []
        probes = {"http://sb": [(False, {"status": "adopting"}),
                                (True, {"status": "ok"}),
                                (True, {"status": "ok"})]}
        fan, mgr, want, registry = _harness(
            pkg, stats_engine={"row_offset": 300, "n_points": 300, "k": K},
            probes=probes, adopts=adopts)
        try:
            fan.endpoints[1].health.force_drain("died")
            assert fan.replicas.live_counts() == [1, 0]
            for now in (0.0, 1.0, 2.0, 3.0):
                mgr.check_once(now=now)
                steps.append(mgr.stats())
            st = steps[2]
            assert st["handoffs"] == 1 and st["inflight_slabs"] == []
            assert st["standbys"][0]["state"] == "bound"
            assert steps[1]["standbys"][0]["state"] == "adopting"
            assert len(fan.endpoints) == 3
            assert fan.replicas.live_counts() == [1, 1]
            assert registry["http://sb"] == want
            # no repeat adoption while the floor is met
            assert steps[3]["handoffs"] == 1 and len(adopts) == 1
            return adopts, steps, fan.replicas.stats()
        finally:
            fan.close()

    got, want = _both(run)
    assert got == want
    (url, req), = got[0]
    assert url == "http://sb" and "source_url" not in req
    assert req == {"host_id": 1, "num_hosts": 2, "row_offset": 300,
                   "n_points": 300}


def test_handoff_sends_a_live_source_url():
    """A slab with a live member is pulled from it (``source_url``)."""
    def run(pkg):
        adopts = []
        fan, mgr, _want, _registry = _harness(
            pkg, stats_engine={}, probes={}, adopts=adopts)
        try:
            mgr.handoff_floor = 2  # one live replica is below the floor
            mgr.check_once(now=0.0)
            return adopts, mgr.stats()
        finally:
            fan.close()

    got, want = _both(run)
    assert got == want
    assert [r["source_url"] for _u, r in got[0]] == ["http://a"]


def test_fingerprint_mismatch_never_binds():
    def run(pkg):
        probes = {"http://sb": [(True, {"status": "ok"})]}
        # the standby came back serving the WRONG slab (row_offset 0)
        fan, mgr, _want, registry = _harness(
            pkg, stats_engine={"row_offset": 0, "n_points": 300, "k": K},
            probes=probes, adopts=[])
        try:
            fan.endpoints[1].health.force_drain("died")
            mgr.check_once(now=0.0)
            mgr.check_once(now=1.0)
            st = mgr.stats()
            assert st["handoff_rejections"] == 1 and st["handoffs"] == 0
            sb = st["standbys"][0]
            assert sb["state"] == "failed"
            assert "fingerprint mismatch" in sb["last_error"]
            assert "row_offset" in sb["last_error"]
            assert len(fan.endpoints) == 2
            assert fan.replicas.live_counts() == [1, 0]
            assert "http://sb" not in registry
            return st
        finally:
            fan.close()

    got, want = _both(run)
    assert got == want


def test_adopt_failure_and_starvation_are_counted():
    def run(pkg):
        def boom(url, req):
            raise OSError("connection refused")

        groups = [{"row_offset": 0, "n_points": 300, "urls": ["http://a"]}]
        fan = _fake_routed_fanout(pkg, ["http://a"], groups)
        try:
            mgr = _replica_module(pkg).ReplicaManager(
                fan, slabs=groups, slab_fingerprints=[None],
                standbys=["http://sb"], handoff_floor=1,
                probe_fn=lambda url: (False, {}),
                stats_fn=lambda url: {}, adopt_fn=boom, clock=lambda: 0.0)
            fan.endpoints[0].health.force_drain("died")
            mgr.check_once(now=0.0)
            st = mgr.stats()
            assert st["handoff_failures"] == 1
            assert st["standbys"][0]["state"] == "failed"
            assert "adopt request failed" in st["standbys"][0]["last_error"]
            mgr.check_once(now=1.0)  # no idle standby left
            assert mgr.stats()["starved"] == 1
            return st, mgr.stats()
        finally:
            fan.close()

    got, want = _both(run)
    assert got == want


def test_adoption_timeout_and_failed_standby_are_counted():
    """A standby that reports ``adopt-failed``, and one that never gets
    ready within ``adopt_timeout_s``, both park in ``failed``."""
    def run(pkg):
        out = []
        for probe, now in (((False, {"status": "adopt-failed",
                                     "adopt_error": "OSError: gone"}), 1.0),
                           ((False, {"status": "adopting"}), 700.0)):
            fan, mgr, _w, _r = _harness(pkg, stats_engine={},
                                        probes={"http://sb": [probe]},
                                        adopts=[])
            try:
                fan.endpoints[1].health.force_drain("died")
                mgr.check_once(now=0.0)
                mgr.check_once(now=now)
                out.append(mgr.stats())
            finally:
                fan.close()
        return out

    got, want = _both(run)
    assert got == want
    assert got[0]["standbys"][0]["last_error"] == "OSError: gone"
    assert "timed out" in got[1]["standbys"][0]["last_error"]
    assert [s["handoff_failures"] for s in got] == [1, 1]


# --------------------------------------------------------- integration layer


def _torch_engine(points, **kw):
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine

    return ResidentKnnEngine(points, K, device="cpu", **dict(KW, **kw))


@pytest.fixture(scope="module")
def replica_pod(tmp_path_factory):
    """2 slabs x 2 replicas of port hosts over the disjoint clusters, the
    source file, one port engine and one JAX engine over all the rows."""
    from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds
    from mpi_cuda_largescaleknn_torch.serve.frontend import HostSliceServer
    from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
    from mpi_cuda_largescaleknn_tpu.serve.engine import (
        ResidentKnnEngine as JaxEngine,
    )

    points = _replica_points()
    pts_path = str(tmp_path_factory.mktemp("replica") / "points.float3")
    points.tofile(pts_path)
    servers = []
    for b, e in slab_bounds(len(points), 2):
        eng = _torch_engine(points[b:e], id_offset=b, emit="candidates")
        eng.warmup()
        for _ in range(2):  # slab-major: A0, A1, B0, B1
            srv = HostSliceServer(("127.0.0.1", 0), eng, routing="bounds")
            _serve(srv)
            servers.append(srv)
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    ref = _torch_engine(points)
    ref.warmup()
    jax_ref = JaxEngine(points, K, mesh=get_mesh(1), engine="tiled", **KW)
    jax_ref.warmup()
    yield urls, servers, pts_path, ref, jax_ref
    for s in servers:
        s.close()


@pytest.fixture()
def clean(replica_pod):
    servers = replica_pod[1]
    for s in servers:
        s.faults.clear()
    yield
    for s in servers:
        s.faults.clear()


def _build_fe(urls, **kw):
    from mpi_cuda_largescaleknn_torch.serve.frontend import build_frontend

    kw.setdefault("on_host_loss", "degrade")
    kw.setdefault("retries", 1)
    kw.setdefault("retry_backoff_s", 0.001)
    kw.setdefault("fail_threshold", 2)
    kw.setdefault("start_monitor", False)
    srv = build_frontend(urls, port=0, pipeline_depth=2, **kw)
    return srv, _serve(srv)


def _standby(pts_path, pkg="torch", **overrides):
    cfg = dict(path=pts_path, num_hosts=2, k=K, shards=1, **KW)
    if pkg == "torch":
        cfg["device"] = "cpu"
    else:
        cfg["engine"] = "tiled"
    cfg.update(overrides)
    srv = _frontend_module(pkg).HostSliceServer(
        ("127.0.0.1", 0), None, routing="bounds", standby_config=cfg)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _wait_adopt(standby, want="adopted", timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        snap = standby.adopt_snapshot()
        if snap["state"] == want:
            return snap
        if want == "adopted" and snap["state"] == "failed":
            raise AssertionError(f"adoption failed: {snap['error']}")
        time.sleep(0.02)
    raise AssertionError(f"adoption never reached {want!r}: "
                         f"{standby.adopt_snapshot()}")


def _post(base, q, binary=False):
    q = np.ascontiguousarray(q, np.float32)
    if binary:
        data, ctype = q.tobytes(), "application/octet-stream"
    else:
        data = json.dumps({"queries": q.tolist(), "neighbors": True}).encode()
        ctype = "application/json"
    req = urllib.request.Request(base + "/knn", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read(), resp.headers.get("X-Knn-Exact")


def _post_json(url, path, obj):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _assert_one_engine(base, refs):
    """JSON and binary bodies of a probe spanning both clusters and the
    gap: exact, and byte-equal to each reference engine's answer."""
    from tests.oracle import random_points

    for n, seed in ((24, 85), (7, 86), (1, 87)):
        q = random_points(n, seed=seed)
        body, _ = _post(base, q)
        resp = json.loads(body)
        assert resp["exact"] is True
        got_d = np.asarray(resp["dists"], np.float32)
        got_n = np.asarray(resp["neighbors"], np.int32)
        bin_body, exact = _post(base, q, binary=True)
        assert exact == "1"
        for ref in refs:
            want_d, want_n = ref.query(q)
            assert got_d.tobytes() == want_d.tobytes()
            assert np.array_equal(got_n, want_n)
            assert bin_body == want_d.astype("<f4").tobytes()


def test_handoff_by_pull_serves_the_slab_alone(replica_pod, clean):
    """Slab A loses a replica below ``handoff_floor=2``: the standby pulls
    the rows from the survivor, warms, passes the fingerprint gate and
    is bound; with BOTH originals of slab A then down, the front end is
    byte-equal to one port engine and to the JAX engine."""
    urls, servers, pts_path, ref, jax_ref = replica_pod
    standby, sb_url = _standby(pts_path)
    fe, base = _build_fe(urls, standbys=[sb_url], handoff_floor=2)
    try:
        _assert_one_engine(base, (ref, jax_ref))
        servers[1].faults.set_specs("drop:")
        fe.monitor.check_once(now=1e9)
        fe.monitor.check_once(now=2e9)
        assert fe.fanout.endpoints[1].health.state == "drained"
        ho = fe.monitor.stats()["handoff"]
        assert ho["inflight_slabs"] == [0]
        # queries during the handoff keep serving off the survivor
        _assert_one_engine(base, (ref,))
        snap = _wait_adopt(standby)
        assert snap["slab"] == 0 and snap["seconds"] is not None
        fe.monitor.check_once(now=3e9)
        ho = fe.monitor.stats()["handoff"]
        assert ho["handoffs"] == 1 and ho["handoff_rejections"] == 0
        st = fe.fanout.stats()["routing"]["replicas"]
        assert st["per_slab"][0]["live"] == 2
        assert sb_url in st["per_slab"][0]["members"]
        servers[0].faults.set_specs("drop:")
        fe.monitor.check_once(now=4e9)
        fe.monitor.check_once(now=5e9)
        assert fe.fanout.endpoints[0].health.state == "drained"
        _assert_one_engine(base, (ref, jax_ref))
        m = urllib.request.urlopen(base + "/metrics",
                                   timeout=30).read().decode()
        assert "knn_handoffs_total 1" in m
        assert "knn_replica_rebinds_total 1" in m
        # the pulled rows are the file's rows
        assert np.array_equal(standby.engine.host_points,
                              _replica_points()[:300])
    finally:
        fe.close()
        standby.close()


def test_handoff_from_the_file_when_the_slab_is_down(replica_pod, clean):
    """Both replicas of slab B down (``handoff_floor=1``): no member is
    live, so the standby reads slab B again from the file; bound, it
    makes the pod exact again with the originals still down."""
    urls, servers, pts_path, ref, jax_ref = replica_pod
    standby, sb_url = _standby(pts_path)
    fe, base = _build_fe(urls, standbys=[sb_url], handoff_floor=1)
    try:
        servers[2].faults.set_specs("drop:")
        servers[3].faults.set_specs("drop:")
        for now in (1e9, 2e9):
            fe.monitor.check_once(now=now)
        assert fe.fanout.stats()["routing"]["replicas"]["per_slab"][1][
            "live"] == 0
        snap = _wait_adopt(standby)
        assert snap["slab"] == 1
        fe.monitor.check_once(now=3e9)
        ho = fe.monitor.stats()["handoff"]
        assert ho["handoffs"] == 1 and ho["standbys"][0]["state"] == "bound"
        assert standby.engine.id_offset == 300
        _assert_one_engine(base, (ref, jax_ref))
    finally:
        fe.close()
        standby.close()


def test_mismatched_standby_is_rejected_and_never_serves(replica_pod,
                                                         clean):
    urls, servers, pts_path, _ref, _jax_ref = replica_pod
    standby, sb_url = _standby(pts_path, bucket_size=32)
    fe, _base = _build_fe(urls, standbys=[sb_url], handoff_floor=2)
    try:
        servers[1].faults.set_specs("drop:")
        fe.monitor.check_once(now=1e9)
        fe.monitor.check_once(now=2e9)
        _wait_adopt(standby)  # the adoption itself succeeds...
        fe.monitor.check_once(now=3e9)
        ho = fe.monitor.stats()["handoff"]
        # ...but the fingerprint gate refuses to bind it
        assert ho["handoffs"] == 0 and ho["handoff_rejections"] == 1
        sb = ho["standbys"][0]
        assert sb["state"] == "failed"
        assert "fingerprint mismatch" in sb["last_error"]
        assert "bucket_size" in sb["last_error"]
        st = fe.fanout.stats()["routing"]["replicas"]
        assert st["per_slab"][0]["live"] == 1
        assert sb_url not in st["per_slab"][0]["members"]
        assert all(ep.url != sb_url for ep in fe.fanout.endpoints)
    finally:
        fe.close()
        standby.close()


def _status(url, path, obj=None):
    """(status, json body) of a GET (``obj`` None) or a JSON POST."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_adopt_slab_http_surface(replica_pod, clean):
    """Statuses and bodies equal to a JAX standby's while empty (503
    /healthz, 400 on a bad request, 409 on a routed host), then 202, 409
    while adopting, and the adopted host's /healthz."""
    urls, _servers, pts_path, _ref, _jax_ref = replica_pod
    standbys = {pkg: _standby(pts_path, pkg) for pkg in ("torch", "jax")}
    try:
        for path, obj in (("/healthz", None),
                          ("/adopt_slab", {"host_id": 9}),
                          ("/adopt_slab", {"num_hosts": 2}),
                          ("/route_knn", None)):
            got, want = (_status(standbys[p][1], path, obj)
                         for p in ("torch", "jax"))
            assert got == want, path
            assert got[0] in (400, 503)
        assert _status(urls[0], "/adopt_slab", {"host_id": 0})[0] == 409
        standby, sb_url = standbys["torch"]
        assert standby.adopt_snapshot()["state"] == "standby"
        status, resp = _post_json(sb_url, "/adopt_slab",
                                  {"host_id": 0, "num_hosts": 2,
                                   "row_offset": 0, "n_points": 300})
        assert status == 202 and resp["status"] == "adopting"
        assert _status(sb_url, "/adopt_slab", {"host_id": 1})[0] == 409
        _wait_adopt(standby)
        assert standby.engine.n_points == 300
        assert standby.engine.id_offset == 0
        status, hz = _status(sb_url, "/healthz")
        assert status == 200 and hz["status"] == "ok"
        assert hz["role"] == "host-routed"
        assert hz["adopt"]["state"] == "adopted"
    finally:
        for srv, _url in standbys.values():
            srv.close()


def test_adoption_failure_is_surfaced_and_retryable(tmp_path):
    """A missing file, then a slab the pod table disagrees with: each
    parks the standby in ``failed`` with the reason on /healthz, and a
    later request reopens the lifecycle (202)."""
    standby, sb_url = _standby(str(tmp_path / "missing.float3"))
    try:
        status, _ = _post_json(sb_url, "/adopt_slab",
                               {"host_id": 0, "num_hosts": 2})
        assert status == 202
        _wait_adopt(standby, want="failed")
        status, body = _status(sb_url, "/healthz")
        assert status == 503 and body["status"] == "adopt-failed"
        assert "adopt_error" in body
        path = tmp_path / "pts.float3"
        _replica_points().tofile(path)
        standby.standby_config["path"] = str(path)
        status, _ = _post_json(sb_url, "/adopt_slab",
                               {"host_id": 0, "num_hosts": 2,
                                "row_offset": 5})
        assert status == 202
        snap = _wait_adopt(standby, want="failed")
        assert "the pod table expects 5" in snap["error"]
        assert standby.engine is None
        status, _ = _post_json(sb_url, "/adopt_slab",
                               {"host_id": 0, "num_hosts": 2})
        assert status == 202
        _wait_adopt(standby)
    finally:
        standby.close()
