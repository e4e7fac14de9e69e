"""The fault drills of ``tests/test_failover.py`` on the port's routed pod
and on the JAX package's, side by side: two slab hosts over disjoint
clusters (A on host 0, B on host 1), host 1 made to answer 503, to drop
its connections or to stall past the per-try budget, under
``--on-host-loss fail`` and ``degrade``. The statuses, ``exact`` flags and
bodies are equal between the pods, unaffected queries stay byte-equal to
one engine, and after the fault clears the monitor's rejoin restores
bodies equal to the healthy pod's. Also: transient 5xx retried on the
same deterministic backoff as JAX, ``POST /faults`` round trips, and
``refetch_exact`` byte-equal to the original batch's rows."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_failover import _failover_points
from tests.test_torch_routing import _engine, _frontend_module, _serve


def _post(base, q, binary=False):
    """(status, body, Retry-After) of one POST /knn."""
    q = np.ascontiguousarray(q, np.float32)
    if binary:
        data, ctype = q.tobytes(), "application/octet-stream"
    else:
        data = json.dumps({"queries": q.tolist(), "neighbors": True}).encode()
        ctype = "application/json"
    req = urllib.request.Request(base + "/knn", data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read(), None
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Retry-After")


@pytest.fixture(scope="module")
def hosts():
    """Two slab hosts of each package over the disjoint clusters."""
    from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds

    points = _failover_points()
    out = {}
    for pkg in ("torch", "jax"):
        servers, urls = [], []
        for b, e in slab_bounds(len(points), 2):
            eng = _engine(pkg, points[b:e], id_offset=b, emit="candidates")
            eng.warmup()
            srv = _frontend_module(pkg).HostSliceServer(
                ("127.0.0.1", 0), eng, routing="bounds")
            urls.append(_serve(srv))
            servers.append(srv)
        out[pkg] = (urls, servers)
    ref = _engine("torch", points, merge="device")
    ref.warmup()
    yield points, out, ref
    for _urls, servers in out.values():
        for s in servers:
            s.close()


@pytest.fixture()
def clean(hosts):
    for _urls, servers in hosts[1].values():
        for s in servers:
            s.faults.clear()
    yield
    for _urls, servers in hosts[1].values():
        for s in servers:
            s.faults.clear()


def _fe(pkg, urls, **kw):
    kw.setdefault("on_host_loss", "degrade")
    kw.setdefault("retries", 1)
    kw.setdefault("retry_backoff_s", 0.001)
    kw.setdefault("fail_threshold", 2)
    kw.setdefault("start_monitor", False)
    # the drills re-post the same rows: the query cache would answer the
    # repeats without reaching the faulted host
    kw.setdefault("qcache_rows", 0)
    srv = _frontend_module(pkg).build_frontend(urls, port=0,
                                               pipeline_depth=2, **kw)
    return srv, _serve(srv)


FAULTS = {"error_503": "error:path=/route_knn,code=503",
          "drop": "drop:path=/route_knn",
          "latency": "latency:path=/route_knn,delay_s=0.6"}


def _drill(pkg, hosts, fault, policy):
    """Host 1 faulted: B queries, A queries, a mixed probe; then the fault
    clears and the monitor rejoins host 1; the probe again. Returns every
    response and the host 1 states seen."""
    from tests.oracle import random_points

    _points, built, _ref = hosts
    urls, servers = built[pkg]
    kw = dict(on_host_loss=policy)
    if fault == "latency":
        kw["request_timeout_s"] = 0.25
    fe, base = _fe(pkg, urls, **kw)
    try:
        probe = random_points(24, seed=73)  # A, B and the gap
        out = {"healthy": _post(base, probe)}
        servers[1].faults.set_specs(FAULTS[fault])
        qb = random_points(8, seed=71, scale=0.4) + np.float32(0.6)
        qa = random_points(8, seed=72, scale=0.4)
        out["b"] = _post(base, qb)
        out["b_binary"] = _post(base, qb, binary=True)
        out["a"] = _post(base, qa)
        out["a_binary"] = _post(base, qa, binary=True)
        out["probe_faulted"] = _post(base, probe)
        states = [fe.fanout.endpoints[1].health.state]
        servers[1].faults.clear()
        fe.monitor.check_once(now=1e9)  # every probe due
        states.append(fe.fanout.endpoints[1].health.state)
        out["probe_rejoined"] = _post(base, probe)
        out["rejoins"] = fe.monitor.rejoins
        return out, states, (qa, probe)
    finally:
        fe.close()


@pytest.mark.parametrize("policy", ["fail", "degrade"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_drill_equal_jax(hosts, clean, fault, policy):
    got, states, (qa, probe) = _drill("torch", hosts, fault, policy)
    want, jstates, _ = _drill("jax", hosts, fault, policy)
    assert states == jstates == ["drained", "healthy"]
    assert got == want
    ref = hosts[2]
    # B rows touch the drained slab
    status, body, retry = got["b"]
    if policy == "fail":
        assert status == 503 and retry is not None
        assert json.loads(body)["exact"] is False
        assert got["b_binary"][0] == 503
    else:
        obj = json.loads(body)
        assert status == 200 and obj["exact"] is False
        assert obj["exact_per_query"] == [False] * 8
    # A rows never route to host 1: byte-equal to one engine
    want_d, want_n = ref.query(qa)
    obj = json.loads(got["a"][1])
    assert got["a"][0] == 200 and obj["exact"] is True
    assert np.asarray(obj["dists"], np.float32).tobytes() == want_d.tobytes()
    assert np.array_equal(np.asarray(obj["neighbors"]), want_n)
    assert got["a_binary"][1] == want_d.tobytes()
    # the rejoin restores the healthy pod's bytes
    assert got["rejoins"] == 1
    assert got["probe_rejoined"] == got["healthy"]
    assert json.loads(got["healthy"][1])["exact"] is True


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_transient_5xx_retried_on_the_same_backoff(hosts, clean, pkg):
    from tests.oracle import random_points

    _points, built, ref = hosts
    urls, servers = built[pkg]
    fe, base = _fe(pkg, urls, retries=3)
    try:
        slept = []
        fe.fanout._sleep = slept.append
        servers[0].faults.set_specs("error:path=/route_knn,n=2")
        q = random_points(8, seed=70, scale=0.4)
        status, body, _ = _post(base, q)
        assert status == 200 and json.loads(body)["exact"] is True
        assert np.asarray(json.loads(body)["dists"], np.float32).tobytes() \
            == ref.query(q)[0].tobytes()
        ep = fe.fanout.endpoints[0]
        assert ep.retries == 2 and ep.health.state == "healthy"
        # the same schedule in both packages: Backoff(0.001, 2.0, 0.1, 0)
        from mpi_cuda_largescaleknn_tpu.serve.health import Backoff

        jb = Backoff(base_s=0.001, cap_s=2.0, jitter=0.1, seed=0)
        assert slept == [jb.delay(i, key=ep.url) for i in (1, 2)]
        m = urllib.request.urlopen(base + "/metrics", timeout=30).read()
        assert f'knn_dispatch_retries_total{{host="{ep.url}"}} 2'.encode() \
            in m
    finally:
        fe.close()


def test_nonretryable_4xx_is_not_retried(hosts, clean):
    from mpi_cuda_largescaleknn_torch.serve.frontend import HostCallError

    _points, built, _ref = hosts
    urls, servers = built["torch"]
    fe, _base = _fe("torch", urls, retries=3)
    try:
        fe.fanout._sleep = lambda s: None
        servers[0].faults.set_specs("error:path=/route_knn,code=404,n=8")
        ep = fe.fanout.endpoints[0]
        with pytest.raises(HostCallError) as ei:
            fe.fanout._post_route(ep, b"\x00" * 12, 1)
        assert not ei.value.transient and ep.retries == 0
    finally:
        fe.close()


def test_runtime_fault_endpoint_equal_jax(hosts, clean):
    """``POST /faults`` replaces a live host's rules and ``GET /faults``
    reads them back, the same bodies from both packages' hosts."""
    _points, built, _ref = hosts
    bodies = []
    for pkg in ("torch", "jax"):
        url = built[pkg][0][1]
        out = []
        for spec in ("error:path=/route_knn,code=500,n=3", ""):
            req = urllib.request.Request(
                url + "/faults", data=json.dumps({"spec": spec}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                out.append(json.loads(r.read()))
            with urllib.request.urlopen(url + "/faults", timeout=30) as r:
                out.append(json.loads(r.read()))
        bodies.append(out)
    assert bodies[0] == bodies[1]
    assert bodies[0][0]["specs"][0]["code"] == 500
    assert bodies[0][2]["specs"] == []


def test_refetch_exact_equals_the_batch_rows(hosts):
    """A re-fetch of a subset of a batch's rows gives those rows' bytes:
    the engine hook and the host's ``?wire=x32`` answer alike."""
    from tests.oracle import random_points

    points, built, _ref = hosts
    srv = built["torch"][1][1]
    eng = srv.engine
    q = random_points(30, seed=80, scale=0.4) + np.float32(0.6)
    q[:3] = points[300:303]
    d2, idx = eng.complete_candidates(eng.dispatch(q))
    sub = np.array([0, 2, 5, 17, 29])
    rd2, ridx = eng.refetch_exact(q[sub])
    assert rd2.tobytes() == d2[sub].tobytes()
    assert ridx.tobytes() == idx[sub].tobytes()
    url = built["torch"][0][1]
    req = urllib.request.Request(
        url + "/route_knn?wire=x32",
        data=np.ascontiguousarray(q[sub], "<f4").tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers.get("X-Knn-Wire") == "x32"
        assert r.read() == d2[sub].tobytes()
