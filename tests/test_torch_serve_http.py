"""The port's HTTP server (``serve/server.py``) against the JAX package's:
one server of each on the same points with the engine ``tiled``, the same
requests posted to both in the same order, the response bodies byte-equal
(JSON with neighbors, binary, zero rows, recall targets, the query
cache's exact hits and radius seeds, bad bodies, an over-wide batch, an
over-cap queue), and ``/stats`` and ``/metrics`` with the same keys and
metric names."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.serve import server as t_server
from mpi_cuda_largescaleknn_torch.serve.engine import (
    ResidentKnnEngine as PortEngine,
)
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from mpi_cuda_largescaleknn_tpu.serve import server as j_server
from mpi_cuda_largescaleknn_tpu.serve.engine import (
    ResidentKnnEngine as JaxEngine,
)
from tests.oracle import assert_dist_equal, kth_nn_dist, random_points

K = 8
ENGINE = dict(engine="tiled", bucket_size=32, max_batch=128, min_batch=16)


@pytest.fixture(scope="module")
def points():
    return random_points(1500, seed=7)


@pytest.fixture(scope="module")
def engines(points):
    j = JaxEngine(points, K, mesh=get_mesh(4), **ENGINE)
    p = PortEngine(points, K, num_shards=4, device="cpu", **ENGINE)
    j.warmup()
    p.warmup()
    return j, p


def _start(mod, engine, **kw):
    srv = mod.build_server(engine, port=0, max_delay_s=0.002, **kw)
    srv.ready = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def servers(engines):
    j, p = engines
    pair = (_start(j_server, j), _start(t_server, p))
    yield pair
    for srv in pair:
        srv.close()


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _request(srv, path, body=None, ctype="application/json"):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(
        _url(srv) + path, data=body,
        headers={} if body is None else {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _both(servers, path, body=None, ctype="application/json"):
    jr, pr = (_request(s, path, body, ctype) for s in servers)
    assert pr == jr, (path, jr[:2], pr[:2], jr[2][:200], pr[2][:200])
    return pr


def _json(q, **kw):
    return json.dumps(dict(queries=np.asarray(q).tolist(), **kw)).encode()


def _binary(q):
    return np.ascontiguousarray(q, "<f4").tobytes()


BIN = "application/octet-stream"


def test_knn_json_and_binary_are_byte_equal(servers, points):
    q = random_points(21, seed=5)
    code, _, body = _both(servers, "/knn", _json(q, neighbors=True))
    assert code == 200
    resp = json.loads(body)
    assert_dist_equal(np.asarray(resp["dists"], np.float32),
                      kth_nn_dist(q, points, K))
    assert np.asarray(resp["neighbors"]).shape == (21, K)
    _both(servers, "/knn", _json(random_points(100, seed=6)))
    _both(servers, "/knn", _json(q[:3], neighbors=True, timeout_ms=4000))
    code, ctype, body = _both(servers, "/knn", _binary(q), BIN)
    assert code == 200 and ctype == BIN
    assert_dist_equal(np.frombuffer(body, "<f4"), kth_nn_dist(q, points, K))
    _both(servers, "/knn?neighbors=1&timeout_ms=3000",
          _binary(random_points(128, seed=8)), BIN)


def test_zero_rows(servers):
    assert _both(servers, "/knn", _json(np.zeros((0, 3))))[0] == 200
    code, ctype, body = _both(servers, "/knn", b"", BIN)
    assert (code, ctype, body) == (200, BIN, b"")


def test_recall_targets(servers):
    q = random_points(40, seed=12)
    for recall in (0.9, 0.99, 1.0):
        code, _, body = _both(servers, "/knn", _json(q, recall=recall,
                                                     neighbors=True))
        assert code == 200 and json.loads(body)["recall_target"] == recall
    _both(servers, "/knn?recall=0.95", _binary(q), BIN)


def test_query_cache_hits_and_seeds(servers):
    """Repeated rows (exact hits) and near-duplicates (certified seeds),
    alone and mixed with new rows."""
    rng = np.random.default_rng(3)
    q = random_points(30, seed=31)
    for body in (_json(q, neighbors=True), _json(q, neighbors=True),
                 _json(q + rng.normal(0, 1e-4, q.shape).astype(np.float32),
                       neighbors=True),
                 _json(np.concatenate([q[:10], random_points(10, seed=32)]),
                       neighbors=True)):
        assert _both(servers, "/knn", body)[0] == 200
    _both(servers, "/knn", _binary(q[5:20]), BIN)
    stats = [json.loads(_request(s, "/stats")[2])["qcache"]
             for s in servers]
    assert stats[0] == stats[1]
    assert stats[1]["hits"] > 0 and stats[1]["seeds"] > 0


@pytest.mark.parametrize("body,ctype", [
    (b'{"queries": [[1.0, 2.0]]}', "application/json"),
    (b'{"queries": [[1.0, 2.0, NaN]]}', "application/json"),
    (b'{"queries": [[1.0, 2.0, 3.0]], "recall": 1.5}', "application/json"),
    (b'{"queries": ', "application/json"),
    (b"\x00" * 10, BIN),
])
def test_bad_bodies_are_400(servers, body, ctype):
    assert _both(servers, "/knn", body, ctype)[0] == 400


def test_over_wide_batch_is_413_and_unknown_paths_404(servers):
    assert _both(servers, "/knn", _json(np.zeros((200, 3))))[0] == 413
    assert _both(servers, "/nope")[0] == 404
    assert _both(servers, "/v1/a/knn", _json(np.zeros((1, 3))))[0] == 404


def test_over_cap_queue_is_429(engines):
    pair = [_start(mod, eng, max_queue_rows=4)
            for mod, eng in zip((j_server, t_server), engines)]
    try:
        code, _, body = _both(pair, "/knn", _json(random_points(8, seed=1)))
        assert code == 429 and b"queue full" in body
        assert _both(pair, "/knn", _json(random_points(4, seed=2)))[0] == 200
    finally:
        for srv in pair:
            srv.close()


def _keys(obj, prefix=""):
    """Every key path of a JSON object (the timers' per-phase entries and
    the compiled shape lists included)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    return out


def test_stats_and_metrics_have_the_same_keys(servers):
    _both(servers, "/knn", _json(random_points(17, seed=77)))
    code, _, body = _both(servers, "/healthz")
    assert code == 200 and json.loads(body)["engine"] == "tiled"
    stats = [json.loads(_request(s, "/stats")[2]) for s in servers]
    assert _keys(stats[0]) == _keys(stats[1])
    # the shape buckets and the recall plans' own launch plans
    assert stats[1]["engine"]["compile_count"] == \
        stats[0]["engine"]["compile_count"] > 4
    metrics = []
    for s in servers:
        text = _request(s, "/metrics")[2].decode()
        metrics.append({line.split()[2] for line in text.splitlines()
                        if line.startswith("# TYPE")})
    assert metrics[0] == metrics[1]
    assert "knn_tiles_executed_total" in metrics[1]


def test_close_without_serve_forever_does_not_hang(engines):
    srv = t_server.build_server(engines[1], port=0)
    t = threading.Thread(target=srv.close, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "close() hung without serve_forever()"


def test_tenant_fields_are_ignored_on_a_single_index(servers):
    """A ``"tenant"`` JSON field and an ``X-Knn-Tenant`` header change
    nothing on a single-index server; a tenant path is a 404."""
    q = random_points(9, seed=41)
    plain = _both(servers, "/knn", _json(q, neighbors=True))
    assert _both(servers, "/knn", _json(q, neighbors=True,
                                        tenant="a")) == plain
    outs = []
    for s in servers:
        req = urllib.request.Request(
            _url(s) + "/knn", data=_binary(q),
            headers={"Content-Type": BIN, "X-Knn-Tenant": "a"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            outs.append((resp.status, resp.read()))
    assert outs[0] == outs[1] and outs[1][0] == 200
    assert _both(servers, "/v1/a/stats")[0] == 404


def _outcome(srv, body):
    """What a client sees of one POST /knn: (status, body) or the name of
    the exception the connection raised."""
    req = urllib.request.Request(_url(srv) + "/knn", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except Exception as e:  # noqa: BLE001 - the failure is the outcome
        return type(e).__name__


@pytest.mark.parametrize("spec", [
    "error:code=503,after=1,n=1",
    "error:p=0.5,seed=7",
    "latency:delay_s=0.01,n=2",
    "drop:after=2,n=1,method=POST",
    "close_mid_body:n=1",
    "error:method=GET;latency:path=/route_knn",
])
def test_knn_faults_act_as_the_jax_servers(engines, monkeypatch, spec):
    """``KNN_FAULTS``, read when a server is built, injects the same
    faults into the same requests of both servers: injected errors,
    delays, dropped connections and torn bodies; the requests it spares
    are answered byte for byte."""
    monkeypatch.setenv("KNN_FAULTS", spec)
    pair = [_start(mod, eng) for mod, eng in zip((j_server, t_server),
                                                 engines)]
    try:
        assert pair[1].faults.active()
        seen = []
        for i in range(6):
            body = _json(random_points(5, seed=900 + i), neighbors=True)
            got = [_outcome(s, body) for s in pair]
            assert got[0] == got[1], (i, got)
            seen.append(got[1] if isinstance(got[1], str) else got[1][0])
        assert _both(pair, "/healthz")[0] == 200
    finally:
        for srv in pair:
            srv.close()
    if spec.startswith(("latency", "error:method")):
        assert seen == [200] * 6
    else:
        assert seen != [200] * 6


def test_fault_spec_grammar_equals_jax():
    from mpi_cuda_largescaleknn_torch.serve import faults as t_faults
    from mpi_cuda_largescaleknn_tpu.serve import faults as j_faults

    text = "latency:delay_s=0.2,p=0.5;error:path=/knn,code=503,n=3,after=1"
    for mod in (t_faults, j_faults):
        specs = mod.parse_fault_specs(text)
        assert [(s.op, s.path, s.p, s.n, s.after, s.code, s.delay_s)
                for s in specs] == [("latency", "", 0.5, -1, 0, 500, 0.2),
                                    ("error", "/knn", 1.0, 3, 1, 503, 0.05)]
        assert mod.parse_fault_specs("  ") == []
        for bad in ("explode", "error:bogus=1"):
            with pytest.raises(ValueError):
                mod.parse_fault_specs(bad)
