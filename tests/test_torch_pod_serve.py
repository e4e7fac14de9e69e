"""The replicate pod on the port: two ``serve_main --device cpu --merge
device --coordinator`` processes (one gloo group, one ring position each)
behind an in-process ``build_frontend`` (``PodFanout``), against one port
engine and the JAX package's engine.

The points are duplicate-heavy (``tests/test_multihost_serve.py``'s set:
each row four times, so equal distances cross the position edge) and
every query batch sits half ON points: every served byte, ids among ties
included, must equal one port ``ResidentKnnEngine(num_shards=2,
merge="device")`` and the JAX ``ResidentKnnEngine(mesh=get_mesh(2),
merge="device")`` over the same points. Also: concurrent clients through
the pipelined fan-out, the pod's fetched bytes equal to one result a
batch, a 5xx of every host breaking the stream with ``PodBrokenError``
and the monitor's seq-consensus reset restoring it, a ``seq`` gap timing
out to a 503, and (last) one host's 5xx breaking the stream."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.oracle import kth_nn_dist, random_points
from tests.test_multihost_serve import K, _dup_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(bucket_size=64, max_batch=32, min_batch=16, merge="device")
#: wall-clock limit of each host process
CHILD_LIMIT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base, q, binary=False):
    """(status, body) of one POST /knn."""
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
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _set_faults(url, spec):
    req = urllib.request.Request(url + "/faults",
                                 data=json.dumps({"spec": spec}).encode(),
                                 headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=30).read()


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Two pod processes over one 2-position mesh and their URLs."""
    from mpi_cuda_largescaleknn_torch.serve.frontend import wait_hosts_ready

    tmp = tmp_path_factory.mktemp("pod")
    points = _dup_points(600, seed=23)
    in_path = str(tmp / "pts.float3")
    points.tofile(in_path)
    coord = _free_port()
    ports = [_free_port(), _free_port()]
    base = ["timeout", str(CHILD_LIMIT_S), sys.executable, "-m",
            "mpi_cuda_largescaleknn_torch.cli.serve_main", in_path,
            "-k", str(K), "--device", "cpu", "--bucket-size", "64",
            "--max-batch", "32", "--min-batch", "16", "--merge", "device",
            "--coordinator", f"127.0.0.1:{coord}", "--num-hosts", "2"]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        base + ["--host-id", str(i), "--port", str(ports[i])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in (1, 0)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    try:
        try:
            wait_hosts_ready(urls, timeout_s=180.0)
        except TimeoutError:
            outs = [p.communicate(timeout=5)[0] if p.poll() is not None
                    else "<still running>" for p in procs]
            raise AssertionError(f"pod never came up: {outs}")
        yield urls, points
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()


@pytest.fixture(scope="module")
def refs():
    """One port engine and one JAX engine over the same points, both
    2-shard device merges."""
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
    from mpi_cuda_largescaleknn_tpu.serve.engine import (
        ResidentKnnEngine as JaxEngine,
    )

    points = _dup_points(600, seed=23)
    ours = ResidentKnnEngine(points, K, num_shards=2, device="cpu", **KW)
    jax = JaxEngine(points, K, mesh=get_mesh(2), engine="tiled", **KW)
    ours.warmup()
    jax.warmup()
    return ours, jax


@pytest.fixture(scope="module")
def frontend(pod):
    from mpi_cuda_largescaleknn_torch.serve.frontend import build_frontend

    urls, _points = pod
    # a per-try budget, so a host stuck in the merge's all_to_all after
    # its peer failed costs seconds, not the pod-wide timeout
    srv = build_frontend(urls, port=0, pipeline_depth=2,
                         request_timeout_s=5.0, start_monitor=False)
    srv.ready = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.close()


def _queries(n, points):
    q = random_points(n, seed=300 + n)
    q[: n // 2] = points[: n // 2]  # ON the duplicated points
    return q


def _assert_equals_refs(status, body, q, refs, binary):
    assert status == 200, body[:300]
    for ref in refs:
        want_d, want_n = ref.query(q)
        if binary:
            assert body == want_d.astype("<f4").tobytes()
        else:
            resp = json.loads(body)
            got_d = np.asarray(resp["dists"], np.float32)
            assert got_d.tobytes() == want_d.tobytes()
            assert np.array_equal(np.asarray(resp["neighbors"], np.int32),
                                  want_n)


@pytest.mark.parametrize("binary", [False, True])
def test_ragged_bodies_equal_one_engine_and_jax(pod, frontend, refs,
                                                binary):
    """Ragged batches padding to both shape buckets, half of each ON the
    duplicated points (distance-0 ties across the position edge)."""
    _urls, points = pod
    _srv, base = frontend
    for n in (1, 5, 16, 17, 32):
        q = _queries(n, points)
        status, body = _post(base, q, binary)
        _assert_equals_refs(status, body, q, refs, binary)
        if not binary:
            np.testing.assert_allclose(
                np.asarray(json.loads(body)["dists"], np.float32),
                kth_nn_dist(q, points, K), rtol=5e-7, atol=1e-37)


def test_concurrent_clients_through_pipelined_fanout(frontend, refs):
    _srv, base = frontend
    results = {}

    def client(i):
        q = random_points(3 + 2 * i, seed=600 + i)
        results[i] = (q, _post(base, q))

    ths = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert len(results) == 6
    for q, (status, body) in results.values():
        _assert_equals_refs(status, body, q, refs, binary=False)


def test_pod_config_health_and_stats(pod, frontend):
    """The replicate pod's validation, the hosts' pod surface and the
    front end's straggler accounting."""
    from mpi_cuda_largescaleknn_torch.serve.frontend import (
        pod_config_from_hosts,
    )

    urls, points = pod
    srv, base = frontend
    cfg = pod_config_from_hosts(urls)
    assert cfg["routing"] == "off" and cfg["host_urls"] == urls
    assert (cfg["k"], cfg["num_shards"], cfg["n_points"],
            cfg["min_batch"], cfg["max_batch"]) == (K, 2, len(points),
                                                    16, 32)
    with pytest.raises(ValueError, match="process_count=2"):
        pod_config_from_hosts(urls[:1])
    with pytest.raises(ValueError, match="covers mesh positions"):
        pod_config_from_hosts(urls[:1] * 2)
    for i, url in enumerate(urls):
        status, hz = _get(url + "/healthz")
        assert status == 200 and hz["role"] == "host-slice"
        e = _get(url + "/stats")[1]["engine"]
        assert e["multihost"] is True and e["merge"] == "device"
        assert e["process_count"] == 2 and e["my_positions"] == [i]
        assert e["exchange_bytes"] > 0 and e["exchange_seconds"] > 0
    _post(base, random_points(8, seed=5))
    status, hz = _get(base + "/healthz")
    assert status == 200 and hz["status"] == "ok"
    fan = _get(base + "/stats")[1]["fanout"]
    assert fan["batches"] > 0 and fan["broken"] is None
    assert all(h["ok"] > 0 for h in fan["per_host"].values())
    m = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    assert "knn_fanout_straggler_seconds_total" in m
    assert "knn_pod_broken 0" in m


def test_pod_fetch_bytes_are_one_result_per_batch(pod, frontend):
    """Summed across hosts, the fetched result bytes of a batch equal ONE
    [qpad] + [qpad, k] result: each host fetches its own row slice."""
    urls, _points = pod
    _srv, base = frontend

    def pod_fetch_bytes():
        return sum(_get(url + "/stats")[1]["engine"]["fetch_bytes"]
                   for url in urls)

    before = pod_fetch_bytes()
    assert _post(base, random_points(16, seed=9))[0] == 200
    qpad = 16
    assert pod_fetch_bytes() - before == qpad * 4 + qpad * K * 4


def test_every_host_5xx_breaks_then_resets(pod, frontend, refs):
    """Every host failing one batch breaks the stream (503 naming
    ``PodBrokenError``, fast 503s after); the hosts never entered that
    batch's merge, so they agree on ``next_seq``, and the monitor's reset
    brings the pod back byte-equal to the references."""
    urls, points = pod
    srv, base = frontend
    q = _queries(12, points)
    for url in urls:
        _set_faults(url, "error:code=500,path=/shard_knn,n=1")
    status, body = _post(base, q)
    assert status == 503 and b"PodBrokenError" in body
    status, hz = _get(base + "/healthz")
    assert status == 503 and hz["status"] == "broken" and hz["broken"]
    assert _post(base, q)[0] == 503
    seqs = {_get(url + "/healthz")[1]["next_seq"] for url in urls}
    assert len(seqs) == 1
    srv.monitor.check_once(now=1e9)
    assert srv.fanout.broken_reason() is None
    assert srv.monitor.stream_resets == 1
    _assert_equals_refs(*_post(base, q), q, refs, binary=False)


def test_seq_gap_times_out_to_503():
    """A ``seq`` that is never next waits ``seq_timeout_s`` and answers
    503 with Retry-After, on a host of one process (the JAX package's
    drill)."""
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.frontend import HostSliceServer

    eng = ResidentKnnEngine(_dup_points(64, seed=3), K, num_shards=2,
                            device="cpu", **KW)
    with pytest.raises(ValueError, match="seq_timeout_s"):
        HostSliceServer(("127.0.0.1", 0), eng, routing="off",
                        seq_timeout_s=0.0)
    srv = HostSliceServer(("127.0.0.1", 0), eng, routing="off",
                          seq_timeout_s=0.05)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv.ready = True
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        body = np.zeros((1, 3), np.float32).tobytes()
        req = urllib.request.Request(
            url + "/shard_knn?seq=1000000", data=body,
            headers={"Content-Type": "application/octet-stream"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        assert "stream" in json.loads(ei.value.read())["error"]
        # the in-order seq still serves: one process owns every row
        req = urllib.request.Request(
            url + "/shard_knn?seq=0", data=body,
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers["X-Knn-Rows"] == "1"
    finally:
        srv.close()


def test_zz_one_host_5xx_breaks_the_stream(pod, frontend):
    """One host's 5xx: its peer is left in the batch's merge, the front
    end's per-try budget ends the wait, and the pod answers 503 naming
    ``PodBrokenError`` with the failed host drained. Last in the file:
    the pod cannot run another batch."""
    urls, _points = pod
    srv, base = frontend
    _set_faults(urls[1], "error:code=500,path=/shard_knn")
    status, body = _post(base, random_points(4, seed=1))
    assert status == 503 and b"PodBrokenError" in body
    assert srv.fanout.endpoints[1].health.state == "drained"
    status, hz = _get(base + "/healthz")
    assert status == 503 and hz["broken"]
