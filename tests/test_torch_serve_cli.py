"""The port's serving CLI (``cli/serve_main.py``): the same option dict
as the JAX CLI's for the single-host flags (the slab pool's and tenancy's
included) and the routed pod's (``--routing bounds --num-hosts --host-id
--wire``), the replicate pod's and the standby's, the JAX CLI's usage
errors word for word, ``main`` run in process on the CPU answering a JSON
and a binary request, and a routed pod of ``main`` hosts plus
``serve.frontend.main`` answering byte-equal to the JAX package's CLI
pod."""

import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.cli import serve_main as t_cli
from mpi_cuda_largescaleknn_tpu.cli import serve_main as j_cli
from tests.oracle import assert_dist_equal, kth_nn_dist, random_points

SINGLE_HOST = [
    ["pts.float3", "-k", "8"],
    ["-k", "100", "pts.npy", "-r", "0.25", "--port", "0", "--host",
     "0.0.0.0", "--engine", "pallas_tiled", "--merge", "device",
     "--shards", "4", "--bucket-size", "128", "--score-dtype", "bf16",
     "--query-buckets", "1", "--max-batch", "512", "--min-batch", "16",
     "--max-delay-ms", "0.5", "--pipeline-depth", "3",
     "--max-queue-rows", "1024", "--timeout-ms", "250",
     "--qcache-rows", "0", "--qcache-seed-rows", "64",
     "--recall-policy", "plans.json", "--no-warmup", "--timings",
     "--verbose"],
    ["pts.float3", "-k", "8", "--num-slabs", "8", "--device-slab-budget",
     "2g", "--host-pool-bytes", "512m", "--host-pool-slabs", "3",
     "--prefetch-depth", "2"],
    ["-k", "8", "--tenant", "a=a.float3", "--tenant", "b=b.npy",
     "--num-slabs", "4", "--device-slab-budget", "65536k",
     "--tenant-quota-rows", "64"],
]

TIER_FLAGS = [("--num-slabs", "4"), ("--device-slab-budget", "1g"),
              ("--host-pool-bytes", "1.5m"), ("--host-pool-slabs", "2"),
              ("--prefetch-depth", "2"), ("--tenant", "a=pts.float3"),
              ("--tenant-quota-rows", "64")]


@pytest.mark.parametrize("argv", SINGLE_HOST)
def test_parse_serve_args_equals_jax(argv):
    got = t_cli.parse_serve_args(argv)
    assert got.pop("device") is None
    assert got == j_cli.parse_serve_args(argv)
    assert t_cli.parse_serve_args(argv + ["--device", "cpu"])["device"] \
        == "cpu"


@pytest.mark.parametrize("flag,value", [
    # ids as before the pod flags were ported
    pytest.param("--coordinator", "127.0.0.1:9",
                 id="--coordinator-127.0.0.1:9-pod serving"),
    pytest.param("--num-hosts", "2", id="--num-hosts-2-pod serving"),
    pytest.param("--host-id", "1", id="--host-id-1-pod serving"),
    pytest.param("--routing", "bounds", id="--routing-bounds-pod serving"),
    pytest.param("--standby", None, id="--standby-None-pod serving"),
    pytest.param("--wire", "f32", id="--wire-f32-pod serving"),
    pytest.param("--seq-timeout-s", "5",
                 id="--seq-timeout-s-5-pod serving"),
])
def test_refused_flags_name_their_item(flag, value):
    """Each pod flag alone parses to the JAX CLI's option dict (plus
    ``device``): the replicate pod's (``--coordinator``, ``--num-hosts``
    without ``--routing bounds``, ``--seq-timeout-s``), the routed pod's
    and ``--standby`` (given ``--routing bounds``, which JAX asks of
    it). These flags were refused before the pods were ported."""
    argv = ["pts.float3", "-k", "8", flag] + ([value] if value else [])
    if flag == "--standby":
        argv += ["--routing", "bounds"]
    got = t_cli.parse_serve_args(argv)
    assert got.pop("device") is None
    assert got == j_cli.parse_serve_args(argv)


ROUTED = [["pts.float3", "-k", "8", "--routing", "bounds", "--num-hosts",
           "4", "--host-id", "3", "--wire", "f32", "--port", "0"],
          ["pts.npy", "-k", "100", "--routing", "bounds", "--num-hosts",
           "2", "--host-id", "0", "--num-slabs", "4",
           "--device-slab-budget", "1m", "--shards", "2"]]


@pytest.mark.parametrize("argv", ROUTED)
def test_routed_args_parse_as_jax(argv):
    got = t_cli.parse_serve_args(argv)
    assert got.pop("device") is None
    assert got == j_cli.parse_serve_args(argv)


POD_USAGE = [
    ["pts.float3", "-k", "8", "--routing", "rings"],
    ["pts.float3", "-k", "8", "--wire", "q16"],
    ["pts.float3", "-k", "8", "--routing", "bounds", "--coordinator",
     "127.0.0.1:9"],
    ["pts.float3", "-k", "8", "--standby"],
    ["pts.float3", "-k", "8", "--num-slabs", "2", "--num-hosts", "2"],
    ["pts.float3", "-k", "8", "--routing", "bounds", "--standby",
     "--num-slabs", "2"],
    ["-k", "8", "--tenant", "a=x.float3", "--routing", "bounds"],
]


@pytest.mark.parametrize("argv", POD_USAGE)
def test_pod_usage_errors_are_jax_words(argv, capsys):
    """The JAX CLI's usage errors of the pod flags, word for word, exit 1."""
    lines = []
    for cli in (t_cli, j_cli):
        with pytest.raises(SystemExit) as e:
            cli.parse_serve_args(argv)
        assert e.value.code == 1
        lines.append(capsys.readouterr().err.splitlines()[0])
    assert lines[0] == lines[1] and lines[0].startswith("Error: ")


def test_routed_host_id_outside_the_pod_exits_1(tmp_path, capsys):
    path = tmp_path / "pts.float3"
    random_points(64, seed=3).tofile(path)
    with pytest.raises(SystemExit) as e:
        t_cli.main([str(path), "-k", "4", "--routing", "bounds",
                    "--num-hosts", "2", "--host-id", "2", "--device", "cpu"])
    assert e.value.code == 1
    assert "Error: --host-id 2 outside [0, 2)" in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", TIER_FLAGS)
def test_tier_flags_parse_as_jax(flag, value):
    """The slab pool's and tenancy's flags, each alone, give the JAX CLI's
    option dict (a tenant flag drops the positional input, as JAX asks)."""
    argv = ([] if flag == "--tenant" else ["pts.float3"]) + \
        ["-k", "8", flag, value]
    got = t_cli.parse_serve_args(argv)
    assert got.pop("device") is None
    assert got == j_cli.parse_serve_args(argv)


def test_tier_usage_errors_exit_1():
    """The JAX CLI's refusals: a positional input beside --tenant, a
    duplicate tenant, a tenant without '=', a negative --num-slabs."""
    for argv in (["pts.float3", "-k", "8", "--tenant", "a=x.float3"],
                 ["-k", "8", "--tenant", "a=x", "--tenant", "a=y"],
                 ["-k", "8", "--tenant", "a"],
                 ["pts.float3", "-k", "8", "--num-slabs", "-1"]):
        for cli in (t_cli, j_cli):
            with pytest.raises(SystemExit) as e:
                cli.parse_serve_args(argv)
            assert e.value.code == 1


def test_usage_errors_exit_1():
    for argv in (["-k", "8"], ["pts.float3"], ["pts.float3", "-k", "8",
                                               "--bogus"]):
        with pytest.raises(SystemExit) as e:
            t_cli.parse_serve_args(argv)
        assert e.value.code == 1


def _post(port, body, ctype):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/knn", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_main_serves_json_and_binary_then_stops(tmp_path, capsys):
    pts = random_points(1200, seed=4)
    path = tmp_path / "pts.float3"
    pts.tofile(path)
    ready = queue.Queue()
    rc = []
    th = threading.Thread(target=lambda: rc.append(t_cli.main(
        [str(path), "-k", "8", "--port", "0", "--device", "cpu",
         "--max-batch", "64", "--shards", "2", "--timings"],
        ready=ready.put)), daemon=True)
    th.start()
    srv = ready.get(timeout=300)
    try:
        port = srv.server_address[1]
        assert srv.engine.engine_name == "pallas_tiled"
        assert srv.engine.compile_count == len(srv.engine.shape_buckets)
        q = random_points(20, seed=9)
        resp = json.loads(_post(port, json.dumps(
            {"queries": q.tolist(), "neighbors": True}).encode(),
            "application/json"))
        want = kth_nn_dist(q, pts, 8)
        assert_dist_equal(np.asarray(resp["dists"], np.float32), want)
        assert np.asarray(resp["neighbors"]).shape == (20, 8)
        got = np.frombuffer(_post(port, q.astype("<f4").tobytes(),
                                  "application/octet-stream"), "<f4")
        assert got.tobytes() == np.asarray(resp["dists"],
                                           np.float32).tobytes()
    finally:
        srv.shutdown()
    th.join(timeout=60)
    assert not th.is_alive() and rc == [0]
    out = capsys.readouterr()
    assert "serving kNN on http://127.0.0.1:" in out.out
    # the binary request's rows were the query cache's exact hits
    assert json.loads(out.err.strip().splitlines()[-1])["result_rows"] == 20


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ok(url, seconds=240):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise TimeoutError(f"{url} not ready after {seconds} s")


def _knn_bodies(base, reqs):
    out = []
    for q, binary in reqs:
        if binary:
            body, ctype = q.astype("<f4").tobytes(), "application/octet-stream"
        else:
            body = json.dumps({"queries": q.tolist(),
                               "neighbors": True}).encode()
            ctype = "application/json"
        out.append(_post_url(base, body, ctype))
    return out


def _post_url(base, body, ctype):
    req = urllib.request.Request(base + "/knn", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_routed_cli_pod_equals_jax_cli_pod(tmp_path):
    """Two ``main`` hosts (``--routing bounds --num-hosts 2 --host-id i
    --device cpu``) and ``serve.frontend.main`` in this process, beside the
    JAX package's two ``serve_main`` hosts and its front end as
    subprocesses, over one Morton-sorted file whose rows straddling the
    slab boundary are duplicated across it: every response body
    byte-equal, JSON and binary."""
    from mpi_cuda_largescaleknn_torch.serve import frontend as t_fe
    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    pts = random_points(2000, seed=21)
    pts = np.ascontiguousarray(pts[morton_argsort(pts, pts.min(0),
                                                  pts.max(0))])
    pts[1000:1004] = pts[996:1000]  # copies across the slab boundary
    path = tmp_path / "pts.float3"
    pts.tofile(path)
    common = [str(path), "-k", "8", "--routing", "bounds", "--num-hosts",
              "2", "--shards", "1", "--max-batch", "64", "--min-batch", "16"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
               PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs, servers, threads = [], [], []
    try:
        jax_urls = []
        for i in range(2):
            port = _free_port()
            jax_urls.append(f"http://127.0.0.1:{port}")
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "mpi_cuda_largescaleknn_tpu.cli.serve_main", *common,
                 "--host-id", str(i), "--port", str(port), "--engine",
                 "tiled"], env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL))
        jax_fe = f"http://127.0.0.1:{_free_port()}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpi_cuda_largescaleknn_tpu.serve.frontend",
             "--hosts", ",".join(jax_urls),
             "--port", jax_fe.rsplit(":", 1)[1]],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        ready = queue.Queue()
        for i in range(2):
            th = threading.Thread(target=t_cli.main, args=(
                common + ["--host-id", str(i), "--port", "0", "--device",
                          "cpu"],), kwargs={"ready": ready.put}, daemon=True)
            th.start()
            threads.append(th)
        servers = [ready.get(timeout=300) for _ in range(2)]
        urls = sorted(f"http://127.0.0.1:{s.server_address[1]}"
                      for s in servers)
        th = threading.Thread(target=t_fe.main, args=(
            ["--hosts", ",".join(urls[::-1]), "--port", "0"],),
            kwargs={"ready": ready.put}, daemon=True)
        th.start()
        threads.append(th)
        fe = ready.get(timeout=300)
        servers.append(fe)
        base = f"http://127.0.0.1:{fe.server_address[1]}"
        _wait_ok(jax_fe)
        rng = np.random.default_rng(8)
        reqs = []
        for i, n in enumerate((1, 7, 16, 33, 64, 5)):
            q = rng.random((n, 3)).astype(np.float32)
            q[: n // 2] = pts[996 + np.arange(n // 2) % 8]  # on the copies
            reqs.append((q, i % 2 == 1))
        got = _knn_bodies(base, reqs)
        want = _knn_bodies(jax_fe, reqs)
        assert got == want
        for (q, binary), body in zip(reqs, got):
            if not binary:
                obj = json.loads(body)
                assert obj["exact"] is True
                want_d = kth_nn_dist(q, pts, 8)
                assert_dist_equal(np.asarray(obj["dists"], np.float32),
                                  want_d)
                # ties at distance 0 across hosts: ids ascending
                nb = np.asarray(obj["neighbors"])
                for row, d0 in zip(nb, q):
                    zero = [j for j in row
                            if np.all(pts[j] == d0)]
                    assert zero == sorted(zero)
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["fanout"]["routing"]["mode"] == "bounds"
    finally:
        for s in servers:
            s.shutdown()
        for th in threads:
            th.join(timeout=60)
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
