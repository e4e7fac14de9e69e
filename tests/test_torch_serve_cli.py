"""The port's serving CLI (``cli/serve_main.py``): the same option dict
as the JAX CLI's for the single-host flags (the slab pool's and tenancy's
included), each flag of pod, routed and standby serving refused with
``not_ported`` naming its ROADMAP item, and ``main`` run in process on the
CPU answering a JSON and a binary request, then shutting down."""

import json
import queue
import threading
import urllib.request

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


@pytest.mark.parametrize("flag,value,item", [
    ("--coordinator", "127.0.0.1:9", "pod serving"),
    ("--num-hosts", "2", "pod serving"),
    ("--host-id", "1", "pod serving"),
    ("--routing", "bounds", "pod serving"),
    ("--standby", None, "pod serving"),
    ("--wire", "f32", "pod serving"),
    ("--seq-timeout-s", "5", "pod serving"),
])
def test_refused_flags_name_their_item(flag, value, item):
    argv = ["pts.float3", "-k", "8", flag] + ([value] if value else [])
    with pytest.raises(NotImplementedError, match=item):
        t_cli.parse_serve_args(argv)


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
