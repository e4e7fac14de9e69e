"""The yardstick's parts: the open loop's timing, the work counts, the
reference, the trace reading, and what the harness imports."""

import ast
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from conftest import ROOT

from knnbench import arrivals, data, devtrace, loadgen, reference, roofline

FORBIDDEN = {"jax", "jaxlib", "flax", "mpi_cuda_largescaleknn_tpu"}
#: the yardstick's own modules: nothing of the port either
PORT_FREE = {"reference", "roofline", "arrivals", "loadgen", "devtrace",
             "data", "spec"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "knnbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if path.parent.name == "knnbench" and path.stem in PORT_FREE:
        assert "mpi_cuda_largescaleknn_torch" not in tops


def test_schedule_same_work_for_every_seed():
    mix = {"rate_per_s": 40, "rows": {"dist": "log_uniform", "max": 1024}}
    a, b = arrivals.schedule(mix, 30, 1), arrivals.schedule(mix, 30, 2**31 + 9)
    assert len(a["rows"]) == len(b["rows"]) == 1200
    assert sorted(a["rows"]) == sorted(b["rows"])
    assert not np.array_equal(a["rows"], b["rows"])
    assert a["due"][-1] == pytest.approx(b["due"][-1], rel=0.01)
    assert 1 <= a["rows"].min() and a["rows"].max() <= 1024
    assert a["rows"].mean() == pytest.approx(1023 / math.log(1024), rel=0.05)
    sample = arrivals.sampled_requests(a, 5, 3)
    assert int(np.argmax(a["rows"])) in sample and len(sample) <= 6


class _Stalling(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    stall_first = 0.6
    seen = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append(time.perf_counter())
        if len(self.seen) == 1:
            time.sleep(self.stall_first)
        out = np.zeros(len(body) // 12, "<f4").tobytes()
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


def test_open_loop_times_from_due_and_counts_a_stall_behind_it():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stalling)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        mix = {"rate_per_s": 20, "arrivals": "fixed",
               "rows": {"dist": "fixed", "rows": 4}}
        got = loadgen.run({"host": "127.0.0.1",
                           "port": server.server_address[1], "mix": mix,
                           "seconds": 1.0, "seed": 5, "dim": 3,
                           "sample": [0], "workers": 1})
    finally:
        server.shutdown()
    lat = got["latency_ms"]
    # one connection: the requests due while the first stalls wait behind
    # it, and each is timed from when it was due, so the wait shows
    assert got["requests"] == 20 and None not in lat
    assert lat[0] >= 550
    assert lat[1] >= 550 - 50 - 5 and lat[5] >= 550 - 250 - 5
    assert lat[-1] < 100
    assert got["status"] == [200] * 20
    assert len(got["answers"]) == 1


class _RefusingOnce(_Stalling):
    refused = []

    def do_POST(self):
        if not self.refused:
            self.rfile.read(int(self.headers["Content-Length"]))
            self.refused.append(1)
            self.send_response(429)
            self.send_header("Retry-After", "0.2")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        super().do_POST()


def test_open_loop_sends_a_refusal_again_and_times_the_wait():
    _RefusingOnce.seen = []
    _RefusingOnce.stall_first = 0.0
    server = ThreadingHTTPServer(("127.0.0.1", 0), _RefusingOnce)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        mix = {"rate_per_s": 10, "arrivals": "fixed",
               "rows": {"dist": "fixed", "rows": 2}}
        got = loadgen.run({"host": "127.0.0.1",
                           "port": server.server_address[1], "mix": mix,
                           "seconds": 0.5, "seed": 1, "dim": 3,
                           "sample": [], "workers": 2})
    finally:
        server.shutdown()
    assert got["status"] == [200] * 5 and got["retried"][0] == 1
    assert got["latency_ms"][0] >= 190 and sum(got["retried"]) == 1


def test_a_clustered_jobs_layout_is_the_same_for_every_seed():
    spec = {"kind": "clustered", "dim": 8, "clusters": 4,
            "center_sigma": 50.0, "sigma": 1.0}
    a = data.draw_points(spec, 2000, "cpu", 1, "job", 3)
    b = data.draw_points(spec, 2000, "cpu", 2**31 + 5, "job", 3)
    assert torch.equal(a, data.draw_points(spec, 2000, "cpu", 1, "job", 3))
    assert not torch.equal(a, b)
    # the same point joins the same far-apart cluster under either seed
    assert float((a - b).norm(dim=1).max()) < 20.0
    other = data.draw_points(spec, 2000, "cpu", 1, "job", 4)
    assert float((a - other).norm(dim=1).max()) > 20.0


def test_ring_idle_share_averages_each_ranks_own_window():
    from knnbench.drivers import ranks_summary
    from knnbench.spec import metric_reader

    ranks = [{"window_s": 10.0, "busy_s": 9.9, "idle_gaps": [],
              "kernels": {"ncclDevKernel_SendRecv": 0.5}},
             {"window_s": 14.0, "busy_s": 13.0, "idle_gaps": [], "kernels": {}}]
    record = {"trace": ranks_summary(ranks)}
    idle = metric_reader("device.idle_share.selfjoin")(record)
    assert idle == pytest.approx(100 * (1 - 22.9 / 24.0))
    assert metric_reader("mesh.nccl_share.selfjoin")(record) == pytest.approx(5.0)
    assert ranks_summary([None, ranks[1]]) is None


def test_work_counts_on_small_shapes():
    w = roofline.selfjoin_work(1000, 3, 8)
    assert w == {"ops": 1000 * 8 * 8, "bytes": 1000 * 12 + 2 * 1000 * 8 * 8}
    s = roofline.served_work(10, 128, 10)
    assert s == {"ops": 10 * 10 * 383,
                 "bytes": 10 * 512 + 10 * 10 * 512 + 10 * 10 * 8}
    t, bound = roofline.least_seconds(w)
    assert bound == "bytes" and t == pytest.approx(w["bytes"] / 3.35e12)
    assert roofline.least_seconds({"ops": 67e12, "bytes": 0}) == (2.0,
                                                                  "operations")
    assert roofline.roofline_share(w, 2 * t) == pytest.approx(50.0)
    assert roofline.roofline_share(w, 0.0) is None


def _brute_kth(pts, q, k):
    d = np.sqrt(((q[:, None, :].astype(np.float64)
                  - pts[None, :, :].astype(np.float64)) ** 2).sum(-1))
    return np.sort(d, axis=1)[:, k - 1]


@pytest.mark.parametrize("dim", [3, 16])
def test_reference_is_the_brute_force_kth_distance(dim):
    g = torch.Generator().manual_seed(4)
    pts = torch.rand((3000, dim), generator=g)
    q = pts[:50]
    want = _brute_kth(pts.numpy(), q.numpy(), 7)
    got = reference.kth_distances(pts, q, 7, block_elems=50 * 700)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    low = reference.kth_distances(pts, q, 7, precision="bf16")
    assert reference.compare(low, want)["kth_rel_err_max"] > 1e-3
    few = reference.kth_distances(pts[:5], q[:3], 7)
    assert np.isinf(few).all()


def test_compare_counts_missing_and_nonfinite_answers():
    want = np.array([1.0, 2.0, np.inf])
    assert reference.compare(np.array([1.0, 2.0, np.inf]), want) == {
        "kth_rel_err_max": 0.0, "answers_bad": 0}
    assert reference.compare(np.array([1.0, np.nan, 3.0]), want)[
        "answers_bad"] == 2
    assert reference.compare(np.array([1.0]), want) == {
        "kth_rel_err_max": 1.0, "answers_bad": 3}
    assert reference.compare(np.array([1.001, 2.0, np.inf]), want)[
        "kth_rel_err_max"] == pytest.approx(1e-3)


def test_trace_summary_reads_stretches_busy_and_gaps():
    tracer = devtrace.Tracer(True)
    for _ in range(2):
        with tracer.window():
            torch.ones(1000).sum()
            time.sleep(0.01)
    tracer.close()
    assert tracer.stretches == 2
    # no card here: the trace holds no device time and reads as nothing
    assert tracer.summary is None or tracer.summary["window_s"] > 0
    assert devtrace.breakdown(None) is None
    summary = {"window_s": 2.0, "busy_s": 1.5, "idle_gaps": [["a", 0.5]],
               "kernels": {"knn_tiled_d3_kernel<4>": 1.0, "ncclKernel": 0.25,
                           "copy": 0.25}}
    assert devtrace.kernel_seconds(summary, "knn_tiled_d3") == 1.0
    assert devtrace.kernel_seconds(summary, "nccl") == 0.25
    b = devtrace.breakdown(summary)
    assert b["device_ops"][0] == ["knn_tiled_d3_kernel<4>", 1.0]
    json.dumps(b)
