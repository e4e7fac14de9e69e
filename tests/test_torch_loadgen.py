"""``tools/torch_loadgen.py`` against the JAX package's ``tools/loadgen.py``:
for a seed, every worker's first requests (path and body bytes) are
byte-equal to JAX's, captured by a recording HTTP server on the CPU, for
the uniform, clustered and sweep workloads, tenant skew and
``--dup-frac``/``--revisit``; and ``run_load`` against the port's own
server on the CPU returns a report with JAX's keys and no errors."""

from __future__ import annotations

import importlib.util
import json
import os
import threading
import time
import types
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loadgens():
    """Fresh module objects of both load generators (each test patches
    its own copies' clocks)."""
    return (_load("t_loadgen", "tools/torch_loadgen.py"),
            _load("j_loadgen", "tools/loadgen.py"))


class _Recorder(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _RecordingHandler)
        self.lock = threading.Lock()
        #: client (host, port) -> [(path, body bytes)] in arrival order:
        #: each worker holds one persistent connection per endpoint
        self.streams: dict = {}


class _RecordingHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):  # noqa: N802 - http.server's naming
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        with self.server.lock:
            self.server.streams.setdefault(self.client_address, []).append(
                (self.path, body))
        if self.headers.get("Content-Type") == "application/json":
            out, ctype = b"{}", "application/json"
        else:
            out, ctype = b"", "application/octet-stream"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


class _FakeClock(types.SimpleNamespace):
    """A ``time`` stand-in whose monotonic clock steps by a fixed amount
    per call, so a time-driven stream (the sweep's window) is a pure
    function of the call sequence."""

    def __init__(self, step=0.01):
        super().__init__(perf_counter=time.perf_counter, sleep=time.sleep)
        self._t = 1000.0
        self._step = step
        self._lock = threading.Lock()

    def monotonic(self):
        with self._lock:
            self._t += self._step
            return self._t


def _record(mod, first: int, fake_clock: bool, **kw):
    """Run ``mod.run_load`` against a recorder; returns the multiset of
    each connection's first ``first`` requests."""
    if fake_clock:
        mod.time = _FakeClock()
    srv = _Recorder()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        rep = mod.run_load(f"http://127.0.0.1:{srv.server_address[1]}",
                           **kw)
    finally:
        srv.shutdown()
        srv.server_close()
    assert rep["net_error"] == 0 and rep["ok"] > 0
    streams = list(srv.streams.values())
    assert len(streams) == kw.get("concurrency", 4)
    assert all(len(s) >= first for s in streams), [len(s) for s in streams]
    return Counter(tuple(s[:first]) for s in streams)


#: name -> (run_load arguments, first requests compared per worker,
#: fake clock)
STREAMS = {
    "uniform_binary": (dict(workload="uniform", concurrency=3, batch=16,
                            binary=True, seed=11), 4, False),
    "uniform_json": (dict(workload="uniform", concurrency=2, batch=5,
                          neighbors=True, seed=3), 4, False),
    "clustered": (dict(workload="clustered", concurrency=3, batch=8,
                       binary=True, seed=5, blobs=6, blob_sigma=0.05,
                       scale=2.0), 4, False),
    "sweep": (dict(workload="sweep", concurrency=1, batch=8, binary=True,
                   seed=2, sweep_period_s=0.25, duration_s=0.4), 12, True),
    "tenant_skew": (dict(workload="uniform", concurrency=3, batch=4,
                         binary=True, seed=9, tenants=["hot", "a", "b"],
                         tenant_skew=1.6), 6, False),
    "dup_frac": (dict(workload="clustered", concurrency=1, batch=8,
                      binary=True, seed=4, dup_frac=0.5), 12, False),
    "revisit": (dict(workload="uniform", concurrency=1, batch=8,
                     binary=True, seed=6, dup_frac=0.2,
                     revisit_sigma=0.01), 12, False),
    "recall_target": (dict(workload="uniform", concurrency=2, batch=4,
                           binary=True, seed=1, recall=0.95), 3, False),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_request_streams_equal_jax(name):
    kw, first, fake = STREAMS[name]
    kw = dict(kw)
    kw.setdefault("duration_s", 0.6)
    port_mod, jax_mod = loadgens()
    got = _record(port_mod, first, fake, **kw)
    want = _record(jax_mod, first, fake, **kw)
    assert got == want


def test_bad_workload_refused_alike():
    port_mod, jax_mod = loadgens()
    for mod in (port_mod, jax_mod):
        with pytest.raises(ValueError, match="unknown workload"):
            mod.run_load("http://127.0.0.1:9", workload="zipf")


@pytest.fixture(scope="module")
def port_server():
    import numpy as np

    from mpi_cuda_largescaleknn_torch.serve import server as t_server
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine

    pts = np.random.default_rng(0).random((2000, 3)).astype(np.float32)
    engine = ResidentKnnEngine(pts, 8, num_shards=2, engine="tiled",
                               bucket_size=32, max_batch=64, min_batch=8,
                               device="cpu")
    engine.warmup()
    srv = t_server.build_server(engine, port=0, max_delay_s=0.002)
    srv.ready = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.close()


@pytest.mark.parametrize("binary", [True, False])
def test_run_load_against_port_server(port_server, binary):
    """Both generators against the port's CPU server: no errors, every
    request answered exactly, and reports with the same keys."""
    port_mod, jax_mod = loadgens()
    kw = dict(duration_s=0.8, concurrency=2, batch=8, binary=binary,
              server_stats=True, seed=0)
    got = port_mod.run_load(port_server, **kw)
    want = jax_mod.run_load(port_server, **kw)
    for rep in (got, want):
        assert rep["ok"] > 0 and rep["requests"] == rep["ok"]
        assert rep["net_error"] == rep["http_error"] == 0
        assert rep["degraded"] == 0 and rep["availability"] == 1.0
    assert sorted(got) == sorted(want)
    assert sorted(got["server"]) == sorted(want["server"])
    assert got["server"]["engine"] == "tiled"
    json.dumps(got)  # strict JSON


def test_loadgen_imports_no_torch():
    """The generator is a client: in a fresh interpreter, loading it (the
    package's ``LatencyHistogram`` included) imports neither torch nor
    JAX, so a loadgen process starts in well under a second."""
    import subprocess
    import sys

    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('lg', "
            "'tools/torch_loadgen.py')\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "print(sorted(n for n in ('torch', 'jax', "
            "'mpi_cuda_largescaleknn_tpu') if n in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_card_stats_only_for_an_engine_on_the_card(monkeypatch):
    """``/stats`` gains ``launches`` and ``device_memory`` only when the
    engine runs on the card, so on the CPU its keys stay the JAX
    server's."""
    import torch

    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts
    from mpi_cuda_largescaleknn_torch.serve import server as t_server

    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert t_server._card_stats(cpu) == {}
    assert t_server._card_stats(types.SimpleNamespace()) == {}
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 123)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 456)
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert t_server._card_stats(card) == {
        "launches": launch_counts(),
        "device_memory": {"allocated_bytes": 123,
                          "peak_allocated_bytes": 456}}


def test_many_concurrent_clients_are_all_answered(tmp_path):
    """32 workers connecting at once to a ``serve_main`` process: every
    connection is accepted and every request answered. (``socketserver``'s
    listen backlog of 5 overflowed, and the kernel reset the first request
    of each connection past it about a second later.)"""
    import subprocess
    import sys

    import numpy as np

    from mpi_cuda_largescaleknn_torch.serve.frontend import FrontendServer
    from mpi_cuda_largescaleknn_torch.serve.server import KnnServer

    assert KnnServer.request_queue_size >= 32
    assert FrontendServer.request_queue_size >= 32
    path = tmp_path / "pts.float3"
    np.random.default_rng(1).random((200_000, 3), dtype=np.float32).tofile(
        path)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m",
         "mpi_cuda_largescaleknn_torch.cli.serve_main", str(path), "-k", "8",
         "--port", "0", "--device", "cpu", "--max-queue-rows", "8192",
         "--timeout-ms", "60000"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving kNN on http://"):
                url = line.split()[3]
                break
        assert url, "serve_main did not start"
        port_mod, _ = loadgens()
        for seed in range(2):
            rep = port_mod.run_load(url, duration_s=2.0, concurrency=32,
                                    batch=8, binary=True, seed=seed,
                                    timeout_s=60.0)
            assert rep["net_error"] == 0
            assert rep["ok"] == rep["requests"] > 0
    finally:
        proc.kill()
        proc.wait()
