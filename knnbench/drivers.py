"""The ways a cell drives the port. Three are built in, chosen by the
cell's mix and configuration:

- ``jobs`` (mix ``"loop": "jobs"``, one rank): self-join jobs back to
  back, each ``UnorderedKNN(KnnConfig(k=..., <the configuration's
  options>)).run`` on a host array drawn from (seed, job), as a user calls
  it;
- ``ring`` (mix ``"loop": "jobs"``, ``"ranks" > 1``): the same jobs over
  ``ranks`` processes, one card each, each process's block through
  ``ring_knn(..., mesh=)``; this process is rank 0 and starts the others
  (``python3 -m knnbench.rank``);
- ``open`` (mix ``"loop": "open"``): ``cli/serve_main.py``'s server on
  the cell's index in this process, and ``loadgen.py``'s open loop in
  another.

The fourth is a driver file: a configuration with ``"pipeline": "<name>"``
is driven by ``run`` of ``pipelines/<name>.py`` in the checkout that
describes the cell (``spec.pipeline`` says what the file defines), so a
cell that none of the three runs comes as new files alone.

Each returns a ``Run``: the end-to-end metrics, the record the per-layer
readers read, the device, and the numbers the check compares. The window
and set-up are timed here by the host's clock; the port is imported only
inside the drivers.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from knnbench import arrivals, data, devtrace, reference
from knnbench.spec import driver_of, pipeline

ROOT = Path(__file__).resolve().parents[1]
#: a traced job loop profiles its jobs until this many seconds of job time
#: are traced; the rest of its window runs untraced, so that reading the
#: trace stays within the run's time limit
TRACE_SECONDS = 10.0
#: the module each further rank of a ring cell runs
RANK_MODULE = "knnbench.rank"


@dataclass
class Run:
    metrics: dict                       # end-to-end: name -> value
    record: dict                        # what the per-layer readers read
    device: dict
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _device_info(device, count: int, peak: int) -> dict:
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": int(peak)}


def _options(cfg: dict, keys) -> dict:
    """The port's options that the configuration states, under their
    names in ``KnnConfig`` and ``ring_knn``."""
    return {key: cfg[key] for key in keys if key in cfg}


def _setup_parts(t_start: float, marks: list) -> dict:
    """Seconds of each part of set-up: ``marks`` are (name, the host clock
    at the part's end), in order; the first part starts at ``t_start``."""
    parts, last = {}, t_start
    for name, t in marks:
        parts[name] = t - last
        last = t
    return parts


def _stages(timers) -> dict:
    return {name: rec.seconds for name, rec in timers.phases.items()}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def _check_limits(cell, numbers: dict) -> dict:
    """Each compared number beside its limit from the cell's file."""
    return {name: (value, float(cell.check[name]))
            for name, value in numbers.items()}


def _worst(parts: list[dict]) -> dict:
    if not parts:
        return {"kth_rel_err_max": 1.0, "answers_bad": 1}
    return {"kth_rel_err_max": max(p["kth_rel_err_max"] for p in parts),
            "answers_bad": sum(p["answers_bad"] for p in parts)}


# ------------------------------------------------------------------ jobs


def run_jobs(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Run:
    marks = [("imports", time.perf_counter())]
    from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN

    cfg, mix = cell.config, cell.traffic
    n, k, spec = int(cfg["points_per_rank"]), int(cfg["k"]), cfg["points"]
    per_job = int(mix["sample_per_job"])
    _reset_peak(device)
    model = UnorderedKNN(KnnConfig(
        k=k, device=str(device),
        **_options(cfg, ("engine", "score_dtype", "query_chunk", "merge"))))
    marks.append(("port_and_device", time.perf_counter()))
    warm = data.host_points(spec, n, device, seed, "warmup", 0)
    marks.append(("warmup_points", time.perf_counter()))
    # set-up: one job on points of its own builds and warms every kernel
    # and shape the window's jobs use
    model.run(warm)
    _sync(device)
    del warm
    marks.append(("warmup_job", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    before = _stages(model.timers)
    samples = []
    wall = 0.0
    tracer = devtrace.Tracer(trace, TRACE_SECONDS)
    while wall < seconds:
        j = len(samples)
        pts = data.host_points(spec, n, device, seed, "job", j)
        with tracer.window():
            t0 = time.perf_counter()
            out = model.run(pts)
            wall += time.perf_counter() - t0
        if tracer.full:
            tracer.stop()
        del pts
        idx = data.sample_rows(n, per_job, seed, "sample", j)
        samples.append((j, idx, out[idx] if len(out) == n
                        else np.zeros(0, np.float32)))
    tracer.close()
    jobs = len(samples)
    stages = _delta(_stages(model.timers), before)
    peak = _peak(device)
    del model
    _free(device)
    parts = []
    for j, idx, got in samples:
        pts = data.draw_points(spec, n, device, seed, "job", j)
        want = reference.kth_distances(pts, pts[torch.from_numpy(idx)
                                                .to(device)], k)
        parts.append(reference.compare(got, want))
        del pts
    numbers = _worst(parts)
    return Run(
        metrics={"selfjoin_points_per_s": n * jobs / wall,
                 "setup_s": setup_s, "peak_device_mib": peak / 2**20},
        record={"jobs": jobs, "window_s": wall, "points_per_job": n,
                "dim": int(spec["dim"]), "k": k, "stages": stages,
                "setup_parts": _setup_parts(t_start, marks),
                "trace": tracer.summary, "traced_jobs": tracer.stretches},
        device=_device_info(device, 1, peak),
        checks=_check_limits(cell, numbers), attempted=jobs, failed=0)


# ----------------------------------------------------------------- serve


def _percentile(values: list[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q% at or below."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


@contextlib.contextmanager
def serving(cell, seed: int, device):
    """``cli/serve_main.py``'s server, with its defaults, on the cell's
    index, in a thread of this process; yields (the server, the index's
    host points). The index goes through a ``.float3`` file under TMPDIR,
    as the CLI reads it, removed once loaded. On leaving, the server is
    shut down and its engine freed."""
    from mpi_cuda_largescaleknn_torch.cli import serve_main

    cfg = cell.config
    n, k, spec = int(cfg["points_per_rank"]), int(cfg["k"]), cfg["points"]
    points = data.host_points(spec, n, device, seed, "index", 0)
    tmp = Path(tempfile.mkdtemp(prefix="knnbench-"))
    path = tmp / "index.float3"
    points.tofile(path)
    box: dict = {}
    ready = threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    argv = [str(path), "-k", str(k), "--port", "0"]
    for key, value in _options(cfg, ("engine", "score_dtype")).items():
        argv += [f"--{key.replace('_', '-')}", str(value)]
    if device.type == "cpu":
        argv += ["--device", "cpu"]

    def serve():
        try:
            serve_main.main(argv, ready=on_ready)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            box["error"] = e
            ready.set()

    thread = threading.Thread(target=serve, name="knnbench-serve")
    thread.start()
    try:
        ready.wait()
        path.unlink()
        tmp.rmdir()
        if "error" in box:
            raise RuntimeError("the server did not start") from box["error"]
        yield box["server"], points
    finally:
        if "server" in box:
            box["server"].shutdown()
        thread.join()
        if path.exists():
            path.unlink()
            tmp.rmdir()
        box.clear()
        _free(device)


class OpenLoop:
    """``loadgen.py`` in a process of its own, ready to post ``mix`` at
    the server on ``port`` for ``seconds``."""

    def __init__(self, port: int, mix: dict, seconds: float, seed: int,
                 dim: int, sample: list[int]):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "knnbench.loadgen"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps({
            "host": "127.0.0.1", "port": port, "mix": mix,
            "seconds": seconds, "seed": seed, "dim": dim, "sample": sample,
            "workers": int(mix.get("workers", 64))}) + "\n")
        self.proc.stdin.flush()
        if self.proc.stdout.readline().strip() != "ready":
            self.close()
            raise RuntimeError("the load generator did not start")

    def go(self) -> dict:
        """Open the window; returns loadgen's result once it has closed."""
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()
        got = json.loads(self.proc.stdout.readline())
        self.proc.stdin.close()
        self.proc.wait(timeout=60)
        return got

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def open_loop_metrics(got: dict) -> dict:
    """p99 of every request (a failed one missing every limit) and the
    rows answered over the time to the last answer."""
    lat = [math.inf if v is None else v for v in got["latency_ms"]]
    p99 = _percentile(lat, 99.0)
    ok = [s == 200 for s in got["status"]]
    rows_ok = sum(r for r, good in zip(got["rows"], ok) if good)
    return {"served_p99_ms": p99 if math.isfinite(p99) else 1e9,
            "latency_ms": {f"p{q}": _percentile(lat, q)
                           for q in (50, 90, 95, 99)},
            "retried": sum(got["retried"]),
            "served_rows_per_s": (rows_ok / got["last_done_s"]
                                  if got["last_done_s"] else 0.0),
            "rows_ok": rows_ok, "failed": ok.count(False),
            "statuses": {str(c): got["status"].count(c)
                         for c in sorted(set(got["status"]))}}


def _numbers_of_answers(got: dict, sample: list[int], mix: dict, seed: int,
                        points: np.ndarray, dim: int, k: int, device
                        ) -> dict:
    """The sampled requests' answers against the reference over the
    whole index."""
    pts = torch.from_numpy(points).to(device)
    queries = [arrivals.request_queries(mix, seed, i, got["rows"][i], dim)
               for i in sample]
    want = reference.kth_distances(pts, torch.from_numpy(
        np.concatenate(queries)).to(device), k)
    del pts
    parts, lo = [], 0
    for i, q in zip(sample, queries):
        a = got["answers"].get(str(i))
        answer = (np.frombuffer(base64.b64decode(a), "<f4") if a
                  else np.zeros(0, np.float32))
        parts.append(reference.compare(answer, want[lo:lo + len(q)]))
        lo += len(q)
    return _worst(parts)


def _numeric(stats: dict) -> dict:
    return {k: float(v) for k, v in stats.items()
            if isinstance(v, (int, float))}


def run_serve(cell, seed: int, seconds: float, trace: bool, device,
              t_start: float) -> Run:
    mix, k = cell.traffic, int(cell.config["k"])
    dim = int(cell.config["points"]["dim"])
    _reset_peak(device)
    sched = arrivals.schedule(mix, seconds, seed)
    sample = arrivals.sampled_requests(sched, int(mix["sample_requests"]),
                                       seed)
    with serving(cell, seed, device) as (server, points):
        load = OpenLoop(server.server_address[1], mix, seconds, seed, dim,
                        sample)
        try:
            setup_s = time.perf_counter() - t_start
            b0 = _numeric(server.batcher.stats())
            tracer = devtrace.Tracer(trace)
            with tracer.window():
                got = load.go()
            b1 = _numeric(server.batcher.stats())
            tracer.close()
        finally:
            load.close()
        peak = _peak(device)
    # the reference, after the window and with the server gone
    numbers = _numbers_of_answers(got, sample, mix, seed, points, dim, k,
                                  device)
    m = open_loop_metrics(got)
    return Run(
        metrics={"served_p99_ms": m["served_p99_ms"],
                 "served_rows_per_s": m["served_rows_per_s"],
                 "setup_s": setup_s, "peak_device_mib": peak / 2**20},
        record={"requests": got["requests"], "rows_ok": m["rows_ok"],
                "dim": dim, "k": k, "schedule_s": got["schedule_s"],
                "last_done_s": got["last_done_s"],
                "dispatch_late_ms_max": got["dispatch_late_ms_max"],
                "latency_ms": m["latency_ms"], "retried": m["retried"],
                "batcher": _delta(b1, b0), "trace": tracer.summary},
        device=_device_info(device, 1, peak),
        checks=_check_limits(cell, numbers), attempted=got["requests"],
        failed=m["failed"])


# ------------------------------------------------------------------ ring


def free_port() -> int:
    """A free port below the kernel's ephemeral range: the other ranks'
    clients retry their connect before rank 0 listens, and a client whose
    own ephemeral port equals the store's can connect to itself and hold
    the store's port."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    first = 10000 + os.getpid() % max(1, low - 11000)
    for port in [*range(first, low), *range(10000, first)]:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def ring_rank(cell, seed: int, seconds: float, trace: bool, rank: int,
              world: int, port: int, device_type: str,
              t_start: float) -> dict:
    """One process of the ring cell: its block of every job, the window
    as rank 0 closes it, then the reference of its own sampled rows."""
    import torch.distributed as dist

    from mpi_cuda_largescaleknn_torch.models.sharding import pad_and_flatten
    from mpi_cuda_largescaleknn_torch.obs.timers import PhaseTimers
    from mpi_cuda_largescaleknn_torch.parallel.mesh import (
        Mesh,
        ShardRing,
        initialize_distributed,
    )
    from mpi_cuda_largescaleknn_torch.parallel.ring import ring_knn

    cfg, mix = cell.config, cell.traffic
    npr, k, spec = int(cfg["points_per_rank"]), int(cfg["k"]), cfg["points"]
    per_job = int(mix["sample_per_job"])
    marks = [("imports", time.perf_counter())]
    device, backend, _ = initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device=device_type)
    _reset_peak(device)
    mesh = Mesh(world, device)
    mesh.barrier()
    ShardRing(mesh, [(torch.zeros(1, device=device),)]).rotate()
    marks.append(("connect", time.perf_counter()))
    timers = PhaseTimers()
    flag = torch.zeros(2, dtype=torch.int32, device=device)

    def block(j):
        return data.host_points(spec, npr, device, seed, "job", j, rank)

    def job(pts):
        # as cli/multihost.py: this process's slab, padded to the slab size
        flat, flat_ids, _, _ = pad_and_flatten(
            [pts], id_bases=[rank * npr], dim=pts.shape[1], pad_to=npr)
        rows, _ = ring_knn(flat, flat_ids, k, world, mesh=mesh,
                           return_stats=True, timers=timers,
                           **_options(cfg, ("engine", "score_dtype")))
        return rows[rank].cpu().numpy()[:npr]

    warm = block(-1)
    marks.append(("warmup_points", time.perf_counter()))
    job(warm)  # set-up: builds and warms what the window's jobs use
    del warm
    mesh.barrier()
    marks.append(("warmup_job", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    before = _stages(timers)
    samples = []
    wall = 0.0
    tracer = devtrace.Tracer(trace, TRACE_SECONDS)
    while True:
        j = len(samples)
        pts = block(j)
        with tracer.window():
            t0 = time.perf_counter()
            out = job(pts)
            wall += time.perf_counter() - t0
        del pts
        idx = data.sample_rows(npr, per_job, seed, "sample", j, rank)
        samples.append((j, idx, out[idx] if len(out) == npr
                        else np.zeros(0, np.float32)))
        # rank 0's job time closes the window, and ends the trace, for
        # every rank at once
        flag[0], flag[1] = int(wall >= seconds), int(tracer.full)
        dist.broadcast(flag, 0)
        closed, traced_enough = flag.tolist()
        if traced_enough:
            tracer.stop()
        if closed:
            break
    tracer.close()
    jobs = len(samples)
    stages = _delta(_stages(timers), before)
    peak = _peak(device)
    mesh.barrier()
    dist.destroy_process_group()
    del mesh
    _free(device)
    parts = []
    for j, idx, got in samples:
        pts = torch.cat([data.draw_points(spec, npr, device, seed, "job", j,
                                          r) for r in range(world)])
        q = pts[rank * npr + torch.from_numpy(idx).to(device)]
        parts.append(reference.compare(got, reference.kth_distances(pts, q,
                                                                    k)))
        del pts, q
    return {"rank": rank, "backend": backend, "jobs": jobs, "window_s": wall,
            "setup_s": setup_s, "setup_parts": _setup_parts(t_start, marks),
            "peak": peak, "stages": stages,
            "trace": tracer.summary, "traced_jobs": tracer.stretches,
            "numbers": _worst(parts),
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")}


def ranks_summary(traces: list) -> dict | None:
    """Rank 0's trace summary with the card's busy and window seconds
    averaged over the ranks (each rank's busy share is over its own
    window); rank 0's window stays as ``window0_s`` for NCCL's share."""
    first = traces[0]
    if first is None or not all(traces):
        return first
    return dict(first, window0_s=first["window_s"],
                busy_s=sum(t["busy_s"] for t in traces) / len(traces),
                window_s=sum(t["window_s"] for t in traces) / len(traces))


def run_ring(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Run:
    world = int(cell.config["ranks"])
    port = free_port()
    args = {"workload": cell.name, "root": str(cell.root), "seed": seed,
            "seconds": seconds,
            "trace": trace, "world": world, "port": port,
            "device_type": device.type}
    procs = [subprocess.Popen(
        [sys.executable, "-m", RANK_MODULE, json.dumps(
            dict(args, rank=r))], cwd=ROOT, stdout=subprocess.PIPE,
        text=True) for r in range(1, world)]
    try:
        mine = ring_rank(cell, seed, seconds, trace, 0, world, port,
                         device.type, t_start)
        outs = []
        for p in procs:
            text, _ = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"a rank exited with {p.returncode}")
            outs.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [mine, *outs]
    peak = max(r["peak"] for r in ranks)
    n_total = int(cell.config["points_per_rank"]) * world
    summary = ranks_summary([r["trace"] for r in ranks])
    numbers = _worst([r["numbers"] for r in ranks])
    info = _device_info(device, world, peak)
    return Run(
        metrics={"selfjoin_points_per_s": n_total * mine["jobs"]
                 / mine["window_s"], "setup_s": mine["setup_s"],
                 "peak_device_mib": peak / 2**20},
        record={"jobs": mine["jobs"], "window_s": mine["window_s"],
                "points_per_job": n_total, "backend": mine["backend"],
                "dim": int(cell.config["points"]["dim"]),
                "k": int(cell.config["k"]), "stages": mine["stages"],
                "setup_parts": mine["setup_parts"],
                "trace": summary, "traced_jobs": mine["traced_jobs"]},
        device=info, checks=_check_limits(cell, numbers),
        attempted=mine["jobs"], failed=0)


def drive(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> Run:
    name = driver_of(cell.config, cell.traffic)
    if "pipeline" in cell.config:
        run = pipeline(name, cell.root).run
    else:
        run = {"jobs": run_jobs, "ring": run_ring, "open": run_serve}[name]
    return run(cell, seed, seconds, trace, device, t_start)
