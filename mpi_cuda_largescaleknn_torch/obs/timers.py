"""Phase timers, counters, gauges and latency histograms.

The port of the JAX package's ``obs/timers.py``: wall-clock per named
phase, monotonic counters, point-in-time gauges, and log-bucketed latency
histograms (p50/p95/p99) shared by ``--timings`` and the serving layer's
``/stats`` and ``/metrics``. A phase that runs device work must end in a
synchronisation (the ring's stages do) for its time to cover that work.

While ``torch.profiler`` records, each phase and device span is also a
``record_function`` named ``lsk.<phase>``, so a trace nests the card's
kernels and idle gaps under the program phase that launched them; without
a profiler a phase costs one flag check more. The module imports torch
only when a profiler or a device span needs it (the load generator
imports it without torch).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import sys
import threading
import time
from dataclasses import dataclass, field

# shared histogram geometry, so every histogram renders identical /metrics
# buckets: geometric buckets, ~12% relative resolution, [1 us, 120 s]
_HIST_FACTOR = 2 ** 0.1665
_HIST_BOUNDS: list[float] = [
    1e-6 * _HIST_FACTOR ** i
    for i in range(int(math.log(120.0 / 1e-6, _HIST_FACTOR)) + 2)
]


class LatencyHistogram:
    """Log-bucketed latency histogram with bounded memory: an observation
    beyond the top bound lands in a +inf overflow bucket; a percentile is
    the matched bucket's upper bound (conservative by at most one bucket).
    ``record`` is thread-safe."""

    _BOUNDS = _HIST_BOUNDS

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = [0] * (len(self._BOUNDS) + 1)
        self.count = 0
        self.sum_seconds = 0.0

    def record(self, seconds: float) -> None:
        b = bisect.bisect_left(self._BOUNDS, seconds)
        with self._lock:
            self.counts[b] += 1
            self.count += 1
            self.sum_seconds += seconds

    def percentile(self, p: float) -> float:
        """Latency (seconds) at quantile ``p`` in [0, 100]; nan when empty."""
        if self.count == 0:
            return float("nan")
        rank = max(1, math.ceil(self.count * p / 100.0))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return (self._BOUNDS[i] if i < len(self._BOUNDS)
                        else float("inf"))
        return float("inf")

    def report(self) -> dict:
        def q(p: float):
            # None, not nan/inf: /stats is strict JSON
            v = self.percentile(p)
            return round(v, 6) if math.isfinite(v) else None

        return {"count": self.count,
                "sum_seconds": round(self.sum_seconds, 6),
                "p50": q(50), "p95": q(95), "p99": q(99)}

    def prometheus_lines(self, name: str) -> list[str]:
        """Prometheus-text histogram (cumulative ``le`` buckets); empty
        buckets are elided."""
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for i, c in enumerate(self.counts[:-1]):
            cum += c
            if c:
                lines.append(
                    f'{name}_bucket{{le="{self._BOUNDS[i]:.6g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum {self.sum_seconds:.6g}")
        lines.append(f"{name}_count {self.count}")
        return lines


def labeled_metric_lines(name: str, rows, kind: str = "counter"):
    """One Prometheus text-format metric family with labels: ``rows`` is
    an iterable of ``(labels_dict, value)`` pairs, emitted in the
    caller's order (callers iterate sorted snapshots, so scrapes are
    deterministic); no rows, no lines. One place owns the label
    quoting (the wire codecs' traffic, serve/wire.py)."""
    rows = list(rows)
    if not rows:
        return []
    lines = [f"# TYPE {name} {kind}"]
    for labels, value in rows:
        lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
        lines.append(f"{name}{{{lab}}} {value}")
    return lines


def profiling() -> bool:
    """A ``torch.profiler`` records in this process (never before torch
    is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


@contextlib.contextmanager
def profiled(name: str):
    """``record_function(name)`` while a profiler records, else nothing."""
    if not profiling():
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


class EventPairs:
    """CUDA event pairs recorded on the current stream around device work
    the host does not wait for; ``settle`` reads the pairs that have
    finished, so timing them adds no synchronisation. Thread-safe: a
    ``/stats`` reader may settle while a worker records."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list = []

    @contextlib.contextmanager
    def span(self, key):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        with self._lock:
            self._pending.append((key, start, end))

    def settle(self, wait: bool = False) -> list[tuple[object, float]]:
        """(key, seconds) of each pair finished since the last call, in
        record order; with ``wait`` every pair, waiting for those still
        running."""
        with self._lock:
            pending, self._pending = self._pending, []
        done, keep = [], []
        for key, start, end in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((key, start, end))
                continue
            done.append((key, start.elapsed_time(end) / 1e3))
        if keep:
            with self._lock:
                self._pending[:0] = keep
        return done


@dataclass
class PhaseRecord:
    seconds: float = 0.0
    calls: int = 0
    bytes_moved: int = 0

    @property
    def gb_per_sec(self) -> float:
        return (self.bytes_moved / self.seconds / 1e9) if self.seconds else 0.0


@dataclass
class PhaseTimers:
    phases: dict[str, PhaseRecord] = field(default_factory=dict)
    histograms: dict[str, LatencyHistogram] = field(default_factory=dict)
    gauges: dict[str, float] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)
    _counter_lock: threading.Lock = field(default_factory=threading.Lock,
                                          repr=False)
    _events: EventPairs = field(default_factory=EventPairs, repr=False)

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0):
        """Time a phase; ``bytes_moved`` (the ring's rotated bytes) gives
        its report a ``GB/s``. Under a profiler it is the span
        ``lsk.<name>``."""
        rec = self.phases.setdefault(name, PhaseRecord())
        t0 = time.perf_counter()
        try:
            with profiled(f"lsk.{name}"):
                yield rec
        finally:
            rec.seconds += time.perf_counter() - t0
            rec.calls += 1
            rec.bytes_moved += bytes_moved

    @contextlib.contextmanager
    def device_span(self, name: str, device):
        """Time device work the host does not wait for: on the card a CUDA
        event pair on the current stream, folded into ``phases[name]`` by
        ``settle``; on the CPU the host clock, at once. Under a profiler
        it is the span ``lsk.<name>`` as well."""
        if device.type != "cuda":
            with self.phase(name):
                yield
            return
        with profiled(f"lsk.{name}"), self._events.span(name):
            yield

    def settle(self) -> None:
        """Fold the finished device spans into their phases' seconds and
        calls (all of them after a synchronisation)."""
        for name, seconds in self._events.settle():
            rec = self.phases.setdefault(name, PhaseRecord())
            rec.seconds += seconds
            rec.calls += 1

    def hist(self, name: str) -> LatencyHistogram:
        """Named latency histogram (created on first use), reported beside
        the phases."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = LatencyHistogram()
        return h

    def gauge(self, name: str, value: float) -> None:
        """Point-in-time gauge: last writer wins."""
        self.gauges[name] = float(value)

    def count(self, name: str, by: int = 1) -> None:
        """Monotonic counter; increments from concurrent threads must not
        lose updates, hence the lock."""
        with self._counter_lock:
            self.counters[name] = self.counters.get(name, 0) + int(by)

    def counter(self, name: str) -> int:
        with self._counter_lock:
            return self.counters.get(name, 0)

    def report(self) -> dict:
        # list() snapshots: a /stats scrape may race a worker thread adding
        # a phase or a histogram
        out = {name: {"seconds": round(r.seconds, 6), "calls": r.calls,
                      **({"GB/s": round(r.gb_per_sec, 3)}
                         if r.bytes_moved else {})}
               for name, r in list(self.phases.items())}
        for name, h in list(self.histograms.items()):
            out[name] = h.report()
        for name, v in list(self.gauges.items()):
            out[name] = v
        with self._counter_lock:
            out.update(self.counters)
        return out

    def dump(self) -> str:
        return json.dumps(self.report())
