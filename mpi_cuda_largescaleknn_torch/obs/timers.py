"""Phase timers, counters, gauges and latency histograms.

The port of the JAX package's ``obs/timers.py``: wall-clock per named
phase, monotonic counters, point-in-time gauges, and log-bucketed latency
histograms (p50/p95/p99) shared by ``--timings`` and the serving layer's
``/stats`` and ``/metrics``. A phase that runs device work must end in a
synchronisation (the ring's stages do) for its time to cover that work.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
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

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0):
        """Time a phase; ``bytes_moved`` (the ring's rotated bytes) gives
        its report a ``GB/s``."""
        rec = self.phases.setdefault(name, PhaseRecord())
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec.seconds += time.perf_counter() - t0
            rec.calls += 1
            rec.bytes_moved += bytes_moved

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
