"""What the card did in a traced window, read from ``torch.profiler``.

A frozen copy of the port's ``obs/trace.py`` ``device_summary`` (the union
of the card's kernel and copy intervals, and device time by kernel name),
extended for the benchmark: the window is the stretches marked by a
``record_function`` named ``WINDOW``, the card's intervals (without the
device-side copies of host marks) are clipped to them, and the idle gaps
between them are labelled by the host operation that began last before
each gap. Imports torch only: nothing of the port.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

WINDOW = "knnbench.window"
#: idle stretches shorter than this are launch gaps, not idle time worth a
#: label (they still count as idle)
MIN_GAP_US = 20.0


class Tracer:
    """Profiles the card and the host over the stretches of a window that
    ``window()`` marks. ``full`` says when ``limit_s`` seconds of them
    have been traced (never, with None); the caller then calls ``stop``,
    which ends the profile without reading it (the ranks of a ring stop
    together, so that none waits on another's reading), and after its
    window ``close``, which reads the trace into ``summary``. Off, it marks
    nothing. ``stretches`` counts the stretches traced."""

    def __init__(self, enabled: bool, limit_s: float | None = None):
        self.limit_s = limit_s
        self.stretches = 0
        self.traced_s = 0.0
        self.summary = None
        self._prof = None
        self._done = None
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    @contextlib.contextmanager
    def window(self):
        if self._prof is None:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield
        self.traced_s += time.perf_counter() - t0
        self.stretches += 1

    @property
    def full(self) -> bool:
        return (self._prof is not None and self.limit_s is not None
                and self.traced_s >= self.limit_s)

    def stop(self) -> None:
        if self._prof is not None:
            self._done, self._prof = self._prof, None
            self._done.__exit__(None, None, None)

    def close(self) -> None:
        self.stop()
        if self._done is not None:
            self.summary = summarize(self._done)
            self._done = None


def _union(pieces):
    out = []
    for a, b in sorted(pieces):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict | None:
    """``{"window_s", "busy_s", "kernels": {name: seconds}, "idle_gaps":
    [[host op, seconds], ...]}`` over the traced window, the stretches
    marked by ``window``; None when the trace holds no device time (no
    card, or a profiler that could not trace it)."""
    from torch.autograd import DeviceType

    events = prof.events()
    wins = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == WINDOW and e.device_type != DeviceType.CUDA)
    if not wins:
        return None
    w_starts = [a for a, _ in wins]
    pieces, kernels, host = [], {}, []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # marks such as the window's or NCCL's ``nccl:coalesced`` are
            # copies of host spans on the device's timeline, not its work
            if e.name == WINDOW or getattr(e, "is_user_annotation", False):
                continue
            i = max(0, bisect.bisect_right(w_starts, a) - 1)
            while i < len(wins) and wins[i][0] < b:
                lo, hi = max(a, wins[i][0]), min(b, wins[i][1])
                if hi > lo:
                    pieces.append((lo, hi))
                    kernels[e.name] = kernels.get(e.name, 0.0) + (hi - lo) / 1e6
                i += 1
        elif e.name != WINDOW:
            host.append((a, e.name))
    if not pieces:
        return None
    host.sort()
    starts = [a for a, _ in host]
    busy = _union(pieces)
    gaps: dict[str, float] = {}

    def gap(a, b):
        if b - a < MIN_GAP_US:
            return
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        label = host[i][1] if i >= 0 else "no host op"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6

    j = 0
    for w0, w1 in wins:
        end = w0
        while j < len(busy) and busy[j][0] < w1:
            a, b = busy[j]
            if a > end:
                gap(end, a)
            end = max(end, b)
            j += 1
        gap(end, w1)
    return {"window_s": sum(b - a for a, b in wins) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": kernels,
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])}


def kernel_seconds(summary: dict | None, *needles: str) -> float:
    """Device seconds of the kernels whose names hold any of ``needles``."""
    if not summary:
        return 0.0
    return sum(s for name, s in summary["kernels"].items()
               if any(n in name for n in needles))


def breakdown(summary: dict | None, top: int = 10) -> dict | None:
    if not summary:
        return None
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": summary["idle_gaps"][:top]}
