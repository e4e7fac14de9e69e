"""torch.profiler integration (opt-in, see ``KnnConfig.profile_dir``).

``profile_trace`` wraps a region, as the JAX package's ``jax.profiler``
trace does, and writes a Chrome trace (open it in Perfetto or
chrome://tracing). ``device_summary`` reads from the same profiler how
busy the card was and which kernels took its time.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def profile_trace(profile_dir: str | None):
    """Profile the region when a directory is given: host operators, and
    the card's kernels and copies where there is a card. On a normal exit
    the trace goes to ``<profile_dir>/trace-<time>-<pid>.json``. Yields
    the profiler (``None`` without a directory).

    The trace also holds the program's phases as ``lsk.<phase>`` spans
    (``obs/timers.py``), each enclosing the host operators, kernel
    launches and idle gaps of its phase:

    - ``lsk.shard_and_pad``, ``lsk.ring``, ``lsk.download``, ``lsk.trim``:
      ``UnorderedKNN.run``'s host padding, the ring, the distances' copy
      to the host, and the cut back to the input's rows;
    - ``lsk.upload``, ``lsk.partition``, ``lsk.warm_start``,
      ``lsk.traverse``, ``lsk.extract``, ``lsk.chunks``: the ring
      driver's stages (``parallel/ring.py``): the input onto the card,
      the buckets, each query's own bucket, the rounds, the final rows,
      and a chunked run's loop;
    - ``lsk.box_order``: each traversal's nearest-first order of the point
      buckets (``ops/partition.py`` ``nearest_first_order``) under the
      ring's folds;
    - serving's ``lsk.index_build``, ``lsk.compile_q<rows>``,
      ``lsk.morton_sort``, ``lsk.host_merge``; the pre-partitioned
      pipeline's ``lsk.pad``, ``lsk.demand_ring`` and its stages."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    prof.export_chrome_trace(str(out / f"trace-{stamp}-{os.getpid()}.json"))


def device_summary(prof, seconds: float, top: int = 5) -> dict:
    """What the card did in a profiled window of ``seconds`` (host clock):
    ``device_seconds``, the union of its kernel and copy intervals;
    ``busy_share``, that over ``seconds``; ``top``, the ``top`` kernels by
    device time ({"name", "ms", "calls"}). Both figures are None, and
    ``top`` empty, when the trace holds no device time (no card, or a
    profiler that could not trace it)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if busy_us <= 0:
        return {"device_seconds": None, "busy_share": None, "top": []}
    kernels = []
    for avg in prof.key_averages():
        if avg.device_type != DeviceType.CUDA:
            continue
        us = getattr(avg, "self_device_time_total", None)
        if us is None:
            us = avg.self_cuda_time_total
        kernels.append({"name": avg.key, "ms": us / 1e3, "calls": avg.count})
    kernels.sort(key=lambda r: -r["ms"])
    return {"device_seconds": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / seconds if seconds > 0 else None,
            "top": kernels[:top]}
