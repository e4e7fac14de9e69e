"""Percent of rank 0's traced window that NCCL's kernels (the ring's
rotations and the collectives of ``parallel/mesh.py``) held its card, from
the profiled device time of kernels named ``nccl*``."""

from knnbench import devtrace


def read(record: dict) -> float | None:
    t = record.get("trace")
    if not t:
        return None
    window = t.get("window0_s", t["window_s"])
    return 100.0 * devtrace.kernel_seconds(t, "nccl") / window if window > 0 \
        else None
