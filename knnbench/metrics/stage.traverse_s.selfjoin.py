"""Seconds a self-join job spends in the ring driver's ``traverse`` stage
(``parallel/ring.py``: the rounds' kernels and the rotations), from its
stage timers, over the window's jobs (rank 0's in a ring cell)."""


def read(record: dict) -> float | None:
    s = record.get("stages", {}).get("traverse")
    return s / record["jobs"] if s is not None and record.get("jobs") else None
