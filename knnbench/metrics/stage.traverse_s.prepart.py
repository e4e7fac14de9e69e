"""Seconds a pre-partitioned job spends in the demand ring's ``traverse``
stage (``parallel/demand.py``: the rounds' folds, radius reads and
rotations), from ``PrePartitionedKNN.timers``, over the window's jobs."""


def read(record: dict) -> float | None:
    s = record.get("stages", {}).get("traverse")
    return s / record["jobs"] if s is not None and record.get("jobs") else None
