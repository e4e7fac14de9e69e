"""Seconds a self-join job spends in the ring driver's ``warm_start``
stage (``ops/tiled.py`` ``warm_start_self`` under ``parallel/ring.py``),
from the stage timers ``UnorderedKNN.timers`` keeps, over the window's
jobs."""


def read(record: dict) -> float | None:
    s = record.get("stages", {}).get("warm_start")
    return s / record["jobs"] if s is not None and record.get("jobs") else None
