"""Host seconds a self-join job spends in ``UnorderedKNN.run``
(``models/unordered.py``) around the ring: its phases ``shard_and_pad``
(the host padding), ``download`` (the distances' copy to the host) and
``trim``, from the timers ``UnorderedKNN.timers`` keeps, over the window's
jobs. None where any of the three is missing (a ring cell's ranks call
``ring_knn`` themselves)."""

PHASES = ("shard_and_pad", "download", "trim")


def read(record: dict) -> float | None:
    stages = record.get("stages", {})
    if not record.get("jobs") or any(p not in stages for p in PHASES):
        return None
    return sum(stages[p] for p in PHASES) / record["jobs"]
