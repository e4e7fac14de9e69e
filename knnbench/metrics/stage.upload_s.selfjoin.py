"""Seconds a self-join job spends in the ring driver's ``upload`` stage
(``parallel/ring.py``: the padded host input onto the card, ended by a
synchronisation), from its stage timers, over the window's jobs (rank 0's
in a ring cell)."""


def read(record: dict) -> float | None:
    s = record.get("stages", {}).get("upload")
    return s / record["jobs"] if s is not None and record.get("jobs") else None
