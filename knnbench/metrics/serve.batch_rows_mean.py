"""Query rows in a batch the batcher (``serve/batcher.py``) dispatched in
the window: the change of its ``rows_served`` over that of ``batches``."""


def read(record: dict) -> float | None:
    b = record.get("batcher", {})
    return b["rows_served"] / b["batches"] if b.get("batches") else None
