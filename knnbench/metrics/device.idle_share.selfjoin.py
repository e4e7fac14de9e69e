"""Percent of the traced self-join window in which no operation ran on the
card (averaged over the cards of a ring cell)."""


def read(record: dict) -> float | None:
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
