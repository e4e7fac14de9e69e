"""Host reads of a shard's worst radius in a pre-partitioned job: the
change of the counter ``demand_radius_reads`` (``parallel/demand.py``)
over the window, a job. Each read is a wait of the round loop on the
card. None where the port keeps no such counter."""


def read(record: dict) -> float | None:
    reads = record.get("demand", {}).get("demand_radius_reads")
    if reads is None or not record.get("jobs"):
        return None
    return reads / record["jobs"]
