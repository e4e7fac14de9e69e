"""Folds a shard runs in a pre-partitioned job: the window's sum of
``PrePartitionedKNN.last_stats``' ``kernels_run`` over the jobs and the
shards (ranks). The pruning's work: the demand ring folds an arriving
shard only while its box lies within the shard's worst k-th radius."""


def read(record: dict) -> float | None:
    folds = record.get("demand", {}).get("folds")
    if folds is None or not record.get("jobs") or not record.get("ranks"):
        return None
    return folds / (record["jobs"] * record["ranks"])
