"""Device seconds a self-join job spends ordering the point buckets by box
distance for the traversal (``ops/partition.py`` ``nearest_first_order``
under ``ops/knn_tiled.py``): the device span ``box_order`` of every fold,
timed by CUDA event pairs and settled at the end of the ring driver's
stage, over the window's jobs (rank 0's in a ring cell)."""


def read(record: dict) -> float | None:
    s = record.get("stages", {}).get("box_order")
    return s / record["jobs"] if s is not None and record.get("jobs") else None
