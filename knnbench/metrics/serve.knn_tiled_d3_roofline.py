"""Share of the roofline the D=3 kernels reach at served shapes: the least
time of the rows the batcher served in the window (``knnbench/roofline.py``
``served_work``) over the profiled device time of every kernel named
``knn_tiled_d3*``."""

from knnbench import devtrace, roofline


def read(record: dict) -> float | None:
    rows = record.get("batcher", {}).get("rows_served")
    if not rows:
        return None
    seconds = devtrace.kernel_seconds(record.get("trace"), "knn_tiled_d3")
    return roofline.roofline_share(
        roofline.served_work(int(rows), record["dim"], record["k"]), seconds)
