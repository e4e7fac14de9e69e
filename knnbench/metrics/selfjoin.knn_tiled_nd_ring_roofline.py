"""Share of the roofline the ring kernel (``knn_tiled_nd_ring_kernel``,
D other than 3) reaches in a self-join: the least time of the traced
jobs (``knnbench/roofline.py`` ``selfjoin_work``) over its profiled device
time."""

from knnbench import devtrace, roofline


def read(record: dict) -> float | None:
    seconds = devtrace.kernel_seconds(record.get("trace"),
                                      "knn_tiled_nd_ring")
    if not seconds:
        return None
    work = roofline.selfjoin_work(record["points_per_job"], record["dim"],
                                  record["k"])
    jobs = record["traced_jobs"]
    return roofline.roofline_share(
        {key: v * jobs for key, v in work.items()}, seconds)
