"""Share of the roofline the D=3 kernels reach in a self-join: the least
time of the traced jobs (``knnbench/roofline.py`` ``selfjoin_work``)
over the profiled device time of every kernel named ``knn_tiled_d3*``."""

from knnbench import devtrace, roofline


def read(record: dict) -> float | None:
    seconds = devtrace.kernel_seconds(record.get("trace"), "knn_tiled_d3")
    if not seconds:
        return None
    work = roofline.selfjoin_work(record["points_per_job"], record["dim"],
                                  record["k"])
    jobs = record["traced_jobs"]
    return roofline.roofline_share(
        {key: v * jobs for key, v in work.items()}, seconds)
