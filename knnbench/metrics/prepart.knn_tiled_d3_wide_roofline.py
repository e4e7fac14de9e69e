"""Share of the roofline the D=3 wide fold (``knn_tiled_d3_wide_kernel``,
k above 128: the demand ring's folds and the warm start's visit) reaches
in a pre-partitioned job: the least time of the traced jobs' self-join
(``knnbench/roofline.py`` ``selfjoin_work`` of the union's points) over
the profiled device time of the kernels named ``knn_tiled_d3_wide``."""

from knnbench import devtrace, roofline


def read(record: dict) -> float | None:
    seconds = devtrace.kernel_seconds(record.get("trace"),
                                      "knn_tiled_d3_wide")
    if not seconds:
        return None
    work = roofline.selfjoin_work(record["points_per_job"], record["dim"],
                                  record["k"])
    jobs = record["traced_jobs"]
    return roofline.roofline_share(
        {key: v * jobs for key, v in work.items()}, seconds)
