"""The source's pre-partitioned job (``cudaMpiKNN_prePartitionedData``):
one spatially coherent partition a rank, every point's distance to its
k-th nearest point of the union of all partitions, one output a partition.

Each job is ``PrePartitionedKNN(KnnConfig(k=..., engine=...,
num_shards=0)).run(parts)`` on the configuration's ``ranks`` host f32
arrays, as a user's files arrive: every partition a virtual shard on the
one card, the bounds-pruned early-exit ring of ``parallel/demand.py``
between them. Drawing a job's partitions is not timed.

The layout (``partition_box``, ``draw_union``): partition i of R draws
its points uniformly with x in [i w (1 - o), i w (1 - o) + w), w = 1 /
((R - 1)(1 - o) + 1), and every other component in [0, 1), o the
configuration's ``overlap``; at o = 0.5 each partition overlaps each
neighbour's by half its width. A job's union is one seeded uniform draw
from (seed, "job", j), mapped partition by partition in partition order,
so the reference draws it again after the window.

``correct``: after the window, with the port freed, ``reference.py``
works out again ``sample_per_job`` rows of each job's union, drawn from
the seed; each row is read from its partition's output at its row there.

The control (``control.py`` cannot draw this layout):

    python3 -m knnbench.pipelines.prepartitioned \\
        --workload selfjoin-3d-k500-prepart --seeds 1 2 3 [--samples 1024]

prints one JSON line a seed: job 0's union, ``--samples`` of its rows,
the reference in ``control_precision`` against float64, each compared
number beside the cell's limit. It runs the reference only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from knnbench import data, devtrace, drivers, reference

#: the configuration keys and the mix keys this pipeline reads
READS = ({"points", "points_per_rank", "ranks", "points_total", "k",
          "engine", "control_precision", "overlap"},
         {"loop", "sample_per_job"})
#: the port's counters a job's record carries the window's change of
COUNTER_PREFIX = "demand_"
#: the phases a job's time is made of (``PrePartitionedKNN.timers``: the
#: model's host phases and the demand ring's stages), for
#: ``tools/torch_span_breakdown.py``
JOB_PHASES = ("pad", "upload", "partition", "init", "traverse", "final",
              "extract")


def check(name: str, config: dict, traffic: dict) -> None:
    ranks, npr = int(config["ranks"]), int(config["points_per_rank"])
    if int(config["points_total"]) != ranks * npr:
        raise ValueError(f"{name}: points_total is not ranks x "
                         f"points_per_rank")
    if not 0 <= float(config["overlap"]) < 1:
        raise ValueError(f"{name}: overlap must lie in [0, 1)")
    points = config["points"]
    if points["kind"] != "uniform" or int(points["dim"]) != 3:
        raise ValueError(f"{name}: the partitions are uniform float3 "
                         f"points")
    if traffic["loop"] != "jobs":
        raise ValueError(f"{name}: the pre-partitioned job runs jobs "
                         f"back to back")


def partition_box(i: int, ranks: int, overlap: float) -> tuple:
    """(lower, upper) of partition ``i``'s x, and its width."""
    width = 1.0 / ((ranks - 1) * (1.0 - overlap) + 1.0)
    lower = i * width * (1.0 - overlap)
    return lower, lower + width, width


def draw_union(cfg: dict, device, seed: int, *parts) -> torch.Tensor:
    """f32[ranks * points_per_rank, 3] on ``device``: every partition's
    points, partition after partition."""
    ranks, npr = int(cfg["ranks"]), int(cfg["points_per_rank"])
    overlap = float(cfg["overlap"])
    pts = data.draw_points(cfg["points"], ranks * npr, device, seed, *parts)
    _, _, width = partition_box(0, ranks, overlap)
    lower = torch.tensor([partition_box(i, ranks, overlap)[0]
                          for i in range(ranks)], dtype=torch.float32,
                         device=device)
    pts[:, 0].mul_(width).add_(lower.repeat_interleave(npr))
    return pts


def host_parts(cfg: dict, device, seed: int, *parts) -> list[np.ndarray]:
    """``draw_union`` on the host, cut into its partitions."""
    union = draw_union(cfg, device, seed, *parts).cpu().numpy()
    npr = int(cfg["points_per_rank"])
    return [union[i * npr:(i + 1) * npr] for i in range(int(cfg["ranks"]))]


def union_rows(out: list, rows: np.ndarray, npr: int) -> np.ndarray:
    """The answers of the union's ``rows`` from the per-partition outputs
    (row r is row r % npr of partition r // npr); empty where the outputs
    are not one array of npr rows a partition."""
    if any(len(o) != npr for o in out):
        return np.zeros(0, np.float32)
    return np.array([out[r // npr][r % npr] for r in rows], np.float32)


def model(cfg: dict, device):
    from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
    from mpi_cuda_largescaleknn_torch.models.prepartitioned import (
        PrePartitionedKNN,
    )

    return PrePartitionedKNN(KnnConfig(
        k=int(cfg["k"]), num_shards=0, device=str(device),
        **drivers._options(cfg, ("engine",))))


def _counters(timers) -> dict:
    return {k: v for k, v in timers.counters.items()
            if k.startswith(COUNTER_PREFIX)}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> drivers.Run:
    marks = [("imports", time.perf_counter())]
    cfg, mix = cell.config, cell.traffic
    ranks, npr, k = (int(cfg["ranks"]), int(cfg["points_per_rank"]),
                     int(cfg["k"]))
    n = ranks * npr
    per_job = int(mix["sample_per_job"])
    drivers._reset_peak(device)
    knn = model(cfg, device)
    marks.append(("port_and_device", time.perf_counter()))
    warm = host_parts(cfg, device, seed, "warmup", 0)
    marks.append(("warmup_points", time.perf_counter()))
    # set-up: one job on points of its own builds and warms every kernel
    # and shape the window's jobs use
    knn.run(warm)
    drivers._sync(device)
    del warm
    marks.append(("warmup_job", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    before = drivers._stages(knn.timers)
    counted = _counters(knn.timers)
    rounds = folds = 0
    samples = []
    wall = 0.0
    tracer = devtrace.Tracer(trace, drivers.TRACE_SECONDS)
    while wall < seconds:
        j = len(samples)
        parts = host_parts(cfg, device, seed, "job", j)
        with tracer.window():
            t0 = time.perf_counter()
            out = knn.run(parts)
            wall += time.perf_counter() - t0
        if tracer.full:
            tracer.stop()
        del parts
        rounds += knn.last_stats["rounds"]
        folds += sum(knn.last_stats["kernels_run"])
        idx = data.sample_rows(n, per_job, seed, "sample", j)
        samples.append((j, idx, union_rows(out, idx, npr)))
    tracer.close()
    jobs = len(samples)
    stages = drivers._delta(drivers._stages(knn.timers), before)
    demand = {"rounds": rounds, "folds": folds,
              **drivers._delta(_counters(knn.timers), counted)}
    peak = drivers._peak(device)
    del knn
    drivers._free(device)
    parts = []
    for j, idx, got in samples:
        pts = draw_union(cfg, device, seed, "job", j)
        want = reference.kth_distances(pts, pts[torch.from_numpy(idx)
                                                 .to(device)], k)
        parts.append(reference.compare(got, want))
        del pts
    numbers = drivers._worst(parts)
    return drivers.Run(
        metrics={"selfjoin_points_per_s": n * jobs / wall,
                 "setup_s": setup_s, "peak_device_mib": peak / 2**20},
        record={"jobs": jobs, "window_s": wall, "points_per_job": n,
                "dim": int(cfg["points"]["dim"]), "k": k, "ranks": ranks,
                "stages": stages, "demand": demand,
                "setup_parts": drivers._setup_parts(t_start, marks),
                "trace": tracer.summary, "traced_jobs": tracer.stretches},
        device=drivers._device_info(device, 1, peak),
        checks=drivers._check_limits(cell, numbers), attempted=jobs,
        failed=0)


def control(cell, seed: int, precision: str | None = None,
            samples: int = 1024, device=None) -> dict:
    """The control's numbers on job 0's union, each beside the cell's
    limit: the reference in ``precision`` (the configuration's
    ``control_precision``) against float64."""
    cfg = cell.config
    device = device or torch.device("cuda", 0)
    n, k = int(cfg["ranks"]) * int(cfg["points_per_rank"]), int(cfg["k"])
    pts = draw_union(cfg, device, seed, "job", 0)
    idx = data.sample_rows(n, samples, seed, "sample", 0)
    q = pts[torch.from_numpy(idx).to(device)]
    want = reference.kth_distances(pts, q, k)
    got = reference.kth_distances(
        pts, q, k, precision=precision or cfg["control_precision"])
    numbers = reference.compare(got.astype(np.float32), want)
    return {name: {"value": v, "limit": float(cell.check[name])}
            for name, v in numbers.items()}


def main(argv=None) -> int:
    from knnbench.spec import load_cell

    p = argparse.ArgumentParser(description="the bf16 control of a "
                                "pre-partitioned cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--samples", type=int, default=1024)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        out = control(cell, seed, samples=args.samples)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control_precision"],
                          "checks": out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
