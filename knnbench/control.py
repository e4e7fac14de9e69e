"""The control of a cell's check: the plain reference put in the port's
place, computed in the precision below the one the configuration states
(``control_precision``: bfloat16 for the elementwise float32 of D=3, TF32
for the matrix-product float32 of high D), and judged by the same
comparison as a run. It has to come out as not correct.

    python3 -m knnbench.control --workload selfjoin-3d-k100 --seeds 1 2 3

Prints one JSON line a seed: each compared number beside the cell's limit.
At the cell's own size: job 0's points (all ranks' blocks in a ring cell,
rank 0's rows checked), ``--samples`` of its rows; or for a serving cell
the index and the requests a run of ``run_seconds`` samples. Runs the
reference only, so one card does for every cell. The benchmark's runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from knnbench import arrivals, data, reference
from knnbench.spec import load_cell


def control_numbers(cell, seed: int, device, samples: int = 1024,
                    seconds: float | None = None,
                    precision: str | None = None) -> dict:
    cfg, mix = cell.config, cell.traffic
    npr, k, spec = int(cfg["points_per_rank"]), int(cfg["k"]), cfg["points"]
    precision = precision or cfg["control_precision"]
    if mix["loop"] == "open":
        pts = data.draw_points(spec, npr, device, seed, "index", 0)
        sched = arrivals.schedule(mix, seconds, seed)
        q = np.concatenate([
            arrivals.request_queries(mix, seed, i, sched["rows"][i],
                                     int(spec["dim"]))
            for i in arrivals.sampled_requests(
                sched, int(mix["sample_requests"]), seed)])
        q = torch.from_numpy(q).to(device)
    else:
        ranks = int(cfg.get("ranks", 1))
        parts = ([data.draw_points(spec, npr, device, seed, "job", 0, r)
                  for r in range(ranks)] if ranks > 1 else
                 [data.draw_points(spec, npr, device, seed, "job", 0)])
        pts = torch.cat(parts)
        del parts
        idx = data.sample_rows(npr, samples, seed, "sample", 0,
                               *((0,) if ranks > 1 else ()))
        q = pts[torch.from_numpy(idx).to(device)]
    want = reference.kth_distances(pts, q, k)
    got = reference.kth_distances(pts, q, k, precision=precision)
    numbers = reference.compare(got.astype(np.float32), want)
    return {name: {"value": v, "limit": float(cell.check[name])}
            for name, v in numbers.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--samples", type=int, default=1024)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    with open(cell.root / "BENCHMARK.json") as f:
        seconds = float(json.load(f)["run_seconds"])
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        out = control_numbers(cell, seed, device, args.samples, seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control_precision"],
                          "checks": out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
