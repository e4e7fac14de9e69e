"""Find a serving cell's knee: the highest offered rate with no growing
backlog. Run once, on the card, when the cell is defined; the cell then
fixes its rate as a number.

    python3 -m knnbench.sweep --workload <serving cell> --seed 7 \
        --seconds 20 --rates 20 30 40 50 60

Starts the cell's server once, then offers its mix at each rate in turn
for ``--seconds`` and prints one JSON line a rate: p50 and p99, rows
answered a second against rows offered, how long after the schedule's end
the last answer came (``tail_s``), and the median latency of the last
quarter of requests over that of the first (``drift``, near 1 without a
backlog, growing with one).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from knnbench import arrivals
from knnbench.drivers import OpenLoop, open_loop_metrics, serving
from knnbench.spec import load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    dim = int(cell.config["points"]["dim"])
    device = torch.device("cuda", 0)
    with serving(cell, args.seed, device) as (server, _):
        for i, rate in enumerate(args.rates):
            mix = dict(cell.traffic, rate_per_s=rate)
            seed = args.seed + 1 + i
            load = OpenLoop(server.server_address[1], mix, args.seconds,
                            seed, dim, [])
            try:
                got = load.go()
            finally:
                load.close()
            m = open_loop_metrics(got)
            lat = [v for v in got["latency_ms"] if v is not None]
            q = max(1, len(lat) // 4)
            sched = arrivals.schedule(mix, args.seconds, seed)
            print(json.dumps({
                "rate_per_s": rate, "requests": got["requests"],
                "failed": m["failed"], "statuses": m["statuses"],
                "retried": m["retried"], "latency_ms": m["latency_ms"],
                "rows_per_s": m["served_rows_per_s"],
                "offered_rows_per_s": float(sched["rows"].sum())
                / got["schedule_s"],
                "tail_s": (got["last_done_s"] or 0.0) - got["schedule_s"],
                "drift": statistics.median(lat[-q:])
                / statistics.median(lat[:q]) if lat else None,
                "dispatch_late_ms_max": got["dispatch_late_ms_max"]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
