#!/usr/bin/env python3
"""Offline recall calibration for the port's recall-SLO tier (serve/recall.py).

The PyTorch port's copy of the JAX package's ``tools/recall_harness.py``,
on the port's ``ResidentKnnEngine(engine="tiled")``, on the card unless
``--device cpu`` is given. Measures each candidate plan's ACTUAL recall
by oracle sampling against the exact engine — the same index, the same
launch plans the server runs, with the plan's knobs engaged — across the
three serving workload shapes (uniform / clustered / sweep, mirroring
tools/torch_loadgen.py's generators).
Each plan's calibrated claim is the MINIMUM measured recall over the
workloads minus a safety ``--margin``: the policy may only promise what
its worst calibrated workload delivered, with slack for workload drift.

The output JSON is a ready-to-serve policy table
(``{"plans": [...]}``, the ``RecallPolicy.from_file`` format — point
``serve_main --recall-policy`` at it), plus the full measured matrix so
the calibration is auditable.

    python tools/torch_recall_harness.py --points 16384 --k 16 \
        --queries 512 --margin 0.02 --out recall_policy.json [--device cpu]

``--grid`` additionally sweeps a visit_frac x prune_shrink grid beyond
the built-in plan table — for exploring new operating points before
promoting them into a served policy.
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root when run as a file

import numpy as np  # noqa: E402


def workload_queries(workload: str, n_queries: int, seed: int,
                     scale: float = 1.0, blobs: int = 8,
                     blob_sigma: float = 0.02) -> np.ndarray:
    """Seed-deterministic query sets in the three serving shapes
    (tools/torch_loadgen.py's generators, minus the time axis): ``uniform``
    draws independently in the box; ``clustered`` mixes tight Gaussian
    blobs; ``sweep`` places blob windows along the box diagonal — the
    drifting-hot-region shape, frozen at four window positions.

    The per-workload stream is seeded with crc32(workload), NOT hash():
    str hash is salted per process (PYTHONHASHSEED), which would make
    every calibration run measure a different query set — calibration
    and the CI bench must be byte-reproducible."""
    rng = np.random.default_rng((seed, zlib.crc32(workload.encode())))
    if workload == "uniform":
        return (rng.random((n_queries, 3)) * scale).astype(np.float32)
    if workload == "clustered":
        centers = rng.random((blobs, 3)) * scale
        picks = rng.integers(blobs, size=n_queries)
        q = centers[picks] + rng.normal(0.0, blob_sigma * scale,
                                        (n_queries, 3))
        return np.clip(q, 0.0, scale).astype(np.float32)
    if workload == "sweep":
        fracs = np.array([0.125, 0.375, 0.625, 0.875])
        centers = np.repeat(fracs, 3).reshape(len(fracs), 3) * scale
        picks = rng.integers(len(fracs), size=n_queries)
        q = centers[picks] + rng.normal(0.0, blob_sigma * scale,
                                        (n_queries, 3))
        return np.clip(q, 0.0, scale).astype(np.float32)
    raise ValueError(f"unknown workload '{workload}'")


def candidate_plans(grid: bool):
    """The built-in plan table's knob vectors, plus (``--grid``) a
    visit_frac x prune_shrink exploration sweep."""
    from mpi_cuda_largescaleknn_torch.serve.recall import (
        DEFAULT_PLANS,
        RecallPlan,
    )

    plans = list(DEFAULT_PLANS)
    if grid:
        have = {p.program_key() for p in plans}
        for vf in (0.05, 0.15, 0.35, 0.65):
            for ps in (0.3, 0.6, 0.85):
                p = RecallPlan(name=f"grid-v{vf:g}-p{ps:g}",
                               skip_rescore=True, prune_shrink=ps,
                               visit_frac=vf, route_slack=0.2,
                               stream_skip_cold=True,
                               recall_estimated=0.5)
                if p.program_key() not in have:
                    plans.append(p)
    return plans


def calibrate(*, n_points: int = 16384, k: int = 16, n_queries: int = 512,
              bucket_size: int = 64, max_batch: int = 256,
              margin: float = 0.02, seed: int = 0, grid: bool = False,
              workloads=("uniform", "clustered", "sweep"),
              device=None) -> dict:
    """Build the exact engine once, run every candidate plan's program
    over every workload's query set, and emit the calibrated policy.
    ``device=None`` is the card (it raises without CUDA); ``"cpu"`` runs
    the engine's PyTorch ops on the host."""
    from dataclasses import replace

    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.recall import measured_recall

    rng = np.random.default_rng(seed)
    points = rng.random((n_points, 3)).astype(np.float32)
    engine = ResidentKnnEngine(points, k, num_shards=1, engine="tiled",
                               bucket_size=bucket_size, max_batch=max_batch,
                               min_batch=16, device=device)

    def run(q, plan=None):
        """Engine pass in max_batch chunks -> stacked [n, k] ids."""
        outs = [np.asarray(engine.query(q[i:i + max_batch], plan=plan)[1])
                for i in range(0, len(q), max_batch)]
        return np.concatenate(outs, axis=0)

    queries = {wl: workload_queries(wl, n_queries, seed)
               for wl in workloads}
    # one exact pass per workload — the oracle every plan is scored
    # against (the engine's exact path is itself oracle-exact; tier-1
    # proves that elsewhere)
    exact_idx = {wl: run(q) for wl, q in queries.items()}

    plans = candidate_plans(grid)
    measured: dict[str, dict[str, float]] = {}
    calibrated = []
    for plan in plans:
        per_wl = {}
        for wl, q in queries.items():
            approx_idx = run(q, plan=plan)
            per_wl[wl] = round(measured_recall(approx_idx, exact_idx[wl]),
                               6)
        measured[plan.name] = per_wl
        worst = min(per_wl.values())
        est = max(0.01, round(worst - margin, 4))
        calibrated.append(replace(plan, recall_estimated=est,
                                  recall_target=1.0))
    calibrated.sort(key=lambda p: p.recall_estimated)
    return {
        "kind": "recall_harness",
        "fixture": {"n_points": n_points, "k": k, "n_queries": n_queries,
                    "bucket_size": bucket_size, "max_batch": max_batch,
                    "seed": seed, "margin": margin,
                    "workloads": list(workloads),
                    "engine": engine.engine_name,
                    "device": str(engine.device)},
        "measured": measured,
        "plans": [p.to_json() for p in calibrated],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--queries", type=int, default=512,
                    help="oracle sample size per workload shape")
    ap.add_argument("--bucket-size", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--margin", type=float, default=0.02,
                    help="claimed recall = worst measured workload minus "
                         "this safety margin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", action="store_true",
                    help="also sweep a visit_frac x prune_shrink grid "
                         "beyond the built-in plan table")
    ap.add_argument("--workloads", default="uniform,clustered,sweep",
                    help="comma-separated workload shapes to calibrate on")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the card; "
                         "'cpu' runs it on the host)")
    ap.add_argument("--out", default=None,
                    help="write the policy JSON here (the "
                         "--recall-policy / RecallPolicy.from_file format)")
    a = ap.parse_args(argv)

    report = calibrate(
        n_points=a.points, k=a.k, n_queries=a.queries,
        bucket_size=a.bucket_size, max_batch=a.max_batch,
        margin=a.margin, seed=a.seed, grid=a.grid,
        workloads=tuple(w for w in a.workloads.split(",") if w),
        device=a.device)
    text = json.dumps(report, indent=2)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
