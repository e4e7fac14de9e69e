"""The D=3 kernels' time across k, on either side of ``D3_SLOTS_MAX_K``.

Times by CUDA events one launch of each D=3 kernel on ``chip_smoke.py``
phase 4's 1,000,000 seeded uniform points: the traversal's one fold of a
1-shard run after the warm start (``launch_knn_tiled``, as phase 6 times
it) and the flat fold of the first 65,536 points against all of them
(``launch_knn_bf``), at each k asked for. Up to ``D3_SLOTS_MAX_K`` (903)
they run the instances of slots a lane (``knn_tiled_d3_kernel``,
``knn_bf_d3_kernel``), above it the wide fold
(``knn_tiled_d3_wide_kernel``, ``knn_bf_d3_wide_kernel``), so k=903 and
k=904 time the two designs on nearly the same work. Prints one JSON line
a launch and writes them all to ``--out``, beside the card's name and
power limit. Needs one CUDA card and ``nvcc``:

    python3 tools/torch_d3_k_sweep.py [--k 100,903,904,1000]
        [--flat-k 100,903,904,1000] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the phases' data and helpers)

FLAT_QUERIES = 65_536


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", default="100,903,904,1000,2048",
                    help="k of the traversal's launches")
    ap.add_argument("--flat-k", default="100,903,904,1000",
                    help="k of the flat fold's launches")
    ap.add_argument("--out", default="", help="JSON file of the results")
    args = ap.parse_args(argv)

    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import (
        flat_d3_plan,
        launch_knn_bf,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        d3_slots,
        launch_knn_tiled,
        tiled_launch_plan,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        nearest_first_order,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    if not torch.cuda.is_available():
        print("no CUDA card: the kernels have no CPU mode", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    pts = torch.from_numpy(smoke.seeded_points(
        "uniform", smoke.N_MAIN, smoke.SEED + 2)).cuda()
    q = partition_points(pts, bucket_size=256)
    pc = coarsen_buckets(q, 2)
    sorted_d2, order = nearest_first_order(q.lower, q.upper, pc.lower,
                                           pc.upper)
    results = []

    def report(rec):
        rec.update(card=smi, slots_a_lane=d3_slots(rec["k"]))
        print(json.dumps(rec), flush=True)
        results.append(rec)

    for k in (int(x) for x in args.k.split(",") if x):
        warm = warm_start_self(pc, k)
        rows = CandidateState(warm.dist2.clone(), warm.idx.clone())
        ms, visits = smoke.cuda_ms(lambda: launch_knn_tiled(
            order, sorted_d2, q, pc, rows, skip_self=True, self_group=2))
        plan = tiled_launch_plan(q.bucket_size, pc.bucket_size, k, 3)
        report({"kernel": "traversal", "k": k, "ms": ms,
                "visits": int(visits.sum()), "plan": plan._asdict()})
        del warm, rows
        torch.cuda.empty_cache()
    ids = torch.arange(len(pts), dtype=torch.int32, device=pts.device)
    for k in (int(x) for x in args.flat_k.split(",") if x):
        rows = init_candidates(FLAT_QUERIES, k, device=pts.device)
        ms, _ = smoke.cuda_ms(lambda: launch_knn_bf(pts[:FLAT_QUERIES], pts,
                                                    ids, rows))
        report({"kernel": "flat", "k": k, "ms": ms,
                "shape": f"{FLAT_QUERIES} x {len(pts)}",
                "plan": flat_d3_plan(2048, 2048, k)._asdict()})
        del rows
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
