"""Why phase 13a's chunks take more kernel time per bucket pair than the
unchunked walk.

On phase 13a's points (8,388,608 seeded uniform points, k=100, R=1) and
its resident side (the whole partition coarsened at G=2, as
``ring_knn_chunked`` holds it), times one D=3 traversal launch
(``knn_update_tiled_cuda``) by CUDA events, the kernel and its
``d3_lanes`` layout apart as ``chip_smoke.py`` phase 13a times them, for
four query sides:

- ``unchunked warm``: the whole partition, warm-started with its own
  bucket and folded with ``skip_self`` (phase 13a's unchunked launch);
- ``unchunked cold``: the same queries from cold rows, no ``skip_self``;
- ``chunk, input order``: slab rows [0, 1,048,576), partitioned on their
  own, cold (phase 13a's first chunk);
- ``chunk, partition order``: the 1,048,576 points of the whole
  partition's first 4,096 buckets (a compact region), partitioned on
  their own, cold.

Per case: query buckets, visits (per query bucket the most of its 32-row
blocks, summed), bucket pairs (visits x S_q x G*S_p), the kernel's best
time over ``--reps`` launches, ns per bucket pair, and the layout time.
Needs one CUDA card and ``nvcc``:

    python3 tools/probe_chunk_order.py [--reps 2] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (phase 13a's data)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda as kt,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    k, group, chunk = smoke.WALL_K, 2, smoke.WALL_CHUNK
    pts = torch.from_numpy(smoke.seeded_points("uniform", smoke.N_WALL,
                                               smoke.SEED + 8)).cuda()
    ids = torch.arange(len(pts), dtype=torch.int32, device=pts.device)
    q = partition_points(pts, ids, bucket_size=256)
    pc = coarsen_buckets(q, group)
    nb = chunk // q.bucket_size

    def cold(side):
        return init_candidates(side.ids.numel(), k, float("inf"),
                               device=pts.device)

    cases = [
        ("unchunked warm", q, lambda: warm_start_self(pc, k, float("inf")),
         True),
        ("unchunked cold", q, lambda: cold(q), False),
    ]
    by_input = partition_points(pts[:chunk], ids[:chunk], bucket_size=256)
    by_part = partition_points(q.pts[:nb].reshape(-1, 3),
                               q.ids[:nb].reshape(-1), bucket_size=256)
    cases += [("chunk, input order", by_input, lambda: cold(by_input), False),
              ("chunk, partition order", by_part, lambda: cold(by_part),
               False)]

    smi = smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(smi)
    out = {"nvidia_smi": smi, "cases": []}
    for name, side, rows_fn, skip_self in cases:
        kernel_ms, layout_ms = [], []
        for _ in range(args.reps):
            rows = rows_fn()
            events = []
            kt.layout_events = events
            torch.cuda.synchronize()
            _, vis = kt(rows, side, pc, skip_self=skip_self,
                        self_group=group, with_stats=True)
            torch.cuda.synchronize()
            kt.layout_events = None
            (a, b, c), = events
            layout_ms.append(a.elapsed_time(b))
            kernel_ms.append(b.elapsed_time(c))
            del rows
        visits = int(vis.sum())
        pairs = visits * side.bucket_size * pc.bucket_size
        best = min(kernel_ms)
        res = {"case": name, "query_buckets": side.num_buckets,
               "bucket_size": side.bucket_size, "visits": visits,
               "visits_per_bucket": visits / side.num_buckets,
               "bucket_pairs": pairs, "kernel_ms": kernel_ms,
               "ns_per_pair": best * 1e6 / pairs, "layout_ms": layout_ms}
        out["cases"].append(res)
        print(f"{name}: {side.num_buckets} query buckets, {visits} visits "
              f"({visits / side.num_buckets:.2f} a bucket), {pairs} bucket "
              f"pairs, kernel {best:.3f} ms ("
              + ", ".join(f"{t:.3f}" for t in kernel_ms)
              + f"), {best * 1e6 / pairs:.5f} ns a pair, layout "
              f"{min(layout_ms):.3f} ms", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
