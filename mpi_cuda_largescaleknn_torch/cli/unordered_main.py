"""The ``cudaMpiKNN_unorderedData`` entry point on one card.

    python -m mpi_cuda_largescaleknn_torch.cli.unordered_main \
        points.float3 -o distances.float -k 100 [--shards R] [--device cpu]

Byte-compatible ``.float3`` in / ``.float`` out, output in global point
order. ``--timings`` writes one JSON object to stderr: the phase times,
queries/s over the ring, the kernels' launch counts and the peak device
memory. ``--profile-dir`` traces the run with torch.profiler.
``--score-dtype bf16`` asks for the traversal's matmul form, which engages
at D >= 16 (a ``.float3`` file holds D=3 points, scored exactly).
``--engine pallas`` folds whole shards with the flat brute-force kernel
instead of the traversal.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from mpi_cuda_largescaleknn_torch.cli.common import (
    launch_counts,
    parse_args,
)
from mpi_cuda_largescaleknn_torch.io.reader import read_file_portion
from mpi_cuda_largescaleknn_torch.io.writer import (
    write_distances,
    write_indices,
)
from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN
from mpi_cuda_largescaleknn_torch.obs.trace import profile_trace


def main(argv: list[str] | None = None) -> int:
    cfg, in_path, out_path, extras = parse_args(
        "torchknn-unordered", sys.argv[1:] if argv is None else argv)

    model = UnorderedKNN(cfg)
    points, _begin, n_total = read_file_portion(in_path, 0, 1)
    print(f"# {model.num_shards} virtual shard(s) on {model.device}: "
          f"got {n_total} points to work on")

    want_idx = extras["write_indices"] is not None
    if model.device.type == "cuda":
        # set-up outside the timed run: the CUDA context starts here
        torch.zeros(1, device=model.device)
        torch.cuda.reset_peak_memory_stats(model.device)
    launches0 = launch_counts()
    with profile_trace(cfg.profile_dir):
        t0 = time.perf_counter()
        got = model.run(points, return_neighbors=want_idx)
        wall = time.perf_counter() - t0
    if want_idx:
        dists, idx = got
        write_indices(extras["write_indices"], idx)
    else:
        dists = got
    write_distances(out_path, dists)
    if extras["selfcheck"] > 0:
        from mpi_cuda_largescaleknn_torch.obs.selfcheck import verify_sample
        checked = verify_sample(points, dists, cfg.k, extras["selfcheck"],
                                max_radius=cfg.max_radius)
        print(f"selfcheck OK ({checked} samples)")
    print("done all queries...")
    if extras["timings"]:
        report = model.timers.report()
        report.update({
            "device": str(model.device),
            "run_seconds": wall,
            "queries_per_second": n_total / wall if wall else 0.0,
            **{key: n - launches0[key]
               for key, n in launch_counts().items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(model.device)
                                  if model.device.type == "cuda" else 0),
            **(model.last_stats or {})})
        sys.stderr.write(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
