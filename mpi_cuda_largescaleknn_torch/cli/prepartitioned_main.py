"""The ``cudaMpiKNN_prePartitionedData`` entry point on one card.

    python -m mpi_cuda_largescaleknn_torch.cli.prepartitioned_main \
        fileNames.txt -k 100 -o prefix [--engine pallas] [--device cpu]

One virtual shard per listed file (``--shards`` defaults to the number of
files and must equal it, the reference's ``#files == ranks`` check); one
``prefix_%06d.float`` per shard, neighbor ids numbered in file
concatenation order. ``--timings`` writes one JSON object to stderr: the
phase times, the demand ring's ``rounds``, ``kernels_run`` and
``rotations_run``, the kernels' launch counts, queries/s and the peak
device memory. ``--profile-dir`` traces the run with torch.profiler.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from mpi_cuda_largescaleknn_torch.cli.common import (
    launch_counts,
    parse_args,
)
from mpi_cuda_largescaleknn_torch.io.reader import (
    read_list_of_file_names,
    read_points,
)
from mpi_cuda_largescaleknn_torch.io.writer import (
    write_rank_file,
    write_rank_indices,
)
from mpi_cuda_largescaleknn_torch.models.prepartitioned import (
    PrePartitionedKNN,
)
from mpi_cuda_largescaleknn_torch.obs.trace import profile_trace


def main(argv: list[str] | None = None) -> int:
    cfg, in_path, out_prefix, extras = parse_args(
        "torchknn-prepartitioned", sys.argv[1:] if argv is None else argv)

    file_names = read_list_of_file_names(in_path)
    num_shards = extras["shards"] if extras["shards"] is not None \
        else len(file_names)
    if len(file_names) != num_shards:
        raise RuntimeError("number of input files does not match mesh size")

    partitions = [read_points(f) for f in file_names]
    for r, p in enumerate(partitions):
        print(f"#{r}/{len(partitions)}: got {len(p)} points to work on")

    model = PrePartitionedKNN(dataclasses.replace(cfg, num_shards=num_shards))
    want_idx = extras["write_indices"] is not None
    if model.device.type == "cuda":
        # set-up outside the timed run: the CUDA context starts here
        torch.zeros(1, device=model.device)
        torch.cuda.reset_peak_memory_stats(model.device)
    launches0 = launch_counts()
    with profile_trace(cfg.profile_dir):
        t0 = time.perf_counter()
        got = model.run(partitions, return_neighbors=want_idx)
        wall = time.perf_counter() - t0
    results, idx_lists = got if want_idx else (got, None)
    for r, dists in enumerate(results):
        write_rank_file(out_prefix, r, dists)
        if want_idx:
            write_rank_indices(extras["write_indices"], r, idx_lists[r])
    if extras["selfcheck"] > 0:
        from mpi_cuda_largescaleknn_torch.obs.selfcheck import verify_sample
        checked = verify_sample(np.concatenate(partitions),
                                np.concatenate(results), cfg.k,
                                extras["selfcheck"],
                                max_radius=cfg.max_radius)
        print(f"selfcheck OK ({checked} samples)")
    print("done all queries...")
    if extras["timings"]:
        n_total = sum(len(p) for p in partitions)
        report = model.timers.report()
        report.update({
            "device": str(model.device),
            "run_seconds": wall,
            "queries_per_second": n_total / wall if wall else 0.0,
            **{key: n - launches0[key]
               for key, n in launch_counts().items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(model.device)
                                  if model.device.type == "cuda" else 0),
            **model.last_stats})
        sys.stderr.write(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
