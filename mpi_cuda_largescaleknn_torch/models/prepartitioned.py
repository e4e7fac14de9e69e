"""The pre-partitioned pipeline: one spatially coherent shard per file.

End-to-end equivalent of ``cudaMpiKNN_prePartitionedData``'s main(): each
shard owns one input partition, shards are padded to the largest one, and
the bounds-pruned early-exit ring (``parallel/demand.py``) refines every
partition's rows until no shard can improve. Results come back per
partition (the reference writes one ``prefix_%06d.float`` per rank). The
shards are virtual: all of them live on the one card. A run with
``query_chunk`` streams the queries in chunks (``demand_knn_chunked``);
otherwise ``demand_knn_stepwise`` runs the rounds, with a checkpoint
between them where ``checkpoint_dir`` is set (without one it is
``demand_knn``).

``PrePartitionedKNN.timers`` time a run's phases ``pad``, ``demand_ring``
and ``extract``, and inside ``demand_ring`` the demand ring's stages
(``upload``, ``partition``, ``init``, ``traverse``, ``final``), its host
phase ``radius`` (each batched read of the shards' worst radii, one wait on
the card) and device span ``box_order``, and its counters
``demand_radius_reads`` and ``demand_folds_pruned``
(``parallel/demand.py``); ``last_stats`` keeps the ring's returned stats
alone.
"""

from __future__ import annotations

import numpy as np

from mpi_cuda_largescaleknn_torch.core.config import KnnConfig, resolve_device
from mpi_cuda_largescaleknn_torch.models.sharding import (
    check_neighbor_id_capacity,
    pad_and_flatten,
    trim_per_shard,
)
from mpi_cuda_largescaleknn_torch.obs.timers import PhaseTimers
from mpi_cuda_largescaleknn_torch.parallel.demand import (
    demand_knn_chunked,
    demand_knn_stepwise,
)


class PrePartitionedKNN:
    """kNN distances for pre-partitioned point sets over virtual shards on
    one device. ``config.num_shards`` 0 means one shard per partition;
    any other value must equal the number of partitions."""

    def __init__(self, config: KnnConfig):
        config.validate()
        self.config = config
        self.device = resolve_device(config.device)
        self.timers = PhaseTimers()
        self.last_stats: dict | None = None  # rounds, kernels_run and
        # rotations_run of the most recent run (parallel/demand.py), and
        # rounds_per_chunk of a chunked one

    def run(self, partitions: list[np.ndarray],
            return_neighbors: bool = False):
        """partitions: one f32[Ni, D] array per shard -> per-partition
        f32[Ni] k-th-NN distances (global over the union of all partitions).

        With ``return_neighbors`` also returns per-partition i32[Ni, k]
        neighbor ids, numbered globally in partition concatenation order
        (-1 where fewer than k neighbors exist)."""
        cfg = self.config
        partitions = [np.asarray(p, np.float32) for p in partitions]
        num_shards = cfg.num_shards or len(partitions)
        if return_neighbors:
            check_neighbor_id_capacity(sum(len(p) for p in partitions))
        if len(partitions) != num_shards:
            # the reference's "number of input files does not match MPI size"
            raise ValueError(
                f"number of input partitions ({len(partitions)}) does not "
                f"match the shard count ({num_shards})")

        with self.timers.phase("pad"):
            sizes = np.cumsum([0] + [len(p) for p in partitions])
            flat, ids, counts, npad = pad_and_flatten(
                partitions, id_bases=[int(s) for s in sizes[:-1]],
                dim=partitions[0].shape[-1])

        with self.timers.phase("demand_ring"):
            kwargs = {"checkpoint_dir": cfg.checkpoint_dir,
                      "checkpoint_every": cfg.checkpoint_every}
            if cfg.query_chunk > 0:
                run_fn = demand_knn_chunked
                kwargs.update(chunk_rows=cfg.query_chunk,
                              return_candidates=return_neighbors)
            else:
                run_fn = demand_knn_stepwise
            dists, cands, stats = run_fn(
                flat, ids, cfg.k, num_shards, max_radius=cfg.max_radius,
                engine=cfg.engine, query_tile=cfg.query_tile,
                point_tile=cfg.point_tile, bucket_size=cfg.bucket_size,
                point_group=cfg.point_group, device=self.device,
                return_stats=True, timers=self.timers, **kwargs)
            dists = dists.cpu().numpy()
            # a chunked run's rounds are per chunk: "rounds" stays
            # comparable across the loops as their most
            rounds = stats["rounds"]
            self.last_stats = dict(stats, rounds=(
                max(rounds, default=0) if isinstance(rounds, list)
                else rounds))
            if cfg.query_chunk > 0:
                self.last_stats["rounds_per_chunk"] = rounds

        with self.timers.phase("extract"):
            out = trim_per_shard(dists, counts, npad)
            if return_neighbors:
                idx = trim_per_shard(cands.idx.cpu().numpy(), counts, npad)
                return out, idx
            return out
