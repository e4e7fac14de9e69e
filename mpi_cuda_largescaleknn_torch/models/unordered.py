"""The unordered-data pipeline: random point order, ring exchange.

End-to-end equivalent of ``cudaMpiKNN_unorderedData``'s main(): slab-split
the global point set, run the ring with stationary queries and persistent
candidate rows, extract per-point k-th-NN distances and return them in
global point order (the concatenation of slabs in rank order). A run with
``query_chunk`` streams the queries in chunks (``ring_knn_chunked``);
otherwise ``ring_knn_stepwise`` runs the rounds, with a checkpoint between
them where ``checkpoint_dir`` is set (without one it is ``ring_knn``).
"""

from __future__ import annotations

import numpy as np

from mpi_cuda_largescaleknn_torch.core.config import KnnConfig, resolve_device
from mpi_cuda_largescaleknn_torch.models.sharding import (
    check_neighbor_id_capacity,
    pad_and_flatten,
    slab_bounds,
    trim_per_shard,
)
from mpi_cuda_largescaleknn_torch.obs.timers import PhaseTimers
from mpi_cuda_largescaleknn_torch.parallel.ring import (
    ring_knn_chunked,
    ring_knn_stepwise,
    ring_total_rounds,
)
from mpi_cuda_largescaleknn_torch.utils.math import cdiv


def ring_bytes(num_shards: int, npad: int, query_chunk: int) -> int:
    """The bytes the ring rotates, as the JAX package counts them: every
    shard's npad points (12 bytes each at D=3), two copies, every round
    but the last, once per chunk."""
    n_chunks = max(1, cdiv(npad, query_chunk)) if query_chunk > 0 else 1
    return (num_shards * npad * 12 * 2 * (ring_total_rounds(num_shards) - 1)
            * n_chunks)


class UnorderedKNN:
    """kNN distances for an unordered global point set over R virtual
    shards on one device."""

    def __init__(self, config: KnnConfig):
        config.validate()
        self.config = config
        self.device = resolve_device(config.device)
        self.num_shards = max(1, config.num_shards)
        self.timers = PhaseTimers()
        self.last_stats: dict | None = None  # executed-work stats of the
        # most recent run (pair_evals etc., parallel/ring.py _ring_stats)

    def run(self, points: np.ndarray, return_neighbors: bool = False):
        """points f32[N, D] -> f32[N] distance of each point to its k-th NN.

        With ``return_neighbors`` also returns i32[N, k] global neighbor ids
        (ascending by distance; -1 where fewer than k neighbors exist)."""
        cfg = self.config
        num_shards = self.num_shards
        points = np.asarray(points, np.float32)
        n_total = len(points)
        if return_neighbors:
            check_neighbor_id_capacity(n_total)

        with self.timers.phase("shard_and_pad"):
            bounds = slab_bounds(n_total, num_shards)
            flat, ids, counts, npad = pad_and_flatten(
                [points[b:e] for b, e in bounds],
                id_bases=[b for b, _ in bounds], dim=points.shape[-1])

        with self.timers.phase("ring", bytes_moved=ring_bytes(
                num_shards, npad, cfg.query_chunk)):
            kwargs = dict(max_radius=cfg.max_radius, engine=cfg.engine,
                          query_tile=cfg.query_tile,
                          point_tile=cfg.point_tile,
                          bucket_size=cfg.bucket_size,
                          point_group=cfg.point_group,
                          score_dtype=cfg.score_dtype, device=self.device,
                          checkpoint_dir=cfg.checkpoint_dir,
                          checkpoint_every=cfg.checkpoint_every,
                          return_candidates=return_neighbors,
                          return_stats=True, timers=self.timers)
            if cfg.query_chunk > 0:
                got = ring_knn_chunked(flat, ids, cfg.k, num_shards,
                                       chunk_rows=cfg.query_chunk,
                                       merge=cfg.merge, **kwargs)
            else:
                got = ring_knn_stepwise(flat, ids, cfg.k, num_shards,
                                        **kwargs)
            if return_neighbors:
                dists, cands, self.last_stats = got
            else:
                dists, self.last_stats = got
            with self.timers.phase("download"):
                dists = dists.cpu().numpy()

        with self.timers.phase("trim"):
            out = np.concatenate(trim_per_shard(dists, counts, npad))
            if return_neighbors:
                idx = np.concatenate(
                    trim_per_shard(cands.idx.cpu().numpy(), counts, npad))
                return out, idx
        return out

