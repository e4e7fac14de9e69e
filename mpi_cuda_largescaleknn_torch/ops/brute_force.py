"""Exact blocked brute-force kNN update: the engine ``bruteforce``.

The port of the JAX package's ``ops/brute_force.py``, as PyTorch ops (it is
an XLA program there, not a Pallas kernel). For each (query tile, point
tile) pair the whole distance tile is scored (``ops/distance.py``
``score_tile``: exact f32, or bf16 matmul-form scores whose survivors are
rescored exactly) and merged into the persistent candidate rows. Query
tiles run one after another, so one [query_tile, point_tile] tile is live
at a time.
"""

from __future__ import annotations

import torch

from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL, CandidateState
from mpi_cuda_largescaleknn_torch.ops.candidates import merge_candidates
from mpi_cuda_largescaleknn_torch.ops.distance import (
    elementwise_dist2,
    score_tile,
    validate_score_dtype,
)
from mpi_cuda_largescaleknn_torch.utils.math import cdiv


def pairwise_dist2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """f32[Tq, D] x f32[Tp, D] -> f32[Tq, Tp] squared distances, fixed
    left-to-right component order."""
    return elementwise_dist2(q, p)


def _pad_rows(arr: torch.Tensor, target: int, fill) -> torch.Tensor:
    n = arr.shape[0]
    if n == target:
        return arr
    return torch.cat([arr, torch.full((target - n,) + tuple(arr.shape[1:]),
                                      fill, dtype=arr.dtype,
                                      device=arr.device)])


def knn_update_bruteforce(state: CandidateState, queries: torch.Tensor,
                          points: torch.Tensor,
                          point_ids: torch.Tensor | None = None, *,
                          query_tile: int = 2048, point_tile: int = 2048,
                          score_dtype: str = "f32") -> CandidateState:
    """Fold every ``points`` row (f32[N, D], ids i32[N], default
    ``arange(N)``) into each query's candidate rows (queries f32[Q, D],
    state [Q, k]), on the device the tensors are on. Queries and points
    are padded to whole tiles as the JAX package pads them: sentinel
    queries (their rows are cut off), sentinel points with id -1 (their
    d2 overflows to +inf and never merges in)."""
    validate_score_dtype(score_dtype)
    num_q, k = state.dist2.shape
    num_p = points.shape[0]
    dim = queries.shape[-1]
    dev = queries.device
    if point_ids is None:
        point_ids = torch.arange(num_p, dtype=torch.int32, device=dev)

    qt = min(query_tile, max(num_q, 1))
    pt = min(point_tile, max(num_p, 1))
    nq_tiles = cdiv(num_q, qt)
    np_tiles = cdiv(num_p, pt)
    q_tiles = _pad_rows(queries.to(torch.float32), nq_tiles * qt,
                        PAD_SENTINEL).view(nq_tiles, qt, dim)
    p_tiles = _pad_rows(points.to(torch.float32), np_tiles * pt,
                        PAD_SENTINEL).view(np_tiles, pt, dim)
    id_tiles = _pad_rows(point_ids.to(torch.int32), np_tiles * pt,
                         -1).view(np_tiles, pt)
    d2_tiles = _pad_rows(state.dist2, nq_tiles * qt, torch.inf)
    idx_tiles = _pad_rows(state.idx, nq_tiles * qt, -1)

    out_d2, out_idx = [], []
    for i in range(nq_tiles):
        st = CandidateState(d2_tiles[i * qt:(i + 1) * qt],
                            idx_tiles[i * qt:(i + 1) * qt])
        for j in range(np_tiles):
            d2, ids = score_tile(q_tiles[i], p_tiles[j], id_tiles[j], k,
                                 score_dtype=score_dtype)
            st = merge_candidates(st, d2, ids)
        out_d2.append(st.dist2)
        out_idx.append(st.idx)
    return CandidateState(torch.cat(out_d2)[:num_q], torch.cat(out_idx)[:num_q])
