"""Bucketed nearest-first kNN engine: the XLA twin of the traversal kernel,
and the warm start of a self-join traversal.

The port of the JAX package's ``ops/tiled.py``. ``knn_update_tiled`` (the
engine ``tiled``) lock-steps every query bucket through its nearest-first
schedule of point buckets, ``visits_per_step`` at a time: a step scores one
[C, S, V*T] tile a chunk of C query buckets (``ops/distance.py``
``score_tile``), masked where a bucket is pruned, and merges it into the
candidate rows (``merge_candidates``). A bucket is visited while its box
distance is strictly below the query bucket's worst k-th distance (``<=``
under ``canonical_ties``), and the loop ends when no query bucket's next
bucket is live. It runs as PyTorch ops on whatever device its tensors are
on; it is not a kernel.

JAX's ``while_loop`` predicate and its per-chunk ``lax.cond`` become host
decisions here: each step copies one small tensor to the host (the step's
predicate and every chunk's ``ran`` flag) and launches the score and merge
only for the chunks that ran. A chunk that is skipped, or a bucket that is
masked, changes no row, so the rows are the JAX package's bit for bit, and
so are the tile and fold counts.
"""

from __future__ import annotations

import math

import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops.candidates import (
    init_candidates,
    merge_candidates,
)
from mpi_cuda_largescaleknn_torch.ops.distance import (
    elementwise_dist2,
    mxu_min_dim,
    norms2,
    score_tile,
    validate_score_dtype,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    BucketedPoints,
    nearest_first_order,
)
from mpi_cuda_largescaleknn_torch.utils.math import cdiv

#: f32 elements of the [batch, S, S + k] merge tile one step may hold
_WARM_BUDGET = 1 << 25


def _default_chunk(num_buckets: int, s: int, t: int,
                   budget_elems: int = 32_000_000) -> int:
    """Power-of-two query-bucket chunk keeping the [C, S, V*T] distance
    tile within ~``budget_elems`` f32 elements (the JAX package's value)."""
    c = max(1, budget_elems // max(s * t, 1))
    c = 1 << (c.bit_length() - 1)
    return max(1, min(num_buckets, c))


def _worst2(hd2: torch.Tensor, qvalid: torch.Tensor) -> torch.Tensor:
    """Per query bucket: max over its real rows of their k-th d2 (-inf for
    buckets of padding only), the bucket's squared prune radius."""
    return torch.where(qvalid, hd2[:, :, -1], -torch.inf).amax(dim=1)


def warm_start_self(q: BucketedPoints, k: int,
                    max_radius: float = float("inf")) -> CandidateState:
    """Exact top-k of each query's OWN bucket, as the initial candidate
    state for a self-join traversal: every row of bucket b gets the
    stable-merged distances to all real points of bucket b (pad lanes are
    +inf; self counts as neighbor 0). The traversal must then mask the
    own bucket out (``skip_self``), or it would fold it twice.

    Rows are independent, so a coarsened self-join passes
    ``coarsen_buckets(q, group)`` here and gets its rows back in fine
    order. Buckets are merged ``batch`` at a time only to bound memory;
    the batch does not change any value."""
    num_qb, s = q.ids.shape
    init = init_candidates(num_qb * s, k, max_radius, device=q.pts.device)
    hd2 = init.dist2.view(num_qb, s, k)
    hidx = init.idx.view(num_qb, s, k)
    batch = max(1, min(num_qb, _WARM_BUDGET // max(s * (s + k), 1)))
    for b0 in range(0, num_qb, batch):
        pts = q.pts[b0:b0 + batch]
        ids = q.ids[b0:b0 + batch]
        nb = pts.shape[0]
        d2 = elementwise_dist2(pts, pts)                    # [nb, S, S]
        d2 = torch.where(ids[:, None, :] >= 0, d2, torch.inf)
        st = merge_candidates(
            CandidateState(hd2[b0:b0 + nb].reshape(nb * s, k),
                           hidx[b0:b0 + nb].reshape(nb * s, k)),
            d2.reshape(nb * s, s),
            ids[:, None, :].expand(nb, s, s).reshape(nb * s, s))
        hd2[b0:b0 + nb] = st.dist2.view(nb, s, k)
        hidx[b0:b0 + nb] = st.idx.view(nb, s, k)
    return CandidateState(hd2.view(num_qb * s, k), hidx.view(num_qb * s, k))


def tile_schedule_slots(num_pb: int, visits_per_step: int = 8) -> int:
    """Visit slots in ONE query bucket's schedule, pad visits included: the
    per-query-bucket ceiling of ``knn_update_tiled``'s tile count (a
    traversal of Bq query buckets runs at most ``Bq * tile_schedule_slots``
    tiles; the shortfall is what pruning skipped)."""
    v = max(1, min(visits_per_step, num_pb))
    return cdiv(num_pb, v) * v


def knn_update_tiled(state: CandidateState, q: BucketedPoints,
                     p: BucketedPoints, *, chunk_buckets: int | None = None,
                     visits_per_step: int = 8, with_stats: bool | str = False,
                     skip_self=None, self_group: int = 1,
                     canonical_ties: bool = False, score_dtype: str = "f32",
                     point_norms2=None, prune_shrink: float = 1.0,
                     visit_frac: float = 1.0, skip_rescore: bool = False):
    """Fold every real point of ``p`` into the candidate state: the JAX
    package's XLA twin of the traversal (module docstring).

    ``state`` rows are in ``q``'s bucket order: row ``b * S + i`` is query
    ``q.pts[b, i]``. Returns the new state; with ``with_stats`` also the
    count of [S, T] tiles computed (a chunk that ran counts ``C * V``
    tiles, masked buckets included; a skipped chunk none), and with
    ``with_stats="full"`` also the count of chunk merges that ran. Both are
    Python ints; the merges are also counted in ``knn_update_tiled.folds``.

    - ``chunk_buckets``: query buckets a chunk (default
      ``_default_chunk``; it must divide the bucket count).
    - ``skip_self`` (truthy): point bucket ``b // self_group`` is never
      folded into query bucket b (rows warm-started by
      ``warm_start_self``).
    - ``canonical_ties``: ties ordered by (dist2, idx)
      (``merge_candidates(canonical=True)``), and buckets whose box
      distance EQUALS the radius are visited too (``<=``), which makes the
      rows independent of the visit schedule. The schedule's padding
      visits then carry NaN, which no predicate takes, so the dummy bucket
      0 is never folded twice.
    - ``score_dtype`` / ``point_norms2`` / ``skip_rescore``: as
      ``score_tile`` (``point_norms2`` f32[Bp, T], used under bf16 only).
    - ``prune_shrink`` < 1 visits a bucket only while its box d2 is below
      that fraction of the radius; ``visit_frac`` < 1 caps the walk at that
      fraction of its steps (at least one). Both are approximate.
    """
    validate_score_dtype(score_dtype)
    if not 0.0 < prune_shrink <= 1.0:
        raise ValueError(f"prune_shrink must be in (0, 1], "
                         f"got {prune_shrink}")
    if not 0.0 < visit_frac <= 1.0:
        raise ValueError(f"visit_frac must be in (0, 1], got {visit_frac}")
    num_qb, s_q = q.ids.shape
    num_pb, s_p = p.ids.shape
    dim = q.pts.shape[-1]
    dev = q.pts.device
    use_mxu = score_dtype == "bf16" and dim >= mxu_min_dim()
    k = state.dist2.shape[-1]

    v = max(1, min(visits_per_step, num_pb))
    chunk = chunk_buckets or _default_chunk(num_qb, s_q, s_p * v)
    if num_qb % chunk:
        raise ValueError(f"chunk_buckets={chunk} does not divide {num_qb} "
                         "query buckets")
    n_chunks = num_qb // chunk

    sorted_d2, order = nearest_first_order(q.lower, q.upper,
                                           p.lower, p.upper)  # [Bq, Bp] x2
    n_steps = cdiv(num_pb, v)
    pad_v = n_steps * v - num_pb
    if pad_v:
        fill = float("nan") if canonical_ties else float("inf")
        sorted_d2 = torch.cat([sorted_d2, torch.full((num_qb, pad_v), fill,
                                                     device=dev)], dim=1)
        order = torch.cat([order, torch.zeros((num_qb, pad_v),
                                              dtype=order.dtype,
                                              device=dev)], dim=1)
    order = order.long()

    qvalid = q.ids >= 0
    hd2 = state.dist2.reshape(num_qb, s_q, k).clone()
    hidx = state.idx.reshape(num_qb, s_q, k).clone()
    if use_mxu:
        pn2_all = (norms2(p.pts) if point_norms2 is None else
                   torch.as_tensor(point_norms2, dtype=torch.float32,
                                   device=dev))               # [Bp, T]
    shrink = torch.tensor(prune_shrink, dtype=torch.float32, device=dev)

    def live(box_d2, radius2):
        if prune_shrink < 1.0:
            radius2 = radius2 * shrink
        return box_d2 <= radius2 if canonical_ties else box_d2 < radius2

    n_steps_max = (n_steps if visit_frac >= 1.0
                   else max(1, int(math.ceil(n_steps * visit_frac))))
    own = (torch.arange(num_qb, device=dev) // self_group)[:, None]
    worst2 = _worst2(hd2, qvalid)
    tiles = folds = 0
    for step in range(n_steps_max):
        lo = step * v
        visit = order[:, lo:lo + v]                                # [Bq, V]
        active = live(sorted_d2[:, lo:lo + v], worst2[:, None])
        if skip_self:
            active &= visit != own
        # the loop's predicate (any live next bucket) and every chunk's
        # flag, in one copy to the host
        flags = torch.cat([
            live(sorted_d2[:, min(lo, num_pb - 1)], worst2).any()[None],
            active.view(n_chunks, chunk * v).any(dim=1)]).tolist()
        if not flags[0]:
            break
        for c, ran in enumerate(flags[1:]):
            if not ran:
                continue
            b0, b1 = c * chunk, (c + 1) * chunk
            vis = visit[b0:b1]
            mask = active[b0:b1, None, :, None].expand(
                chunk, 1, v, s_p).reshape(chunk, 1, v * s_p)
            d2, ids = score_tile(
                q.pts[b0:b1], p.pts[vis].reshape(chunk, v * s_p, dim),
                p.ids[vis].reshape(chunk, v * s_p), k,
                score_dtype=score_dtype, mask=mask,
                pn2=(pn2_all[vis].reshape(chunk, v * s_p) if use_mxu
                     else None),
                skip_rescore=skip_rescore)
            w = d2.shape[-1]
            st = merge_candidates(
                CandidateState(hd2[b0:b1].reshape(chunk * s_q, k),
                               hidx[b0:b1].reshape(chunk * s_q, k)),
                d2.reshape(chunk * s_q, w), ids.reshape(chunk * s_q, w),
                canonical=canonical_ties)
            hd2[b0:b1] = st.dist2.view(chunk, s_q, k)
            hidx[b0:b1] = st.idx.view(chunk, s_q, k)
            tiles += chunk * v
            folds += 1
        worst2 = _worst2(hd2, qvalid)
    knn_update_tiled.folds += folds
    out = CandidateState(hd2.view(num_qb * s_q, k),
                         hidx.view(num_qb * s_q, k))
    if with_stats == "full":
        return out, tiles, folds
    return (out, tiles) if with_stats else out


knn_update_tiled.folds = 0
