"""Persistent per-query top-k candidate lists.

The port of the JAX package's ``ops/candidates.py`` (itself the re-design
of the reference's ``cukd::FlexHeapCandidateList``): all k slots start at
``max_radius**2`` with id -1; a candidate enters only by being strictly
closer than the current k-th slot; the result is ``sqrt`` of the k-th
slot. Ties keep existing entries first, then arrival order — every merge
here is a STABLE sort (``torch.topk``'s tie order is undocumented, so it
is never used). The canonical mode orders ties by id instead.
"""

from __future__ import annotations

import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState


def init_candidates(num_queries: int, k: int, max_radius=float("inf"),
                    *, device=None) -> CandidateState:
    """Fresh candidate state bounded by ``max_radius`` (f32 semantics:
    slots hold ``float32(max_radius)**2``). ``max_radius`` may also be a
    per-query ``f32[num_queries]`` row (a tensor or array): row q's slots
    then hold ``max_radius[q]**2``, and a candidate at or beyond that
    row's radius is never recorded."""
    r = torch.as_tensor(max_radius, dtype=torch.float32, device=device)
    if r.ndim == 0:
        dist2 = (r * r).expand(num_queries, k).contiguous()
    else:
        if tuple(r.shape) != (num_queries,):
            raise ValueError(f"per-query max_radius must be [{num_queries}], "
                             f"got {tuple(r.shape)}")
        dist2 = (r * r)[:, None].expand(num_queries, k).contiguous()
    idx = torch.full((num_queries, k), -1, dtype=torch.int32,
                     device=r.device)
    return CandidateState(dist2, idx)


def sort_rows_canonical(d2: torch.Tensor, idx: torch.Tensor):
    """Rows sorted ascending by the (dist2, idx) total order: a stable sort
    by id, then a stable sort by distance (``-0.0`` and ``0.0`` compare
    equal and keep their order, as in ``lax.sort``)."""
    idx, perm = torch.sort(idx, dim=1, stable=True)
    d2 = torch.gather(d2, 1, perm)
    d2, perm = torch.sort(d2, dim=1, stable=True)
    return d2, torch.gather(idx, 1, perm)


def merge_candidates(state: CandidateState, cand_dist2: torch.Tensor,
                     cand_idx: torch.Tensor,
                     canonical: bool = False) -> CandidateState:
    """Merge a tile of candidates ``(f32[Q,T], i32[Q,T])`` into the state:
    the k smallest of the union per row, by a stable sort with the existing
    entries first. That reproduces strict-< adoption: a candidate tied with
    the current worst slot does not displace it, and equal-distance
    candidates keep arrival order. (The JAX package pre-reduces a wide tile
    with ``lax.top_k``, whose ties go to the lower lane, before the same
    stable sort — the kept rows are identical.)

    ``canonical=True`` orders ties by id: rows come out ascending by
    (dist2, idx) and keep the k smallest under that order, so the result
    does not depend on the order tiles were folded in. Init slots
    (``idx == -1``) win their ties, so strict-< adoption against the
    radius holds. One two-key sort of the whole concatenation gives the
    JAX package's rows: its ``lax.top_k`` pre-reduce with the boundary
    tie-fix keeps the tile's k smallest by (dist2, idx) where the k-th is
    finite, and at an infinite k-th no tile entry can displace an init
    slot. (The JAX tie-fix rounds ids through f32, so the two agree for
    ids below 2**24, the gate the JAX serving engine keeps.)"""
    k = state.dist2.shape[1]
    cat_d2 = torch.cat([state.dist2, cand_dist2], dim=1)
    cat_idx = torch.cat([state.idx, cand_idx], dim=1)
    if canonical:
        d2, idx = sort_rows_canonical(cat_d2, cat_idx)
        return CandidateState(d2[:, :k].contiguous(), idx[:, :k].contiguous())
    sorted_d2, perm = torch.sort(cat_d2, dim=1, stable=True)
    return CandidateState(sorted_d2[:, :k].contiguous(),
                          torch.gather(cat_idx, 1, perm[:, :k]))


def tree_merge_candidates(states: list[CandidateState]) -> CandidateState:
    """The global top-k of R per-shard candidate states for the same query
    rows, by the JAX package's log2(R) recursive doubling: in round s the
    states whose shard indices differ in bit s merge. The state covering
    the LOWER shard block is always the left (existing) operand of
    ``merge_candidates``, whose stable sort then resolves equal distances
    in ascending (shard, slot) order: the tie order of a stable sort over
    the shard-major concatenated rows. Truncating to k each round loses
    nothing (a global top-k entry is in the top k of every union holding
    it). R must be a power of two; R == 1 is the identity."""
    num_shards = len(states)
    if num_shards & (num_shards - 1):
        raise ValueError(
            f"tree merge needs a power-of-two shard count, got {num_shards}")
    # round s: the blocks of 2^s shards, which every shard of a block
    # holds alike after the exchange, so one list entry stands for each
    while len(states) > 1:
        states = [merge_candidates(states[i], *states[i + 1])
                  for i in range(0, len(states), 2)]
    return states[0]


def extract_final_result(state: CandidateState) -> torch.Tensor:
    """k-th-NN distance per query: ``sqrt(kth smallest dist2)``; stays
    ``inf`` when fewer than k neighbors were found. The root is taken in
    f64 and rounded once to f32, which is the correctly rounded f32 root
    (PyTorch's vectorized f32 ``sqrt`` on the CPU can be 1 ulp off)."""
    return torch.sqrt(state.dist2[:, -1].double()).float()


def current_worst_radius(state: CandidateState,
                         valid_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Max over the (real) queries of their current k-th candidate distance:
    the prune cutoff of the pre-partitioned pipeline, a 0-d f32 tensor. A
    shard with no real queries gives 0 (prune everything), not the nan of
    ``sqrt(-inf)``. The root is taken in f64 and rounded once, as in
    ``extract_final_result``."""
    kth = state.dist2[:, -1]
    if valid_mask is not None:
        kth = torch.where(valid_mask, kth, -torch.inf)
    return torch.sqrt(torch.clamp_min(kth.amax(), 0.0).double()).float()
