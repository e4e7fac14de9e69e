"""Bucketed nearest-first traversal: the CUDA kernel, its wrapper and its
plain PyTorch version.

This replaces the JAX package's TPU kernel ``ops/pallas/knn_tiled.py``
(``knn_update_tiled_pallas``) and its in-VMEM fold
``ops/pallas/knn_bf.py`` ``fold_tile_into_candidates``, at any dimension
D. Contract (the same as the TPU kernel's): ``state`` rows are in ``q``'s
bucket order, row ``b * S + i`` is query ``q.pts[b, i]``; every real point
of ``p`` is folded in, each query bucket visiting point buckets in
ascending box distance and stopping once the next box is not strictly
closer than its worst k-th candidate. ``skip_self`` masks point bucket
``b // self_group`` out of query bucket b's walk (for rows already warm
started with their own bucket, ``ops/tiled.py``).

- ``knn_update_tiled_cuda`` is the entry point: on a CUDA tensor it
  launches a kernel (or raises), on a CPU tensor it runs
  ``knn_update_tiled_plain``. In f32 the kernel is one of
  ``csrc/knn_tiled.cu``, named by ``tiled_launch_plan``:
  ``knn_tiled_d3_kernel`` at D=3 (the warp fold of ``csrc/knn_rows.cuh``;
  above ``D3_SLOTS_MAX_K`` ``knn_tiled_d3_wide_kernel``, the wide fold),
  ``knn_tiled_nd_ring_kernel`` (a ring of bulk-copied chunks) at every
  other D, with the queries resident up to Dp4 = ``RESIDENT_MAX_DP4`` and
  D streamed in slices above it; with
  ``score_dtype="bf16"`` at D >= ``mxu_min_dim()`` it is
  ``csrc/knn_tiled_mxu.cu``'s ``knn_tiled_wgmma_kernel``, the TPU kernel's
  ``score_mxu`` branch, named by ``mxu_launch_geometry`` by Dp (D rounded
  up to 16): with the query halves resident up to ``WGMMA_MAX_DP``, with
  D streamed in K-slices above it.
- ``knn_update_tiled_plain`` lock-steps all query buckets through their
  visit schedules and merges each visited bucket with a stable sort.
- ``warm_start_self_cuda`` is the self-join's warm start on the same f32
  kernels: each query bucket visits only its own bucket, once, into cold
  rows (``ops/tiled.py`` ``warm_start_self``'s bits; that eager version on
  CPU tensors).
- ``prepare_points`` lays a point side out once for the kernels (the D=3
  lanes, the ring layout, or the bf16 halves and ``|p|^2``), the
  counterpart of the JAX serving engine's resident ``point_norms2``: a
  caller that folds many query sides into one resident point side (the
  serving engine) passes it as ``prepared`` instead of paying the layout
  at every launch. Its bits are the per-launch preparation's; the plain
  version ignores it.

Under bf16 (the TPU wrapper's algorithm) the rows are widened to
``W = rescore_width(k, lanes)`` slots (``lanes`` counts each point bucket
padded to 128 lanes, as the TPU wrapper does), lanes are scored by the
matmul form and adopted by strict-< into the widened rows as encoded flat
positions ``-2 - (pb*T + lane)``, the pruning radius is each row's last
slot; afterwards every adopted entry is rescored exactly (the f32 bits),
its id decoded, and the rows are sorted stably by d2 and sliced back to
k. Entries carried in keep their ids and exact d2. The result equals the
f32 one whenever each row's true top k lie inside the survivor window.

Both return the same bits: pruning granularity does not change a strict-<
fold's result, only the visit order and the tie rule do, and both keep
them. Two differences from the TPU kernel, neither visible in a result:
ids are read from ``p.ids`` directly (the TPU kernel stored lane positions
and decoded them afterwards, because Mosaic could not broadcast an id row),
and rows of padding queries (id < 0) fold nothing, where the TPU kernel
folded padding lanes into them; those rows are dropped by ``scatter_back``.
The visit count is per query bucket, of buckets scored with a radius
refreshed after every bucket (the TPU kernel refreshed it per chunk of V
buckets, so it can count a few more). Where a bucket's rows split over
blocks, each block prunes against its own rows and the kernels count the
most any block scored, at most the plain version's count.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops.candidates import (
    init_candidates,
    merge_candidates,
    sort_rows_canonical,
)
from mpi_cuda_largescaleknn_torch.ops.distance import (
    elementwise_dist2,
    gathered_dist2,
    mxu_min_dim,
    mxu_scores,
    norms2,
    rescore_width,
    split_bf16,
    validate_score_dtype,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    BucketedPoints,
    nearest_first_order,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import _worst2, warm_start_self
from mpi_cuda_largescaleknn_torch.utils.math import round_up

#: shared memory one block may opt into on sm_90 (227 KB), and an SM's
#: (228 KB, of which each resident block takes 1 KB for the system)
SMEM_OPTIN = 232_448
SMEM_SM = 233_472
#: the D=3 kernels (csrc/knn_rows.cuh, the warp fold): a warp folds
#: WARP_ROWS query rows, scoring chunks of CHUNK_LANES point lanes staged as
#: float4 in tiles of at most D3_MAX_TILE_LANES, two tiles at once; a block
#: has at most D3_MAX_WARPS warps of at most D3_REGS registers a thread
#: (__launch_bounds__(512, 2)); a row keeps d3_slots(k) slots a lane up to
#: D3_SLOTS_MAX_K (csrc/knn_rows.cuh kSlotsMaxK), the k above which
#: tools/torch_d3_k_sweep.py measured the wide fold faster; above it the
#: kernels take the wide fold (csrc/knn_rows.cuh): the row in its own
#: order, in place in device memory, so any k plans, each row's passing
#: lanes buffered WIDE_BUFFER at a time in shared memory (kWideBuffer),
#: sorted in a scratch of WIDE_SORT keys (kWideSort), a warp's buffers taking
#: WIDE_WARP_BYTES (kWideWarpBytes), the traversal's warps keeping their
#: rows' tails (WIDE_TAIL_BYTES, kWideTailBytes) beside; a warp folds
#: WIDE_TILE_LANES lanes between two decisions, the flat kernel staging
#: them in a ring of WIDE_STAGES (kWideStages); WIDE_CTRL_BYTES of
#: barriers, counts and radius slots (kWideCtrlBytes); the wide kernels
#: take WIDE_REGS registers a thread (__launch_bounds__(512, 1))
WARP_ROWS = 4
CHUNK_LANES = 256
D3_MAX_TILE_LANES = 1024
D3_MAX_WARPS = 16
D3_REGS = 64
D3_SLOTS_MAX_K = 128
WIDE_BUFFER = 248
WIDE_SORT = 256
WIDE_WARP_BYTES = WIDE_SORT * 8 + WARP_ROWS * WIDE_BUFFER * 8
WIDE_TAIL_BYTES = round_up(WARP_ROWS * (WIDE_BUFFER + 1) * 4, 16)
WIDE_TILE_LANES = 256
WIDE_STAGES = 8
WIDE_CTRL_BYTES = 1024
WIDE_REGS = 128
#: warps of a traversal block at D=3: 32 rows, so a bucket of S=248 rows
#: splits over 8 blocks that prune on their own rows
D3_TILED_WARPS = 8
#: f32 elements of the [rows, W, D] gather one bf16 rescore step may hold
_RESCORE_BUDGET = 1 << 24


def fold_tile_into_candidates(d2: torch.Tensor, ids: torch.Tensor,
                              cand_d2: torch.Tensor,
                              cand_idx: torch.Tensor) -> CandidateState:
    """Fold a distance tile ``f32[S, T]`` (lane ids ``i32[T]`` or
    ``[S, T]``) into sorted candidate rows ``[S, k]``: strict-< adoption,
    each adopted lane inserted after every equal entry — existing entries
    win ties, then lower lanes. A stable merge computes exactly that."""
    return merge_candidates(CandidateState(cand_d2, cand_idx), d2,
                            ids.expand_as(d2))


def uses_mxu(score_dtype: str, dim: int) -> bool:
    """Whether a traversal at dimension ``dim`` takes the matmul form:
    bf16 at D >= ``mxu_min_dim()``; below it bf16 scores exactly, as in
    the JAX package."""
    return validate_score_dtype(score_dtype) == "bf16" \
        and dim >= mxu_min_dim()


def survivor_width(k: int, p: BucketedPoints) -> int:
    """W of the widened rows: ``rescore_width`` over the point buckets'
    lanes, each bucket padded to a multiple of 128 as in the TPU wrapper
    (so W agrees with the JAX package's on tiny problems too)."""
    num_pb, t_p = p.ids.shape
    return rescore_width(k, num_pb * round_up(t_p, 128))


def widen_rows(state: CandidateState, w: int) -> CandidateState:
    """Fresh contiguous rows widened to ``w`` slots with +inf / -1."""
    rows, k = state.dist2.shape
    dev = state.dist2.device
    return CandidateState(
        torch.cat([state.dist2, torch.full((rows, w - k), torch.inf,
                                           device=dev)], dim=1),
        torch.cat([state.idx, torch.full((rows, w - k), -1,
                                         dtype=torch.int32, device=dev)],
                  dim=1))


def rescore_rows(rows: CandidateState, q: BucketedPoints,
                 p: BucketedPoints, k: int,
                 canonical_ties: bool = False) -> CandidateState:
    """Plain epilogue of the bf16 traversal: each entry with an encoded
    position (idx <= -2) gets its exact f32 distance and its id, then each
    row is sorted stably by d2 (by (d2, idx) with ``canonical_ties``) and
    cut to ``k``. Row chunks bound the [rows, W, D] gather."""
    n, w = rows.dist2.shape
    dim = q.pts.shape[-1]
    q_flat = q.pts.reshape(-1, dim)
    p_flat = p.pts.reshape(-1, dim)
    p_ids = p.ids.reshape(-1)
    step = max(1, _RESCORE_BUDGET // (w * dim))
    d2_out, idx_out = [], []
    for r0 in range(0, n, step):
        d2 = rows.dist2[r0:r0 + step]
        idx = rows.idx[r0:r0 + step]
        enc = idx <= -2
        flat = torch.where(enc, -2 - idx, 0).long()
        pg = p_flat[flat]                                   # [c, W, D]
        d2 = torch.where(enc, gathered_dist2(q_flat[r0:r0 + step], pg), d2)
        idx = torch.where(enc, p_ids[flat], idx)
        if canonical_ties:
            d2, idx = sort_rows_canonical(d2, idx)
        else:
            d2, order = torch.sort(d2, dim=1, stable=True)
            idx = torch.gather(idx, 1, order)
        d2_out.append(d2[:, :k])
        idx_out.append(idx[:, :k])
    return CandidateState(torch.cat(d2_out), torch.cat(idx_out))


def knn_update_tiled_plain(state: CandidateState, q: BucketedPoints,
                           p: BucketedPoints, *, skip_self: bool = False,
                           self_group: int = 1, with_stats: bool | str = False,
                           score_dtype: str = "f32",
                           canonical_ties: bool = False, timers=None):
    """Plain PyTorch version of the traversal kernels. Step j takes every
    query bucket's j-th nearest point bucket, keeps it where its box d2 is
    below the bucket's radius (and it is not the skipped own bucket),
    scores it (exactly, or by the matmul form under bf16) and
    stable-merges it into the rows. With ``with_stats`` also returns each
    query bucket's visit count (i64[Bq]); ``with_stats="full"`` also the
    fold count (``_with_stats``). ``canonical_ties`` sorts the finished rows
    by (d2, idx), as ``knn_update_tiled_cuda`` does; ``timers`` times the
    box order as it does."""
    num_qb, s_q = q.ids.shape
    num_pb, t_p = p.ids.shape
    k = state.dist2.shape[1]
    dev = q.pts.device
    mxu = uses_mxu(score_dtype, q.pts.shape[-1])
    if mxu:
        state = widen_rows(state, survivor_width(k, p))
        qn2, pn2 = norms2(q.pts), norms2(p.pts)
        lanes = torch.arange(t_p, dtype=torch.int32, device=dev)
    kk = state.dist2.shape[1]
    sorted_d2, order = _box_order(q, p, timers)
    qvalid = q.ids >= 0
    hd2 = state.dist2.reshape(num_qb, s_q, kk).clone()
    hidx = state.idx.reshape(num_qb, s_q, kk).clone()
    own = torch.arange(num_qb, device=dev) // self_group
    visits = torch.zeros(num_qb, dtype=torch.int64, device=dev)
    for step in range(num_pb):
        live = sorted_d2[:, step] < _worst2(hd2, qvalid)
        if not bool(live.any()):
            break
        pb = order[:, step].long()
        if skip_self:
            live &= pb != own
        sel = live.nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        a = sel.numel()
        psel = pb[sel]
        if mxu:
            d2 = mxu_scores(q.pts[sel], p.pts[psel], pn2=pn2[psel],
                            qn2=qn2[sel])                    # [A, S, T]
            ids = -2 - (psel[:, None].int() * t_p + lanes)   # [A, T]
        else:
            d2 = elementwise_dist2(q.pts[sel], p.pts[psel])  # [A, S, T]
            ids = p.ids[psel]
        d2 = torch.where(qvalid[sel][:, :, None], d2, torch.inf)
        st = fold_tile_into_candidates(
            d2.reshape(a * s_q, t_p),
            ids[:, None, :].expand(a, s_q, t_p).reshape(a * s_q, t_p),
            hd2[sel].reshape(a * s_q, kk), hidx[sel].reshape(a * s_q, kk))
        hd2[sel] = st.dist2.view(a, s_q, kk)
        hidx[sel] = st.idx.view(a, s_q, kk)
        visits[sel] += 1
    out = CandidateState(hd2.view(num_qb * s_q, kk),
                         hidx.view(num_qb * s_q, kk))
    if mxu:
        out = rescore_rows(out, q, p, k, canonical_ties)
    elif canonical_ties:
        out = CandidateState(*sort_rows_canonical(*out))
    return _with_stats(out, visits, with_stats)


def _box_order(q: BucketedPoints, p: BucketedPoints, timers):
    """``nearest_first_order`` of the boxes, inside the device span
    ``box_order`` of ``timers`` (an ``obs.timers.PhaseTimers``) where
    given."""
    with (contextlib.nullcontext() if timers is None else
          timers.device_span("box_order", q.lower.device)):
        return nearest_first_order(q.lower, q.upper, p.lower, p.upper)


def _with_stats(out: CandidateState, visits: torch.Tensor, with_stats):
    """The traversal's return: ``with_stats="full"`` adds the folds it
    ran, one a visited bucket (the port's folds take a bucket in one pass,
    where the JAX Pallas kernel counts the tile scans of its multi-pass
    fold), so the visits' sum, a 0-d tensor."""
    if with_stats == "full":
        return out, visits, visits.sum()
    return (out, visits) if with_stats else out


def d3_slots(k: int) -> int:
    """Slots a lane holds for a row of ``k`` entries in the warp fold: a
    power of two >= k/32 up to ``D3_SLOTS_MAX_K`` (the kernels have an
    instance for each, and the launchers take it from here), 0 above it:
    the wide fold, a row in its own order."""
    if k > D3_SLOTS_MAX_K:
        return 0
    s = 1
    while 32 * s < k:
        s *= 2
    return s


def d3_stages(k: int, kernel: str) -> int:
    """Tiles a block of the D=3 ``kernel`` (``"traversal"``:
    ``knn_tiled_d3_*``; ``"flat"``: ``knn_bf_d3_*``) stages for rows of
    ``k``: two on slots a lane; on the wide fold (``d3_slots`` 0) none in
    the traversal, whose warps read their lanes from device memory, and
    the flat fold's ring of ``WIDE_STAGES``."""
    if kernel not in ("traversal", "flat"):
        raise ValueError(f"kernel={kernel!r}: 'traversal' or 'flat'")
    if d3_slots(k):
        return 2
    return WIDE_STAGES if kernel == "flat" else 0


def d3_smem_bytes(rows: int, lanes: int, k: int, kernel: str) -> int:
    """Dynamic shared memory of a block of the D=3 ``kernel``
    (``d3_stages``), as the launchers get it: two staged tiles of
    ``lanes`` float4, ``rows`` candidate rows of 32 * d3_slots(k) slots
    (d2 and id) and 32 bytes of mbarriers and radius slots; or in the
    wide fold (``d3_slots`` 0) the pending buffers of ``rows / WARP_ROWS``
    warps beside the flat fold's ring of staged tiles, or beside the rows'
    tails in the traversal, which stages none; and ``WIDE_CTRL_BYTES``."""
    stages = d3_stages(k, kernel)
    slots = d3_slots(k)
    if slots == 0:
        warp = WIDE_WARP_BYTES + (0 if stages else WIDE_TAIL_BYTES)
        return stages * 16 * lanes + rows // WARP_ROWS * warp + WIDE_CTRL_BYTES
    return 2 * 16 * lanes + rows * slots * 32 * 8 + 32


def d3_regs(k: int) -> int:
    """Registers a thread of the D=3 kernel that takes ``k``: ``D3_REGS``
    on slots a lane, ``WIDE_REGS`` on the wide fold."""
    return D3_REGS if d3_slots(k) else WIDE_REGS


def d3_blocks_per_sm(threads: int, smem: int, regs: int = D3_REGS) -> int:
    """Blocks of a D=3 kernel an SM can hold: the least of its 64 warps,
    its 65,536 registers at ``regs`` a thread, and its shared memory."""
    return min(2048 // threads, 65_536 // (threads * regs),
               SMEM_SM // (smem + 1024))


def d3_block(rows: int, lanes: int, k: int,
             kernel: str) -> tuple[int, int]:
    """(rows per block, threads) of the D=3 ``kernel`` (``d3_stages``):
    ``WARP_ROWS`` rows a warp, as many warps as ``rows`` asks for up to
    ``D3_MAX_WARPS``, fewer where two blocks would no longer fit on an SM
    (``d3_smem_bytes``). Raises for k < 1."""
    if k < 1:
        raise ValueError(f"k={k}: a row holds at least one entry")
    warps = max(1, min(D3_MAX_WARPS, -(-rows // WARP_ROWS)))
    while warps > 1 and d3_blocks_per_sm(
            32 * warps, d3_smem_bytes(WARP_ROWS * warps, lanes, k, kernel),
            d3_regs(k)) < 2:
        warps -= 1
    return WARP_ROWS * warps, 32 * warps


def d3_tile_lanes(lanes: int, k: int = 1) -> int:
    """Lanes of a D=3 kernel's staged tile for ``lanes`` asked for: whole
    chunks, at most ``D3_MAX_TILE_LANES``; the wide fold's ring (k above
    ``D3_SLOTS_MAX_K``) stages ``WIDE_TILE_LANES`` a tile."""
    if d3_slots(k) == 0:
        return WIDE_TILE_LANES
    return min(round_up(max(lanes, 1), CHUNK_LANES), D3_MAX_TILE_LANES)


def d3_lanes(pts: torch.Tensor, ids: torch.Tensor,
             n_pad: int) -> torch.Tensor:
    """f32[..., N, 3] points and their i32[..., N] ids -> f32[..., n_pad, 4]
    contiguous: the D=3 kernels' staged lanes {x, y, z, id bits}. Lanes past
    N are NaN with id -1: their d2 is NaN, which no compare adopts."""
    n = pts.shape[-2]
    out = torch.full((*pts.shape[:-2], n_pad, 4), float("nan"),
                     dtype=torch.float32, device=pts.device)
    out[..., :n, :3] = pts
    bits = out.view(torch.int32)
    bits[..., 3] = -1
    bits[..., :n, 3] = ids
    return out


def launch_geometry(s_q: int, t_p: int, k: int) -> tuple[int, int, int]:
    """(rows per block, threads per block, lanes a tile) of
    ``knn_tiled_d3_kernel``: ``D3_TILED_WARPS`` warps of 4 rows
    (``d3_block``) and tiles of whole 256-lane chunks of the bucket padded
    to a multiple of 256 lanes, two staged; or of
    ``knn_tiled_d3_wide_kernel`` (``d3_slots`` 0), which stages none."""
    lanes = d3_tile_lanes(t_p, k)
    rows, threads = d3_block(min(s_q, WARP_ROWS * D3_TILED_WARPS), lanes, k,
                             "traversal")
    return rows, threads, lanes


#: blocks a launch may have along the grid's y axis, the blocks of rows of
#: one query bucket (csrc/bulk_ring.cuh ``kMaxGridY``)
MAX_GRID_Y = 65_535
#: the ring kernel's block: 128 query rows against chunks of 64 point
#: lanes, in 8 consumer warps (each thread a register tile of 8 rows x 4
#: lanes) and one producer warp
RING_ROWS = 128
RING_LANES = 64
RING_THREADS = 256 + 32
#: the largest Dp4 (D rounded up to 4) whose queries stay resident: they
#: and a 2-stage chunk ring (1024 * Dp4 + 256 bytes) fit in shared memory up
#: to Dp4=224 (the rows then stay in device memory); above it D is streamed
RESIDENT_MAX_DP4 = 224
#: the float4 groups of D (16 = 64 components) a streamed stage carries at
#: most: 48 KB of queries and points, so 3 stages fit beside rows of k <= 81
STREAM_SLICE_GROUPS = 16


class TiledPlan(NamedTuple):
    """How an f32 traversal launches: ``kernel`` is "d3"
    (``knn_tiled_d3_kernel``), "ring" (``knn_tiled_nd_ring_kernel``, the
    queries resident) or "stream" (the same kernel, D streamed in slices);
    ``rows`` query rows a block; ``lanes`` point lanes a staged tile or
    chunk; ``threads`` a block; ``dp4`` the components padded to 4;
    ``stages`` of staged tiles in flight (the ring's stages, 2 at D=3);
    ``rows_in_smem``: whether the candidate rows sit in shared memory (else
    in place in device memory); ``smem`` bytes of dynamic shared memory;
    ``slice_groups`` the float4 groups of D a streamed stage carries (0
    unless "stream")."""
    kernel: str
    rows: int
    lanes: int
    threads: int
    dp4: int
    stages: int
    rows_in_smem: bool
    smem: int
    slice_groups: int = 0


def ring_smem_bytes(dp4: int, k: int, stages: int, rows_in_smem: bool,
                    slice_groups: int = 0) -> int:
    """Dynamic shared memory of ``knn_tiled_nd_ring_kernel``: the block's
    128 resident query rows and ``stages`` chunks of 64 lanes, or (with
    ``slice_groups``) ``stages`` slices of ``4 * slice_groups`` components
    of both; the [k, 128] candidate columns when they sit there; and 256
    bytes of barriers and flags."""
    if slice_groups:
        ring = stages * 16 * (RING_ROWS + RING_LANES) * slice_groups
    else:
        ring = 4 * RING_ROWS * dp4 + stages * 4 * RING_LANES * dp4
    return ring + (RING_ROWS * k * 8 if rows_in_smem else 0) + 256


def stream_slice_groups(dp4: int) -> int:
    """float4 groups a streamed slice carries: the Dp4/4 groups split into
    the fewest slices of at most ``STREAM_SLICE_GROUPS``, as even as they
    go (D=240: 4 slices of 15; D=960: 15 of 16)."""
    groups = dp4 // 4
    slices = -(-groups // STREAM_SLICE_GROUPS)
    return -(-groups // slices)


def tiled_launch_plan(s_q: int, t_p: int, k: int, dim: int) -> TiledPlan:
    """The f32 kernel and its plan, by D and Dp4 = D rounded up to 4.

    D=3 takes ``knn_tiled_d3_kernel`` (``launch_geometry``'s block, two
    tiles in flight), its rows in shared memory; above ``D3_SLOTS_MAX_K``
    ``knn_tiled_d3_wide_kernel``, no tile staged, its rows in place in
    device memory and their pending buffers in shared memory, so any k
    plans. Every other D takes the ring kernel: 128 rows a block,
    64-lane chunks; up to ``RESIDENT_MAX_DP4`` with the queries
    resident, above it with D streamed in slices
    (``stream_slice_groups``). The candidate rows sit in shared memory
    where they fit beside a ring of 3 stages, else of 2, and otherwise in
    device memory with the ring as deep as fits, so any k plans."""
    dp4 = round_up(dim, 4)
    if dim == 3:
        rows, threads, lanes = launch_geometry(s_q, t_p, k)
        return TiledPlan("d3", rows, lanes, threads, dp4,
                         d3_stages(k, "traversal"), d3_slots(k) > 0,
                         d3_smem_bytes(rows, lanes, k, "traversal"))
    stream = dp4 > RESIDENT_MAX_DP4
    groups = stream_slice_groups(dp4) if stream else 0
    for rows_in_smem in (True, False):
        for stages in (3, 2):
            smem = ring_smem_bytes(dp4, k, stages, rows_in_smem, groups)
            if smem <= SMEM_OPTIN - 1024:
                return TiledPlan("stream" if stream else "ring", RING_ROWS,
                                 RING_LANES, RING_THREADS, dp4, stages,
                                 rows_in_smem, smem, groups)
    raise AssertionError(f"no ring plan fits at Dp4={dp4}")


def d3_resident_warps(s_q: int, t_p: int, k: int) -> int:
    """Warps of ``knn_tiled_d3_kernel`` an SM holds at the plan for these
    shapes, as the card reports it (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    builds the library)."""
    plan = tiled_launch_plan(s_q, t_p, k, 3)
    blocks = _library("knn_tiled").knn_tiled_blocks_per_sm(
        d3_slots(k), plan.threads, plan.smem)
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-blocks}")
    return blocks * plan.threads // 32


#: the wgmma kernel's block: 128 query rows (two consumer warpgroups of
#: 64) against chunks of 64 point lanes (the n of its m64n64k16 products),
#: taken in pairs (its lanes are padded to a multiple of 128)
WGMMA_ROWS = 128
WGMMA_LANES = 64
#: the largest Dp whose query halves stay resident: they and a 2-stage
#: chunk ring (1024 * Dp + 640 bytes) fit in shared memory up to Dp=224
#: (the rows then stay in device memory); above it D is streamed
WGMMA_MAX_DP = 224
#: the components a streamed stage carries at most (4 k-steps of 16): 64
#: KB of both sides' halves, so 3 stages fit beside rows of W <= 32
WGMMA_SLICE_MAX = 64


class MxuPlan(NamedTuple):
    """How a bf16 traversal launches: ``kernel`` is "wgmma"
    (``knn_tiled_wgmma_kernel``, the query halves resident) or
    "wgmma_stream" (the same kernel, D streamed in K-slices), with
    ``WGMMA_ROWS`` query rows a block and chunks of ``WGMMA_LANES`` lanes
    either way; ``dp`` the padded components; ``stages`` of the ring;
    ``rows_in_smem``: whether the widened candidate rows sit in shared
    memory (else in place in device memory); ``smem`` bytes of dynamic
    shared memory; ``slice_width`` the components of a streamed K-slice (0
    unless "wgmma_stream")."""
    kernel: str
    dp: int
    stages: int
    rows_in_smem: bool
    smem: int
    slice_width: int = 0


def wgmma_smem_bytes(dp: int, w: int, stages: int, rows_in_smem: bool,
                     slice_width: int = 0) -> int:
    """Dynamic shared memory of ``knn_tiled_wgmma_kernel``: both query
    halves of 128 rows and ``stages`` chunks of both point halves and
    their ``|p|^2``, or (with ``slice_width``) ``stages`` K-slices of
    ``slice_width`` components of both halves of the 128 query rows and of
    a chunk pair's 128 lanes, and the pair's ``|p|^2``; the [W, 128]
    candidate columns when they sit there; and 128 bytes of barriers and
    flags."""
    if slice_width:
        ring = stages * (4 * WGMMA_ROWS * slice_width * 2
                         + 2 * WGMMA_LANES * 4)
    else:
        ring = (2 * WGMMA_ROWS * dp * 2
                + stages * (2 * WGMMA_LANES * dp * 2 + WGMMA_LANES * 4))
    return ring + (WGMMA_ROWS * w * 8 if rows_in_smem else 0) + 128


def wgmma_slice_width(dp: int) -> int:
    """Components a streamed K-slice carries: the Dp/16 k-steps split into
    the fewest slices of at most ``WGMMA_SLICE_MAX`` components, as even
    as they go; the last slice takes the rest (D=600, Dp=608: 9 slices of
    64 and one of 32; D=960: 15 of 64). Dp is not padded further: zero
    columns would cost tensor-core products."""
    ksteps = dp // 16
    slices = -(-ksteps // (WGMMA_SLICE_MAX // 16))
    return 16 * -(-ksteps // slices)


def wgmma_slices(dp: int, slice_width: int) -> list[tuple[int, int]]:
    """(first component, width) of each K-slice of ``dp`` components."""
    return [(c0, min(slice_width, dp - c0))
            for c0 in range(0, dp, slice_width)]


def mxu_dp_slice(dim: int) -> tuple[int, int]:
    """(Dp, K-slice width) of the bf16 kernel at dimension ``dim``: Dp is D
    rounded up to 16; the slice width is 0 with the query halves resident
    (Dp <= ``WGMMA_MAX_DP``), else ``wgmma_slice_width(dp)``."""
    dp = round_up(dim, 16)
    return dp, (wgmma_slice_width(dp) if dp > WGMMA_MAX_DP else 0)


def mxu_launch_geometry(dim: int, w: int) -> MxuPlan:
    """The bf16 kernel's plan, by Dp = D rounded up to 16: 128 rows a
    block, 64-lane chunks taken in pairs; up to ``WGMMA_MAX_DP`` with the
    query halves resident ("wgmma"), above it with D streamed in K-slices
    of ``wgmma_slice_width(dp)`` ("wgmma_stream"). The widened rows sit in
    shared memory where they fit beside a ring of 3 stages, else of 2, and
    otherwise in device memory with the ring as deep as fits, so any W
    plans."""
    dp, width = mxu_dp_slice(dim)
    stream = width > 0
    for rows_in_smem in (True, False):
        for stages in (3, 2):
            smem = wgmma_smem_bytes(dp, w, stages, rows_in_smem, width)
            if smem <= SMEM_OPTIN - 1024:
                return MxuPlan("wgmma_stream" if stream else "wgmma", dp,
                               stages, rows_in_smem, smem, width)
    raise AssertionError(f"no wgmma plan fits at Dp={dp}")


class PreparedPoints(NamedTuple):
    """A point side laid out once for the kernels (``prepare_points``).
    ``kind`` names the layout: "d3" (``lanes``: ``d3_lanes``, f32[Bp,
    t_pad, 4]), "ring" (``lanes``: ``ring_layout``, either ring route) or
    "wgmma" (``lanes``: the packed halves (hi, lo) of
    ``pack_wgmma_halves``, ``norms``: ``padded_norms2``); ``ids`` and
    ``pts`` are the side's ids and points, contiguous."""
    kind: str
    lanes: torch.Tensor | tuple
    norms: torch.Tensor | None
    ids: torch.Tensor
    pts: torch.Tensor

    def nbytes(self) -> int:
        """Bytes of the layouts beyond the side's own points and ids."""
        parts = (self.lanes if isinstance(self.lanes, tuple)
                 else (self.lanes,)) + (() if self.norms is None
                                        else (self.norms,))
        return sum(t.numel() * t.element_size() for t in parts)


def prepared_kind(dim: int, score_dtype: str = "f32") -> str:
    """The layout a traversal at ``dim`` and ``score_dtype`` launches on."""
    if uses_mxu(score_dtype, dim):
        return "wgmma"
    return "d3" if dim == 3 else "ring"


def prepare_points(p: BucketedPoints,
                   score_dtype: str = "f32") -> PreparedPoints:
    """``p`` laid out for the kernel ``knn_update_tiled_cuda`` launches at
    its D and ``score_dtype``: the one place that decides the point side's
    layout, made here by every launch not given it (``_prepared_for``):
    ``d3_lanes`` padded to whole 256-lane chunks at D=3; ``ring_layout``
    in 64-lane chunks (NaN lanes) at other D; under bf16 at D >=
    ``mxu_min_dim()`` the packed halves of lanes in pairs of chunks, in
    the plan's K-slices, and ``padded_norms2``. Runs on the device ``p``
    lies on."""
    num_pb, t_p = p.ids.shape
    dim = p.pts.shape[-1]
    ids = p.ids.contiguous()
    pts = p.pts.contiguous()
    kind = prepared_kind(dim, score_dtype)
    if kind == "wgmma":
        dp, width = mxu_dp_slice(dim)
        t_pad = round_up(t_p, 2 * WGMMA_LANES)
        return PreparedPoints(
            kind, pack_wgmma_halves(pts, t_pad, dp, 2 * WGMMA_LANES, width),
            padded_norms2(pts, t_pad), ids, pts)
    if kind == "d3":
        lanes = d3_lanes(pts, ids, round_up(t_p, CHUNK_LANES))
    else:
        lanes = ring_layout(pts, round_up(t_p, RING_LANES), RING_LANES,
                            round_up(dim, 4), float("nan"))
    return PreparedPoints(kind, lanes, None, ids, pts)


def _prepared_for(prepared: PreparedPoints | None, kind: str,
                  p: BucketedPoints, lanes_shape: tuple) -> PreparedPoints:
    """A launch's point side: ``prepared`` checked against the layout its
    plan asks for (``kind`` and the shape of its lanes, the bf16 halves'
    each), or ``prepare_points(p)`` made here, so every launch takes its
    point layout from the one place that decides it."""
    if prepared is None:
        prepared = prepare_points(p, "bf16" if kind == "wgmma" else "f32")
    lanes = prepared.lanes[0] if kind == "wgmma" else prepared.lanes
    if (prepared.kind != kind or prepared.ids.shape != p.ids.shape
            or prepared.pts.device != p.pts.device
            or tuple(lanes.shape) != tuple(lanes_shape)):
        raise ValueError(
            f"the prepared point side ({prepared.kind}, lanes "
            f"{tuple(lanes.shape)}, ids {tuple(prepared.ids.shape)} on "
            f"{prepared.pts.device}) is not this launch's ({kind}, lanes "
            f"{tuple(lanes_shape)}, ids {tuple(p.ids.shape)} on "
            f"{p.pts.device})")
    return prepared


def _check_inputs(state: CandidateState, q: BucketedPoints,
                  p: BucketedPoints) -> None:
    num_qb, s_q = q.ids.shape
    for name, t, dtype in (("q.pts", q.pts, torch.float32),
                           ("q.ids", q.ids, torch.int32),
                           ("p.pts", p.pts, torch.float32),
                           ("p.ids", p.ids, torch.int32),
                           ("state.dist2", state.dist2, torch.float32),
                           ("state.idx", state.idx, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{name} must be a CUDA {dtype} tensor, got "
                             f"{t.device} {t.dtype}")
    if q.pts.shape[-1] != p.pts.shape[-1]:
        raise ValueError(f"queries have D={q.pts.shape[-1]}, points "
                         f"D={p.pts.shape[-1]}")
    if state.dist2.shape != (num_qb * s_q, state.dist2.shape[1]) \
            or state.idx.shape != state.dist2.shape:
        raise ValueError(f"state {tuple(state.dist2.shape)} does not match "
                         f"{num_qb} buckets of {s_q} queries")


def knn_update_tiled_cuda(state: CandidateState, q: BucketedPoints,
                          p: BucketedPoints, *, skip_self: bool = False,
                          self_group: int = 1, with_stats: bool | str = False,
                          score_dtype: str = "f32",
                          canonical_ties: bool = False,
                          prepared: PreparedPoints | None = None,
                          max_grid_y: int = MAX_GRID_Y, timers=None):
    """Fold every real point of ``p`` into ``state`` (module docstring).
    CPU tensors take ``knn_update_tiled_plain``; CUDA tensors launch a
    kernel or raise. ``prepared`` is ``prepare_points(p, score_dtype)``
    made once by the caller (it must match this launch's layout, or the
    call raises); without it the launch makes it itself. A query bucket
    of more than ``max_grid_y`` blocks of rows goes in several launches
    (``grid_y_pieces``; a smaller cap forces the split). Returns a new
    state (the input is not modified) and, with ``with_stats``, each query
    bucket's visit count (i64[Bq]), and with ``with_stats="full"`` also
    the fold count (``_with_stats``).

    ``canonical_ties`` re-sorts the finished rows by (d2, idx), one stable
    two-key sort (of the widened rows, before they are cut to k, under
    bf16), as the JAX Pallas wrapper does. The kernels keep strict-<
    adoption, so at an exact equal-distance k-boundary that straddles
    buckets the kept ids follow the visit order, where the XLA twin's
    canonical mode keeps the smallest ids.

    ``timers`` (an ``obs.timers.PhaseTimers``) times the box order
    (``nearest_first_order``) as the device span ``box_order``, with no
    synchronisation: its owner settles it."""
    if q.pts.device.type == "cpu":
        return knn_update_tiled_plain(state, q, p, skip_self=skip_self,
                                      self_group=self_group,
                                      with_stats=with_stats,
                                      score_dtype=score_dtype,
                                      canonical_ties=canonical_ties,
                                      timers=timers)
    _check_inputs(state, q, p)
    sorted_d2, order = _box_order(q, p, timers)
    k = state.dist2.shape[1]
    if uses_mxu(score_dtype, q.pts.shape[-1]):
        rows = widen_rows(state, survivor_width(k, p))
        visits = launch_knn_tiled_mxu(order, sorted_d2, q, p, rows,
                                      skip_self=skip_self,
                                      self_group=self_group,
                                      prepared=prepared,
                                      max_grid_y=max_grid_y)
        if canonical_ties:
            rows = CandidateState(*sort_rows_canonical(*rows))
        out = CandidateState(rows.dist2[:, :k].contiguous(),
                             rows.idx[:, :k].contiguous())
    else:
        # the kernel updates its rows in place: it gets fresh copies
        out = CandidateState(state.dist2.contiguous().clone(),
                             state.idx.contiguous().clone())
        visits = launch_knn_tiled(order, sorted_d2, q, p, out,
                                  skip_self=skip_self, self_group=self_group,
                                  prepared=prepared, max_grid_y=max_grid_y)
        if canonical_ties:
            out = CandidateState(*sort_rows_canonical(*out))
    return _with_stats(out, visits.long(), with_stats)


def warm_start_self_cuda(q: BucketedPoints, k: int,
                         max_radius=float("inf")) -> CandidateState:
    """``ops/tiled.py`` ``warm_start_self`` (each row the top k of its own
    bucket) as one launch of the f32 traversal kernel that
    ``tiled_launch_plan`` names for the bucket's shapes: a one-visit
    schedule (``order[b] = [b]``, box d2 0, visited below any radius
    above 0), ``skip_self`` off, folded in place into the cold rows of
    ``init_candidates``. Strict-< adoption in lane order after equal
    entries is ``merge_candidates``' stable merge with the row's entries
    first, so the rows are ``warm_start_self``'s bits; rows of padding
    queries (id < 0) stay cold there too (their points score +inf). At D=3
    on slots a lane the kernel enters each cold row by one sort of a chunk
    (``launch_f32_plan``'s ``cold_rows``). Always f32, whatever the
    traversal after it scores in. CPU tensors take
    ``warm_start_self``. Counts the launch in ``warm_start_self_cuda``'s
    ``launches`` and its route's counter (``_count_f32_launch``), never in
    the traversal's."""
    if q.pts.device.type == "cpu":
        return warm_start_self(q, k, max_radius)
    num_qb, s = q.ids.shape
    dev = q.pts.device
    rows = init_candidates(num_qb * s, k, max_radius, device=dev)
    _check_inputs(rows, q, q)
    order = torch.arange(num_qb, dtype=torch.int32, device=dev)[:, None]
    sorted_d2 = torch.zeros((num_qb, 1), dtype=torch.float32, device=dev)
    plan = tiled_launch_plan(s, s, k, q.pts.shape[-1])
    launch_f32_plan(plan, order, sorted_d2, q, q, rows, skip_self=False,
                    self_group=1, cold_rows=True)
    _count_f32_launch(warm_start_self_cuda, plan, k)
    return rows


def _check_schedule(order, sorted_d2, q, p, rows) -> None:
    """The kernels' visit schedule: contiguous i32 ``order`` and f32
    ``sorted_d2`` of [Bq, V], V positions a query bucket with 1 <= V <=
    Bp (``nearest_first_order`` gives V = Bp; the warm start's one visit
    V = 1), and contiguous rows."""
    for name, t in (("order", order), ("sorted_d2", sorted_d2),
                    ("rows.dist2", rows.dist2), ("rows.idx", rows.idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if order.dim() != 2 or order.shape[0] != q.ids.shape[0] \
            or not 1 <= order.shape[1] <= p.ids.shape[0] \
            or order.dtype != torch.int32 \
            or sorted_d2.dtype != torch.float32 \
            or sorted_d2.shape != order.shape:
        raise ValueError(
            f"the visit schedule must be i32/f32 [Bq, V] with 1 <= V <= Bp "
            f"(Bq={q.ids.shape[0]}, Bp={p.ids.shape[0]}), got "
            f"{order.dtype} {tuple(order.shape)} / {sorted_d2.dtype} "
            f"{tuple(sorted_d2.shape)}")


def grid_y_pieces(blocks: int, cap: int = MAX_GRID_Y) -> list[tuple[int, int]]:
    """The launches that cover ``blocks`` blocks of rows of a bucket, at
    most ``cap`` a launch: ``[(y0, ny), ...]`` in order, the first block
    and the count of each. The kernels' blocks of one bucket share nothing
    but the ``visits`` ``atomicMax``, and the pieces run in order on one
    stream, so a split launch gives the bits of an unsplit one."""
    if cap < 1 or cap > MAX_GRID_Y:
        raise ValueError(f"grid-y cap {cap} outside [1, {MAX_GRID_Y}]")
    return [(y0, min(cap, blocks - y0)) for y0 in range(0, blocks, cap)]


def ring_layout(pts: torch.Tensor, n_pad: int, group: int, dp4: int,
                fill: float) -> torch.Tensor:
    """f32[B, N, D] -> f32[B, n_pad/group, dp4/4, group, 4] contiguous: the
    ring kernel's layout. Components are zero-padded to ``dp4`` (they add
    +0 to every d2); rows past N get ``fill`` in their D components; each
    run of ``group`` rows is component-major, so one group (a block's
    queries, or a chunk of lanes) is one contiguous, 16-byte aligned run
    of ``group * dp4`` values, and so is each run of its float4 groups (a
    streamed slice: ``group * 4 * slice_groups`` values)."""
    b, n, dim = pts.shape
    buf = torch.zeros((b, n_pad, dp4), dtype=torch.float32, device=pts.device)
    buf[:, :n, :dim] = pts
    buf[:, n:, :dim] = fill
    return buf.view(b, n_pad // group, group, dp4 // 4, 4).transpose(2, 3) \
        .contiguous()


def launch_knn_tiled(order: torch.Tensor, sorted_d2: torch.Tensor,
                     q: BucketedPoints, p: BucketedPoints,
                     rows: CandidateState, *, skip_self: bool,
                     self_group: int,
                     prepared: PreparedPoints | None = None,
                     max_grid_y: int = MAX_GRID_Y) -> torch.Tensor:
    """Launch the f32 kernel that ``tiled_launch_plan`` names on PyTorch's
    current stream, folding ``p`` into ``rows`` IN PLACE along the visit
    schedule ``(order, sorted_d2)`` of ``nearest_first_order``
    (``launch_f32_plan``). Returns the per-query-bucket visit counts
    (i32[Bq]). Counts one launch in ``knn_update_tiled_cuda.launches``, and
    the ring kernel's also in ``ring_launches`` (queries resident) or
    ``stream_launches`` (D streamed), the D=3 kernels' in ``d3_launches``
    and of those the wide fold's (k above ``D3_SLOTS_MAX_K``) also in
    ``d3_wide_launches``."""
    _check_schedule(order, sorted_d2, q, p, rows)
    plan = tiled_launch_plan(q.ids.shape[1], p.ids.shape[1],
                             rows.dist2.shape[1], q.pts.shape[-1])
    visits = launch_f32_plan(plan, order, sorted_d2, q, p, rows,
                             skip_self=skip_self, self_group=self_group,
                             events=knn_update_tiled_cuda.layout_events,
                             prepared=prepared, max_grid_y=max_grid_y)
    _count_f32_launch(knn_update_tiled_cuda, plan, rows.dist2.shape[1])
    return visits


def _count_f32_launch(counters, plan: TiledPlan, k: int) -> None:
    """One launch of ``plan`` in ``counters`` (a function's attributes):
    ``launches``, and by route ``ring_launches``, ``stream_launches`` or
    ``d3_launches``, the wide fold's also in ``d3_wide_launches``."""
    counters.launches += 1
    counters.ring_launches += int(plan.kernel == "ring")
    counters.stream_launches += int(plan.kernel == "stream")
    counters.d3_launches += int(plan.kernel == "d3")
    counters.d3_wide_launches += int(plan.kernel == "d3"
                                     and d3_slots(k) == 0)


def launch_f32_plan(plan: TiledPlan, order: torch.Tensor,
                    sorted_d2: torch.Tensor, q: BucketedPoints,
                    p: BucketedPoints, rows: CandidateState, *,
                    skip_self: bool, self_group: int,
                    events: list | None = None,
                    prepared: PreparedPoints | None = None,
                    max_grid_y: int = MAX_GRID_Y,
                    cold_rows: bool = False) -> torch.Tensor:
    """Launch ``plan``'s kernel of ``csrc/knn_tiled.cu`` (contiguous rows
    and schedule, as ``_check_schedule`` asks); counts nothing, raises on a
    failed launch. A bucket of more than ``max_grid_y`` blocks of rows goes
    in several launches on the same stream (``grid_y_pieces``). The ring
    kernel gets both sides in ``ring_layout`` (points padded to whole
    chunks with NaN lanes, whose d2 is NaN and never adopted); the D=3
    kernel gets the point buckets as ``d3_lanes`` padded to whole chunks.
    With ``events`` (a list) it appends three recorded CUDA events: before
    the layouts, before the kernel and after it. The point side is
    ``prepared`` (``prepare_points``), made here when not given. The point
    layout takes ``p``'s Bp buckets; the kernel walks the schedule's V
    positions a query bucket. ``cold_rows`` says every row is cold
    (``init_candidates``'): the D=3 kernel on slots a lane then takes its
    instance that enters such a row by one sort of a chunk
    (``csrc/knn_rows.cuh`` ``enter_flat_row_chunk``: the same bits; the
    other instance, the traversal's, keeps the registers of the
    insert-only fold). Returns the per-query-bucket visit counts
    (i32[Bq])."""
    num_qb, s_q = q.ids.shape
    num_pb, t_p = p.ids.shape
    n_sched = order.shape[1]
    k = rows.dist2.shape[1]
    visits = torch.zeros(num_qb, dtype=torch.int32, device=order.device)
    q_ids = q.ids.contiguous()
    flags = (int(bool(skip_self)), self_group)
    lib = _library("knn_tiled")
    err = 0
    with torch.cuda.device(order.device):
        stream = torch.cuda.current_stream().cuda_stream
        if events is not None:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
        if plan.kernel == "d3":
            t_pad = round_up(t_p, CHUNK_LANES)
            p4 = _prepared_for(prepared, "d3", p, (num_pb, t_pad, 4)).lanes
            q_pts = q.pts.contiguous()
            if events is not None:
                marks[1].record()
            blocks = -(-s_q // (plan.threads // 32 * WARP_ROWS))
            for y0, ny in grid_y_pieces(blocks, max_grid_y):
                err = lib.knn_tiled_launch(
                    order.data_ptr(), sorted_d2.data_ptr(), q_pts.data_ptr(),
                    q_ids.data_ptr(), p4.data_ptr(), rows.dist2.data_ptr(),
                    rows.idx.data_ptr(), visits.data_ptr(), num_qb, s_q,
                    n_sched, t_pad, k, *flags, d3_slots(k), int(cold_rows),
                    plan.threads,
                    plan.lanes, plan.smem, y0, ny, stream)
                if err:
                    break
        else:
            s_pad = round_up(s_q, plan.rows)
            t_pad = round_up(t_p, plan.lanes)
            q_ring = ring_layout(q.pts, s_pad, plan.rows, plan.dp4, 0.0)
            prepared = _prepared_for(
                prepared, "ring", p,
                (num_pb, t_pad // plan.lanes, plan.dp4 // 4, plan.lanes, 4))
            p_ring, p_ids = prepared.lanes, prepared.ids
            if events is not None:
                marks[1].record()
            for y0, ny in grid_y_pieces(s_pad // plan.rows, max_grid_y):
                err = lib.knn_tiled_nd_ring_launch(
                    order.data_ptr(), sorted_d2.data_ptr(), q_ring.data_ptr(),
                    q_ids.data_ptr(), p_ring.data_ptr(), p_ids.data_ptr(),
                    rows.dist2.data_ptr(), rows.idx.data_ptr(),
                    visits.data_ptr(), num_qb, s_q, s_pad, n_sched, t_p, t_pad,
                    plan.dp4, k, *flags, plan.stages, int(plan.rows_in_smem),
                    plan.slice_groups, y0, ny, stream)
                if err:
                    break
        if events is not None:
            marks[2].record()
            events.append(marks)
    if err:
        raise RuntimeError(f"knn_tiled kernel launch failed ({plan.kernel} "
                           f"route): CUDA error {err}")
    return visits


def _bf16_halves(pts: torch.Tensor, rows: int, dp: int):
    """(hi, lo) bf16[B, rows, dp] of f32[B, R, D], zero-padded."""
    b, r, dim = pts.shape
    out = []
    for half in split_bf16(pts):
        buf = torch.zeros((b, rows, dp), dtype=torch.bfloat16,
                          device=pts.device)
        buf[:, :r, :dim] = half
        out.append(buf)
    return out


def pack_wgmma_halves(pts: torch.Tensor, t_pad: int, dp: int,
                      group: int = 8, slice_width: int = 0):
    """The bf16 halves (hi, lo) of f32[B, T, D], lanes zero-padded to
    ``t_pad`` and components to ``dp``, in wgmma's K-major no-swizzle
    core-matrix order: each 128-byte core matrix is 8 lanes x 8 components
    (16 bytes a lane).

    The lanes go in runs of ``group`` (a multiple of 8 dividing t_pad),
    each run cut into the K-slices ``wgmma_slices(dp, slice_width)``
    (``slice_width`` 0: one slice of dp) laid one after the other; within
    a slice of width g, core matrices run along its components, then along
    the run's groups of 8 lanes. So a run's slice starting at component c0
    is one contiguous run of ``group * g`` values from element
    ``group * c0`` of the run (what the kernel bulk-copies), and a
    descriptor steps 128 bytes to the next 8 components and ``16 * g``
    bytes to the next 8 lanes. Returns bf16[B, t_pad/group, group * dp]
    each; with one slice the order is the same for any group."""
    b = pts.shape[0]
    sw = slice_width or dp
    runs = t_pad // group
    out = []
    for h in _bf16_halves(pts, t_pad, dp):
        buf = torch.empty((b, runs, group * dp), dtype=torch.bfloat16,
                          device=pts.device)
        for c0, g in wgmma_slices(dp, sw):
            buf[..., group * c0:group * (c0 + g)] \
                .view(b, runs, group // 8, g // 8, 8, 8) \
                .copy_(h[..., c0:c0 + g].view(b, runs, group // 8, 8, g // 8,
                                              8).transpose(3, 4))
        out.append(buf)
    return tuple(out)


def unpack_wgmma_halves(hi: torch.Tensor, lo: torch.Tensor, dp: int,
                        slice_width: int = 0):
    """The plain inverse of ``pack_wgmma_halves`` (``slice_width`` 0: one
    slice of dp): (hi, lo) bf16[B, t_pad, dp], padding included."""
    b, runs, n = hi.shape
    group = n // dp
    out = []
    for h in (hi, lo):
        full = torch.empty((b, runs * group, dp), dtype=h.dtype,
                           device=h.device)
        for c0, g in wgmma_slices(dp, slice_width or dp):
            full[..., c0:c0 + g].view(b, runs, group // 8, 8, g // 8, 8) \
                .copy_(h[..., group * c0:group * (c0 + g)]
                       .view(b, runs, group // 8, g // 8, 8, 8)
                       .transpose(3, 4))
        out.append(full)
    return tuple(out)


def padded_norms2(pts: torch.Tensor, t_pad: int) -> torch.Tensor:
    """f32[B, t_pad]: the exact ``|p|^2`` of f32[B, T, D], +inf on the
    padding lanes (their scores are +inf, never adopted)."""
    n2 = norms2(pts)
    return torch.nn.functional.pad(n2, (0, t_pad - n2.shape[-1]),
                                   value=torch.inf).contiguous()


def launch_knn_tiled_mxu(order: torch.Tensor, sorted_d2: torch.Tensor,
                         q: BucketedPoints, p: BucketedPoints,
                         rows: CandidateState, *, skip_self: bool,
                         self_group: int,
                         prepared: PreparedPoints | None = None,
                         max_grid_y: int = MAX_GRID_Y) -> torch.Tensor:
    """Launch ``knn_tiled_wgmma_kernel`` on the route that
    ``mxu_launch_geometry`` names, on PyTorch's current stream, folding
    ``p`` into the WIDENED ``rows`` IN PLACE (module docstring: on return
    each row holds exact d2 and ids, sorted stably). Prepares the bf16
    halves of both sides (``pack_wgmma_halves``: in one slice with the
    queries resident, else in the plan's K-slices in runs of 128 query
    rows and of a chunk pair's 128 lanes) and the exact ``|p|^2``, the
    point side's in ``prepared`` (``prepare_points``, made here when not
    given). Returns
    the per-query-bucket visit counts (i32[Bq]). A bucket of more than
    ``max_grid_y`` blocks of 128 rows goes in several launches on the same
    stream (``grid_y_pieces``). Counts one launch in
    ``knn_update_tiled_cuda.mxu_launches``, and also in
    ``wgmma_launches`` (queries resident) or ``wgmma_stream_launches`` (D
    streamed)."""
    num_qb, s_q = q.ids.shape
    num_pb, t_p = p.ids.shape
    dim = q.pts.shape[-1]
    w = rows.dist2.shape[1]
    _check_schedule(order, sorted_d2, q, p, rows)
    if num_pb * t_p >= 2**31 - 2:
        raise ValueError(f"{num_pb * t_p} point lanes overflow the encoded "
                         "positions of the bf16 kernel")
    plan = mxu_launch_geometry(dim, w)
    events = knn_update_tiled_cuda.mxu_events
    if events is not None:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
    s_pad = round_up(s_q, WGMMA_ROWS)
    t_pad = round_up(t_p, 2 * WGMMA_LANES)  # the kernel takes chunk pairs
    qh, ql = pack_wgmma_halves(q.pts, s_pad, plan.dp, WGMMA_ROWS,
                               plan.slice_width)
    prepared = _prepared_for(
        prepared, "wgmma", p,
        (num_pb, t_pad // (2 * WGMMA_LANES), 2 * WGMMA_LANES * plan.dp))
    (ph, pl), pn2 = prepared.lanes, prepared.norms
    p_pts, p_ids = prepared.pts, prepared.ids
    visits = torch.zeros(num_qb, dtype=torch.int32, device=order.device)
    q_pts, q_ids = q.pts.contiguous(), q.ids.contiguous()
    lib = _library("knn_tiled_mxu")
    err = 0
    with torch.cuda.device(order.device):
        stream = torch.cuda.current_stream().cuda_stream
        if events is not None:
            marks[1].record()
        ptrs = (order.data_ptr(), sorted_d2.data_ptr(), q_pts.data_ptr(),
                q_ids.data_ptr(), qh.data_ptr(), ql.data_ptr(),
                p_pts.data_ptr(), p_ids.data_ptr(), ph.data_ptr(),
                pl.data_ptr(), pn2.data_ptr(), rows.dist2.data_ptr(),
                rows.idx.data_ptr(), visits.data_ptr())
        for y0, ny in grid_y_pieces(s_pad // WGMMA_ROWS, max_grid_y):
            err = lib.knn_tiled_wgmma_launch(
                *ptrs, num_qb, s_q, s_pad, order.shape[1], t_p, t_pad, dim,
                plan.dp, w, int(bool(skip_self)), self_group, plan.stages,
                int(plan.rows_in_smem), plan.slice_width, y0, ny, stream)
            if err:
                break
        if events is not None:
            marks[2].record()
            events.append(marks)
    if err:
        raise RuntimeError(f"knn_tiled_mxu kernel launch failed "
                           f"({plan.kernel} route): CUDA error {err}")
    kt = knn_update_tiled_cuda
    kt.mxu_launches += 1
    kt.wgmma_launches += int(plan.kernel == "wgmma")
    kt.wgmma_stream_launches += int(plan.kernel == "wgmma_stream")
    return visits


#: kernel launches made by this process (read by chip_smoke.py and the
#: CLIs): ``launches`` of csrc/knn_tiled.cu (any route), ``ring_launches``,
#: ``stream_launches`` and ``d3_launches`` of those that went to its ring
#: kernel with the queries resident, with D streamed, and to its D=3
#: kernels, ``d3_wide_launches`` of the last to ``knn_tiled_d3_wide_kernel``
#: (k above ``D3_SLOTS_MAX_K``), ``mxu_launches`` of
#: csrc/knn_tiled_mxu.cu (either route), ``wgmma_launches`` and
#: ``wgmma_stream_launches`` of those with the query halves resident and
#: with D streamed
knn_update_tiled_cuda.launches = 0
knn_update_tiled_cuda.ring_launches = 0
knn_update_tiled_cuda.stream_launches = 0
knn_update_tiled_cuda.d3_launches = 0
knn_update_tiled_cuda.d3_wide_launches = 0
knn_update_tiled_cuda.mxu_launches = 0
knn_update_tiled_cuda.wgmma_launches = 0
knn_update_tiled_cuda.wgmma_stream_launches = 0
#: the warm start's launches (``warm_start_self_cuda``), counted as the f32
#: traversal's are (``_count_f32_launch``)
warm_start_self_cuda.launches = 0
warm_start_self_cuda.ring_launches = 0
warm_start_self_cuda.stream_launches = 0
warm_start_self_cuda.d3_launches = 0
warm_start_self_cuda.d3_wide_launches = 0
#: None, or a list to which every bf16 launch (``mxu_events``) or f32
#: launch (``layout_events``) appends three recorded CUDA
#: events: before its preparation (bf16: halves, norms; ring: the layouts;
#: D=3: ``d3_lanes``), before the kernel and after it, so a caller can time
#: the two apart
knn_update_tiled_cuda.mxu_events = None
knn_update_tiled_cuda.layout_events = None

#: per library, its launchers' arguments: p = pointer, i = int
_SIGNATURES = {
    "knn_tiled": {"knn_tiled_launch": 8 * "p" + 14 * "i" + "p",
                  "knn_tiled_blocks_per_sm": "iii",
                  "knn_tiled_nd_ring_launch": 9 * "p" + 15 * "i" + "p"},
    "knn_tiled_mxu": {"knn_tiled_wgmma_launch": 14 * "p" + 16 * "i" + "p"},
}


def _library(name: str) -> ctypes.CDLL:
    from mpi_cuda_largescaleknn_torch.utils.cuda_build import load_library

    lib = load_library(name)
    for fn_name, sig in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                           for c in sig]
            fn.restype = ctypes.c_int
    return lib
