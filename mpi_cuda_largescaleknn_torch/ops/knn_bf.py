"""Flat brute force (the engine ``pallas``): the CUDA kernel, its wrapper
and its plain PyTorch version.

This replaces the JAX package's TPU kernel ``ops/pallas/knn_bf.py``
(``_kernel`` / ``_run``, wrapped by ``knn_update_pallas``), exact f32 at
every dimension D as it is (the flat engine has no bf16 path in either
package). Contract (the
same as the TPU kernel's, and as one ``runQuery`` launch of the
reference): every row of ``points`` is folded into each query's persistent
sorted top-k row — strict-< adoption, each adopted point inserted after
every equal entry, so existing entries win ties, then lower point rows.

- ``knn_update_bf_cuda`` is the entry point: on a CUDA tensor it launches
  a kernel or raises, on a CPU tensor it runs ``knn_update_bf_plain``. At
  D=3 the kernel is ``csrc/knn_bf.cu``'s ``knn_bf_d3_kernel`` (the warp
  fold of ``csrc/knn_rows.cuh``; above ``D3_SLOTS_MAX_K``
  ``knn_bf_d3_wide_kernel``, the wide fold); at other D it is the traversal's
  ``knn_tiled_nd_ring_kernel`` (``csrc/knn_tiled.cu``) on
  ``flat_buckets``: one query bucket of every row and one point bucket of
  every point, visited once, which folds the points in the same order.
- ``knn_update_bf_plain`` follows the JAX package's
  ``ops/brute_force.py`` ``knn_update_bruteforce``: [query_tile,
  point_tile] tiles of exact distances, each stable-merged into the rows.

Both return the same bits whatever the tiles: a stable merge of the rows
with the points in ascending order keeps the k smallest by (d2, existing
first, then point row), and so does a merge tile by tile. Ids are read
from ``point_ids`` directly; the TPU kernel's encoded lane positions and
``decode_positions`` existed only for Mosaic and are not ported. Padding
query rows (sentinel coordinates) are scored like any other row: against
sentinel points they score 0 and adopt id -1, as in the TPU kernel, and
callers drop them. Every query row of ``flat_buckets`` is real for the
traversal, so the ring kernel folds those rows too.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops.candidates import merge_candidates
from mpi_cuda_largescaleknn_torch.ops.distance import elementwise_dist2
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
    CHUNK_LANES,
    RING_LANES,
    RING_ROWS,
    TiledPlan,
    d3_block,
    d3_lanes,
    d3_slots,
    d3_smem_bytes,
    d3_stages,
    d3_tile_lanes,
    launch_f32_plan,
    tiled_launch_plan,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    BucketedPoints,
    nearest_first_order,
)
from mpi_cuda_largescaleknn_torch.utils.math import round_up


def knn_update_bf_plain(state: CandidateState, queries: torch.Tensor,
                        points: torch.Tensor,
                        point_ids: torch.Tensor | None = None, *,
                        query_tile: int = 2048,
                        point_tile: int = 2048) -> CandidateState:
    """Plain PyTorch version of the kernel: for each block of
    ``query_tile`` rows, each ``point_tile`` block of points in turn is
    scored exactly and stable-merged into the rows."""
    num_q = state.dist2.shape[0]
    num_p = points.shape[0]
    if num_p == 0 or num_q == 0:
        return state
    if point_ids is None:
        point_ids = torch.arange(num_p, dtype=torch.int32,
                                 device=points.device)
    qt = min(query_tile, num_q)
    pt = min(point_tile, num_p)
    d2_out, idx_out = [], []
    for q0 in range(0, num_q, qt):
        q = queries[q0:q0 + qt]
        st = CandidateState(state.dist2[q0:q0 + qt], state.idx[q0:q0 + qt])
        for p0 in range(0, num_p, pt):
            d2 = elementwise_dist2(q, points[p0:p0 + pt])
            st = merge_candidates(st, d2,
                                  point_ids[None, p0:p0 + pt].expand_as(d2))
        d2_out.append(st.dist2)
        idx_out.append(st.idx)
    return CandidateState(torch.cat(d2_out), torch.cat(idx_out))


def launch_geometry(query_tile: int, point_tile: int,
                    k: int) -> tuple[int, int]:
    """(rows per block, staged lanes) of ``knn_bf_d3_kernel``:
    ``query_tile`` rows a block in warps of 4 (``d3_block``: at most 16
    warps, fewer where two blocks would not fit on an SM) and tiles of
    ``point_tile`` lanes rounded up to whole 256-lane chunks, at most 1024
    (``d3_tile_lanes``; ``WIDE_TILE_LANES`` on the wide fold's ring); a
    block has 8 threads a row. The whole plan, where the rows sit
    included: ``flat_d3_plan``."""
    lanes = d3_tile_lanes(point_tile, k)
    return d3_block(query_tile, lanes, k, "flat")[0], lanes


def flat_d3_plan(query_tile: int, point_tile: int, k: int) -> TiledPlan:
    """How the flat D=3 kernel launches, as the traversal's D=3 plan says
    it: ``launch_geometry``'s block and tiles, the rows in shared memory
    beside two tiles in flight (``knn_bf_d3_kernel``, slots a lane) or in
    place in device memory beside a ring of ``WIDE_STAGES`` tiles and the
    pending buffers (``knn_bf_d3_wide_kernel``, k above
    ``D3_SLOTS_MAX_K``), and the block's shared memory."""
    rows, lanes = launch_geometry(query_tile, point_tile, k)
    return TiledPlan("d3", rows, lanes, 8 * rows, 4, d3_stages(k, "flat"),
                     d3_slots(k) > 0, d3_smem_bytes(rows, lanes, k, "flat"))


def flat_plan(k: int, dim: int) -> TiledPlan:
    """The ring kernel's plan for the flat fold at D != 3
    (``tiled_launch_plan``: queries resident up to ``RESIDENT_MAX_DP4``, D
    streamed above it, any k); the engine's tiles do not enter it."""
    if dim == 3:
        raise ValueError("the flat fold at D=3 takes knn_bf_d3_kernel")
    return tiled_launch_plan(RING_ROWS, RING_LANES, k, dim)


def flat_buckets(queries: torch.Tensor, points: torch.Tensor,
                 point_ids: torch.Tensor):
    """The flat fold as a traversal: (one query bucket of every row, each
    real with its row number as id; one point bucket of every point with
    ``point_ids``). Both boxes are all of space, so the one box d2 is 0 and
    the walk visits the bucket whenever a row could adopt anything: the
    traversal folds every point, in row order, into every row."""
    dim = queries.shape[-1]
    dev = queries.device

    def bucket(pts, ids):
        n = pts.shape[0]
        return BucketedPoints(
            pts[None], ids[None],
            torch.full((1, dim), -torch.inf, device=dev),
            torch.full((1, dim), torch.inf, device=dev),
            torch.arange(n, dtype=torch.int32, device=dev)[None])

    rows = torch.arange(queries.shape[0], dtype=torch.int32, device=dev)
    return bucket(queries, rows), bucket(points, point_ids)


def _check_inputs(state: CandidateState, queries: torch.Tensor,
                  points: torch.Tensor, point_ids: torch.Tensor) -> None:
    for name, t, dtype in (("queries", queries, torch.float32),
                           ("points", points, torch.float32),
                           ("point_ids", point_ids, torch.int32),
                           ("state.dist2", state.dist2, torch.float32),
                           ("state.idx", state.idx, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{name} must be a CUDA {dtype} tensor, got "
                             f"{t.device} {t.dtype}")
    if queries.shape[-1] != points.shape[-1]:
        raise ValueError(f"queries have D={queries.shape[-1]}, points "
                         f"D={points.shape[-1]}")
    if state.dist2.shape[0] != queries.shape[0] \
            or state.idx.shape != state.dist2.shape \
            or point_ids.shape != (points.shape[0],):
        raise ValueError(f"state {tuple(state.dist2.shape)}, queries "
                         f"{tuple(queries.shape)}, points "
                         f"{tuple(points.shape)} and point_ids "
                         f"{tuple(point_ids.shape)} do not match")


def knn_update_bf_cuda(state: CandidateState, queries: torch.Tensor,
                       points: torch.Tensor,
                       point_ids: torch.Tensor | None = None, *,
                       query_tile: int = 2048,
                       point_tile: int = 2048) -> CandidateState:
    """Fold every row of ``points`` (ids ``point_ids``, default their row
    numbers) into ``state`` (module docstring). CPU tensors take
    ``knn_update_bf_plain``; CUDA tensors launch the kernel or raise.
    Returns a new state and leaves the input as it was, as the plain
    version does, so both sides of a comparison may share one input. The
    copy moves 16 bytes a slot (about 1.6 GB, well under a millisecond,
    at 1M rows and k=100), against a fold that scores every point of the
    shard for every row."""
    if queries.device.type == "cpu":
        return knn_update_bf_plain(state, queries, points, point_ids,
                                   query_tile=query_tile,
                                   point_tile=point_tile)
    num_q, k = state.dist2.shape
    num_p = points.shape[0]
    if point_ids is None:
        point_ids = torch.arange(num_p, dtype=torch.int32,
                                 device=points.device)
    _check_inputs(state, queries, points, point_ids)
    if num_p == 0 or num_q == 0:
        return state
    # the kernel updates its rows in place: it gets fresh copies
    out = CandidateState(state.dist2.contiguous().clone(),
                         state.idx.contiguous().clone())
    launch_knn_bf(queries, points, point_ids, out, query_tile=query_tile,
                  point_tile=point_tile)
    return out


#: query rows one flat launch on the ring kernel takes: 65,535 blocks of
#: 128 (the grid's y limit); more go in several launches
FLAT_MAX_ROWS = 65_535 * RING_ROWS


def launch_knn_bf(queries: torch.Tensor, points: torch.Tensor,
                  point_ids: torch.Tensor, rows: CandidateState, *,
                  query_tile: int = 2048, point_tile: int = 2048) -> None:
    """Launch the flat fold on PyTorch's current stream, folding ``points``
    into ``rows`` IN PLACE (contiguous CUDA rows, inputs as checked by
    ``knn_update_bf_cuda``). At D=3 ``knn_bf_d3_kernel`` gets the points as
    ``d3_lanes`` padded to whole 256-lane chunks; at other D the ring
    kernel (``flat_plan``) folds ``flat_buckets``, ignoring the tiles.
    Counts each launch in ``knn_update_bf_cuda.launches``, and in
    ``d3_launches`` or ``ring_launches`` by its kernel (the wide fold's,
    k above ``D3_SLOTS_MAX_K``, also in ``d3_wide_launches``). With
    ``knn_update_bf_cuda.layout_events`` a list, each launch appends three
    recorded CUDA events: before its layouts, before the kernel and after
    it."""
    num_q, k = rows.dist2.shape
    dim = queries.shape[-1]
    if not (rows.dist2.is_contiguous() and rows.idx.is_contiguous()):
        raise ValueError("rows must be contiguous")
    bf = knn_update_bf_cuda
    if dim != 3:
        plan = flat_plan(k, dim)
        for q0 in range(0, num_q, FLAT_MAX_ROWS):
            sl = slice(q0, q0 + FLAT_MAX_ROWS)
            q, p = flat_buckets(queries[sl], points, point_ids)
            sorted_d2, order = nearest_first_order(q.lower, q.upper,
                                                   p.lower, p.upper)
            launch_f32_plan(plan, order, sorted_d2, q, p,
                            CandidateState(rows.dist2[sl], rows.idx[sl]),
                            skip_self=False, self_group=1,
                            events=bf.layout_events)
            bf.launches += 1
            bf.ring_launches += 1
        return
    plan = flat_d3_plan(query_tile, point_tile, k)
    events = bf.layout_events
    with torch.cuda.device(points.device):
        if events is not None:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
        p, pid = points.contiguous(), point_ids.contiguous()
        q = queries.contiguous()
        np_pad = round_up(p.shape[0], CHUNK_LANES)
        p4 = d3_lanes(p, pid, np_pad)
        lib = _library()
        if events is not None:
            marks[1].record()
        err = lib.knn_bf_launch(q.data_ptr(), p4.data_ptr(),
                                rows.dist2.data_ptr(), rows.idx.data_ptr(),
                                num_q, np_pad, k, d3_slots(k), plan.threads,
                                plan.lanes, plan.smem,
                                torch.cuda.current_stream().cuda_stream)
        if events is not None:
            marks[2].record()
            events.append(marks)
    if err:
        raise RuntimeError(f"knn_bf kernel launch failed: CUDA error {err}")
    bf.launches += 1
    bf.d3_launches += 1
    bf.d3_wide_launches += int(d3_slots(k) == 0)


def resident_warps(k: int, query_tile: int = 2048,
                   point_tile: int = 2048) -> int:
    """Warps of ``knn_bf_d3_kernel`` an SM holds at the plan for these
    knobs, as the card reports it (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    builds the library)."""
    plan = flat_d3_plan(query_tile, point_tile, k)
    blocks = _library().knn_bf_blocks_per_sm(d3_slots(k), plan.threads,
                                             plan.smem)
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-blocks}")
    return blocks * plan.rows // 4


#: flat kernel launches made by this process (read by chip_smoke.py and the
#: CLIs): ``launches`` of either kernel, ``d3_launches`` of those that went
#: to csrc/knn_bf.cu's D=3 kernels, ``d3_wide_launches`` of those to its
#: ``knn_bf_d3_wide_kernel`` (k above ``D3_SLOTS_MAX_K``), ``ring_launches``
#: of those that went to csrc/knn_tiled.cu's ring kernel (D != 3)
knn_update_bf_cuda.launches = 0
knn_update_bf_cuda.d3_launches = 0
knn_update_bf_cuda.d3_wide_launches = 0
knn_update_bf_cuda.ring_launches = 0
#: None, or a list to which every launch appends three recorded CUDA
#: events: before the layouts (the ring layouts, ``launch_f32_plan``, or
#: ``d3_lanes``), before the kernel and after it
knn_update_bf_cuda.layout_events = None


def _library() -> ctypes.CDLL:
    from mpi_cuda_largescaleknn_torch.utils.cuda_build import load_library

    lib = load_library("knn_bf")
    # launcher: 4 pointers, 7 ints, the stream
    fn = lib.knn_bf_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if lib.knn_bf_blocks_per_sm.argtypes is None:
        lib.knn_bf_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.knn_bf_blocks_per_sm.restype = ctypes.c_int
    return lib
