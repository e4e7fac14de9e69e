"""The port's traversal (``ops/knn_tiled.py``) against the JAX package's
Pallas kernel ``knn_update_tiled_pallas``, run in interpret mode on the
CPU as ``tests/test_pallas_tiled.py`` runs it: the same partitioned inputs
(converted with ``convert.py``; from D=240 on partitioned by the port,
``jax_inputs``), d2 bitwise equal including the inf
pattern, ids equal. Rows of padding queries are not compared: the Pallas
kernel folds padding lanes into them, the port leaves them untouched, and
``scatter_back`` drops them either way."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import convert
from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk
from mpi_cuda_largescaleknn_torch.ops import partition as tpart
from mpi_cuda_largescaleknn_torch.ops import tiled as ttiled
from mpi_cuda_largescaleknn_torch.ops.distance import elementwise_dist2
from mpi_cuda_largescaleknn_tpu.core.types import CandidateState as JaxState
from mpi_cuda_largescaleknn_tpu.ops.candidates import init_candidates
from mpi_cuda_largescaleknn_tpu.ops.pallas.knn_bf import (
    fold_tile_into_candidates as jfold,
)
from mpi_cuda_largescaleknn_tpu.ops.pallas.knn_tiled import (
    knn_update_tiled_pallas,
)
from mpi_cuda_largescaleknn_tpu.ops.partition import (
    BucketedPoints as JaxBuckets,
)
from mpi_cuda_largescaleknn_tpu.ops.partition import (
    coarsen_buckets,
    partition_points,
)
from mpi_cuda_largescaleknn_tpu.ops.tiled import warm_start_self
from tests.test_torch_ops import assert_bitwise, points


def assert_rows_equal(got: CandidateState, want, qids):
    valid = np.asarray(qids).reshape(-1) >= 0
    assert_bitwise(got.dist2.numpy()[valid], np.asarray(want.dist2)[valid])
    assert_bitwise(got.idx.numpy()[valid], np.asarray(want.idx)[valid])


#: from this D on, ``jax_inputs`` partitions with the port: the JAX
#: package's partition sorts D + 3 operands a level, which XLA takes about
#: three minutes to compile at D=960
PORT_PARTITION_DIM = 240


def jax_inputs(pts, k, bucket_size, group, radius, warm):
    """(q, coarsened resident side, initial state) from the JAX package;
    at D >= PORT_PARTITION_DIM the buckets and the warm start come from the
    port, as the JAX package's types (``tests/test_torch_ops.py`` holds the
    two partitions and warm starts bitwise equal at D=3), so both kernels
    fold the same inputs."""
    if pts.shape[1] < PORT_PARTITION_DIM:
        q = partition_points(jnp.asarray(pts), bucket_size=bucket_size)
        pc = coarsen_buckets(q, group)
        state = (warm_start_self(pc, k, radius) if warm else
                 init_candidates(q.num_buckets * q.bucket_size, k, radius))
        return q, pc, state
    tq = tpart.partition_points(torch.from_numpy(pts),
                                bucket_size=bucket_size)
    tpc = tpart.coarsen_buckets(tq, group)
    q, pc = (JaxBuckets(*(jnp.asarray(t.numpy()) for t in b))
             for b in (tq, tpc))
    if not warm:
        return q, pc, init_candidates(q.num_buckets * q.bucket_size, k,
                                      radius)
    st = ttiled.warm_start_self(tpc, k, radius)
    return q, pc, JaxState(jnp.asarray(st.dist2.numpy()),
                           jnp.asarray(st.idx.numpy()))


CASES = {
    # name: (kind, n, k, bucket_size, group, radius, warm/skip_self, V,
    #        D)
    "k1": ("uniform", 300, 1, 16, 1, math.inf, False, None, 3),
    "k8": ("uniform", 500, 8, 16, 1, math.inf, False, None, 3),
    "k100": ("uniform", 500, 100, 32, 1, math.inf, False, None, 3),
    "k8_radius": ("uniform", 400, 8, 16, 1, 0.09, False, None, 3),
    "k100_radius": ("uniform", 450, 100, 32, 2, 0.2, True, None, 3),
    "k8_skip_self_g2": ("uniform", 600, 8, 16, 2, math.inf, True, None, 3),
    "k1_skip_self_g2": ("clustered", 500, 1, 16, 2, math.inf, True, None, 3),
    "k8_clustered_g2": ("clustered", 560, 8, 16, 2, math.inf, True, None, 3),
    "k8_dupes_g2": ("dupes", 480, 8, 16, 2, math.inf, True, None, 3),
    "k13_dupes": ("dupes", 300, 13, 16, 1, math.inf, False, None, 3),
    "k100_dupes_g2": ("dupes", 500, 100, 32, 2, math.inf, True, None, 3),
    # a row of 32 / 33 entries: one lane slot, then two, in the D=3 warp
    # fold
    "k32_dupes_g2": ("dupes", 480, 32, 32, 2, math.inf, True, None, 3),
    "k33_dupes": ("dupes", 400, 33, 32, 1, math.inf, False, None, 3),
    # 5 real buckets of 8 with V=1/2/3: V=3 leaves a partial last chunk
    "v1": ("uniform", 5 * 16, 6, 16, 1, math.inf, False, 1, 3),
    "v2": ("uniform", 5 * 16, 6, 16, 1, math.inf, False, 2, 3),
    "v3": ("uniform", 5 * 16, 6, 16, 1, math.inf, False, 3, 3),
    "v3_skip_self_g2": ("uniform", 300, 7, 16, 2, math.inf, True, 3, 3),
    # points of other dimensions: the general-D kernel's plain version
    "d4_k8": ("uniform", 400, 8, 16, 1, math.inf, False, None, 4),
    "d4_k8_dupes_g2": ("dupes", 420, 8, 16, 2, math.inf, True, None, 4),
    "d16_k8_skip_self_g2": ("uniform", 500, 8, 16, 2, math.inf, True, None,
                            16),
    "d16_k1_v2": ("normal", 300, 1, 16, 1, math.inf, False, 2, 16),
    "d32_k40_radius_g2": ("normal", 450, 40, 32, 2, 7.0, True, None, 32),
    # D not a multiple of 4: the ring kernel pads to Dp4 (8 and 132)
    "d5_k8_skip_self_g2": ("uniform", 400, 8, 16, 2, math.inf, True, None,
                           5),
    "d130_k6_radius": ("normal", 260, 6, 16, 1, 17.0, False, None, 130),
    # above RESIDENT_MAX_DP4: the ring kernel streams D in slices (GIST's
    # D=960 among them)
    "d240_k10_skip_self_g2": ("normal", 300, 10, 16, 2, math.inf, True,
                              None, 240),
    "d240_k4_radius": ("normal", 260, 4, 16, 1, 22.0, False, None, 240),
    "d960_k10_skip_self_g2": ("normal", 200, 10, 16, 2, math.inf, True,
                              None, 960),
    "d960_k3_radius": ("dupes", 200, 3, 16, 1, 12.5, False, None, 960),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case, monkeypatch):
    # one fold segment: at k >= 32 the Pallas fold extracts one minimum per
    # 128-lane segment per pass, which breaks lane order among EXACT ties
    # across segments (test_fold_keeps_lane_order_on_ties_across_segments);
    # the port keeps the documented lane order, the one-segment result
    monkeypatch.setenv("LSK_FOLD_SEGS", "1")
    kind, n, k, bs, group, radius, warm, visit_batch, dim = CASES[case]
    pts = points(kind, n, seed=n + k, dim=dim)
    q, pc, state = jax_inputs(pts, k, bs, group, radius, warm)
    skip = jnp.int32(1) if warm else None
    want = knn_update_tiled_pallas(state, q, pc, skip_self=skip,
                                   self_group=group, visit_batch=visit_batch)
    got = tk.knn_update_tiled_plain(convert.candidate_state(state),
                                    convert.bucketed_points(q),
                                    convert.bucketed_points(pc),
                                    skip_self=warm, self_group=group)
    assert_rows_equal(got, want, q.ids)
    # the entry point takes the plain version for CPU tensors
    via = tk.knn_update_tiled_cuda(convert.candidate_state(state),
                                   convert.bucketed_points(q),
                                   convert.bucketed_points(pc),
                                   skip_self=warm, self_group=group)
    assert torch.equal(via.dist2, got.dist2)
    assert torch.equal(via.idx, got.idx)


def test_cross_shard_folds_match_pallas():
    # a warm-started shard folding two other shards in turn, as the ring
    # does in its later rounds
    pts = points("uniform", 480, seed=17)
    k, group = 9, 2
    parts = [partition_points(jnp.asarray(pts[a:b]),
                              jnp.arange(a, b, dtype=jnp.int32),
                              bucket_size=16)
             for a, b in ((0, 160), (160, 320), (320, 480))]
    res = [coarsen_buckets(p, group) for p in parts]
    want = warm_start_self(res[0], k)
    want = knn_update_tiled_pallas(want, parts[0], res[0],
                                   skip_self=jnp.int32(1), self_group=group)
    got = ttiled.warm_start_self(convert.bucketed_points(res[0]), k)
    tq = convert.bucketed_points(parts[0])
    got = tk.knn_update_tiled_plain(got, tq, convert.bucketed_points(res[0]),
                                    skip_self=True, self_group=group)
    for other in (1, 2):
        want = knn_update_tiled_pallas(want, parts[0], res[other],
                                       self_group=group)
        got = tk.knn_update_tiled_plain(got, tq,
                                        convert.bucketed_points(res[other]),
                                        self_group=group)
    assert_rows_equal(got, want, parts[0].ids)


@pytest.mark.parametrize("k", [1, 8, 100])
def test_fold_matches_pallas_fold(k):
    """The plain fold against the in-kernel fold (knn_bf.py), whose
    adopted entries are lane positions: decoded through the lane ids they
    must be the same rows, ties included."""
    rng = np.random.default_rng(k)
    s, t = 16, 256
    levels = rng.random(12).astype(np.float32)
    d2 = rng.choice(levels, (s, t)).astype(np.float32)
    d2[:, 5::7] = np.inf
    cd2 = np.sort(rng.choice(np.append(levels, np.inf), (s, k)),
                  axis=1).astype(np.float32)
    cidx = rng.integers(0, 99, (s, k)).astype(np.int32)
    lane_ids = np.arange(1000, 1000 + t, dtype=np.int32)
    w_d2, w_pos = jfold(jnp.asarray(d2), 0, jnp.asarray(cd2),
                        jnp.asarray(cidx))
    w_pos = np.asarray(w_pos)
    w_idx = np.where(w_pos <= -2, lane_ids[np.clip(-2 - w_pos, 0, t - 1)],
                     w_pos)
    got = tk.fold_tile_into_candidates(torch.from_numpy(d2),
                                       torch.from_numpy(lane_ids),
                                       torch.from_numpy(cd2),
                                       torch.from_numpy(cidx))
    assert_bitwise(got.dist2.numpy(), w_d2)
    assert_bitwise(got.idx.numpy(), w_idx)


def test_fold_keeps_lane_order_on_ties_across_segments():
    """Equal distances are adopted in lane order (lower lane first). The
    JAX fold gives that order with one segment; with two it adopts lane
    128 before lane 1 (ROADMAP.md Queue 3). The port keeps lane order."""
    d2 = np.full((1, 256), np.inf, np.float32)
    d2[0, [0, 1, 128]] = 3.0
    cd2 = np.full((1, 2), np.inf, np.float32)
    cidx = np.full((1, 2), -1, np.int32)
    lane_ids = np.arange(256, dtype=np.int32)
    got = tk.fold_tile_into_candidates(torch.from_numpy(d2),
                                       torch.from_numpy(lane_ids),
                                       torch.from_numpy(cd2),
                                       torch.from_numpy(cidx))
    assert got.idx.tolist() == [[0, 1]]
    _, pos = jfold(jnp.asarray(d2), 0, jnp.asarray(cd2), jnp.asarray(cidx),
                   segments=1)
    assert (-2 - np.asarray(pos)).tolist() == [[0, 1]]


def k_smallest_by_d2_then_arrival(row_d2, row_idx, lane_d2, lane_ids, k):
    """The fold's contract: the k smallest of (the row) and (the lanes in
    arrival order) by the key (d2, arrival), the row's own entries
    arriving first. A stable sort of the concatenation."""
    d2 = np.concatenate([row_d2, lane_d2], axis=-1)
    ids = np.concatenate([row_idx, np.broadcast_to(lane_ids, lane_d2.shape)],
                         axis=-1)
    order = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    return (np.take_along_axis(d2, order, -1),
            np.take_along_axis(ids, order, -1))


def grid_d2(rng, shape):
    """Tie-heavy d2: squared distances between integer-grid points."""
    a = rng.integers(0, 4, (*shape, 3)).astype(np.float32)
    return (a * a).sum(-1, dtype=np.float32)


CONTRACT_K = [1, 31, 32, 33, 64, 65, 100]


@pytest.mark.parametrize("k", CONTRACT_K)
def test_fold_is_k_smallest_by_d2_then_arrival(k):
    """``fold_tile_into_candidates`` (strict-< adoption, insert after equal
    entries) keeps exactly the k smallest entries by (d2, arrival) of the
    row and the tile: the contract the D=3 kernels' warp fold is built on.
    Tie-heavy rows (finite, ``-r``-like and +inf slots) across the lane
    borders of a 32-lane spread."""
    rng = np.random.default_rng(k)
    s, t = 6, 300
    lane_d2 = grid_d2(rng, (s, t))
    lane_d2[:, 7::11] = np.inf
    row_d2 = np.sort(grid_d2(rng, (s, k)), axis=1)
    row_d2[1] = np.float32(2.0)           # a -r cutoff: max_radius^2 slots
    row_d2[2, k // 2:] = np.inf           # an underfull row
    row_d2[3] = np.inf                    # an empty row
    row_idx = rng.integers(0, 50, (s, k)).astype(np.int32)
    row_idx[1] = -1
    lane_ids = np.arange(1000, 1000 + t, dtype=np.int32)
    got = tk.fold_tile_into_candidates(
        torch.from_numpy(lane_d2), torch.from_numpy(lane_ids),
        torch.from_numpy(row_d2), torch.from_numpy(row_idx))
    want_d2, want_idx = k_smallest_by_d2_then_arrival(row_d2, row_idx,
                                                      lane_d2, lane_ids, k)
    assert_bitwise(got.dist2.numpy(), want_d2)
    assert_bitwise(got.idx.numpy(), want_idx)


@pytest.mark.parametrize("k", CONTRACT_K)
def test_plain_is_k_smallest_by_d2_then_arrival(k):
    """The plain traversal on integer-grid points (many exact ties) equals
    the contract with lanes arriving in visit order: query bucket b takes
    the point buckets in ``nearest_first_order`` (its own group skipped),
    each in lane order. Pruned buckets need not be listed apart: every
    lane of one is at least the radius away, so it arrives after a tie."""
    rng = np.random.default_rng(100 + k)
    pts = rng.integers(0, 6, (320, 3)).astype(np.float32)
    q = tpart.partition_points(torch.from_numpy(pts), bucket_size=16)
    pc = tpart.coarsen_buckets(q, 2)
    state = ttiled.warm_start_self(pc, k)
    got = tk.knn_update_tiled_plain(state, q, pc, skip_self=True,
                                    self_group=2)
    _, order = tpart.nearest_first_order(q.lower, q.upper, pc.lower,
                                         pc.upper)
    num_qb, s_q = q.ids.shape
    rows_d2 = state.dist2.numpy().reshape(num_qb, s_q, k)
    rows_idx = state.idx.numpy().reshape(num_qb, s_q, k)
    qp, pp, pids = q.pts.numpy(), pc.pts.numpy(), pc.ids.numpy()
    valid = q.ids.numpy() >= 0
    for b in range(num_qb):
        walk = [int(pb) for pb in order[b] if int(pb) != b // 2]
        lp = pp[walk].reshape(-1, 3)
        diff = qp[b][:, None, :] - lp[None]
        with np.errstate(over="ignore"):   # PAD_SENTINEL lanes: +inf
            lane_d2 = (diff[..., 0] * diff[..., 0]
                       + diff[..., 1] * diff[..., 1]) \
                + diff[..., 2] * diff[..., 2]
        want_d2, want_idx = k_smallest_by_d2_then_arrival(
            rows_d2[b], rows_idx[b], lane_d2, pids[walk].reshape(-1), k)
        v = valid[b]
        assert_bitwise(got.dist2.numpy()[b * s_q:(b + 1) * s_q][v],
                       want_d2[v])
        assert_bitwise(got.idx.numpy()[b * s_q:(b + 1) * s_q][v],
                       want_idx[v])


def test_plain_visit_stats_count_scored_buckets():
    pts = points("uniform", 400, seed=2)
    q = tpart.partition_points(torch.from_numpy(pts), bucket_size=16)
    state = ttiled.warm_start_self(q, 4)
    _, per_bucket = tk.knn_update_tiled_plain(state, q, q, skip_self=True,
                                              with_stats=True)
    assert per_bucket.shape == (q.num_buckets,)
    assert per_bucket.dtype == torch.int64
    # at least one neighbour bucket per query bucket, far below all pairs
    visits = int(per_bucket.sum())
    assert q.num_buckets <= visits < q.num_buckets ** 2 - q.num_buckets
    # the entry point on the CPU returns the same counts
    _, same = tk.knn_update_tiled_cuda(state, q, q, skip_self=True,
                                       with_stats=True)
    assert torch.equal(same, per_bucket)
    # every bucket of real queries scores a neighbour; padding ones none
    real = (q.ids >= 0).any(dim=1)
    assert bool((per_bucket[real] >= 1).all())
    assert not bool(per_bucket[~real].any())


@pytest.mark.parametrize("s_q,t_p,k,want", [
    (248, 496, 8, (32, 256, 512)),
    (248, 496, 100, (32, 256, 512)),
    (256, 512, 1, (32, 256, 512)),
    # above D3_SLOTS_MAX_K: the wide fold, a step of WIDE_TILE_LANES
    (248, 496, 200, (32, 256, 256)),
    (16, 4096, 8, (16, 128, 1024)),
])
def test_launch_geometry(s_q, t_p, k, want):
    """D=3: warps of 4 query rows (8 threads a row), 8 warps a block (a
    bucket's rows split over blocks), whole 256-lane chunks a tile; at least
    two blocks fit on an SM in shared memory and in registers (64 a
    thread on slots a lane: at k=100 four blocks, 32 warps resident; 128
    on the wide fold, which stages no tile)."""
    rows, threads, lanes = tk.launch_geometry(s_q, t_p, k)
    assert (rows, threads, lanes) == want
    assert threads == 8 * rows and threads % 32 == 0
    assert lanes % tk.CHUNK_LANES == 0 and lanes <= tk.D3_MAX_TILE_LANES
    slots = tk.d3_slots(k)
    smem = tk.d3_smem_bytes(rows, lanes, k, "traversal")
    if slots:
        assert smem == 2 * 16 * lanes + rows * 32 * slots * 8 + 32
    else:
        assert smem == (rows // 4 * (tk.WIDE_WARP_BYTES + tk.WIDE_TAIL_BYTES)
                        + tk.WIDE_CTRL_BYTES)
    assert smem == tk.tiled_launch_plan(s_q, t_p, k, 3).smem
    assert smem <= tk.SMEM_OPTIN - 1024
    assert 2 * (smem + 1024) <= tk.SMEM_SM
    assert 2 * threads * tk.d3_regs(k) <= 65_536
    assert tk.d3_blocks_per_sm(threads, smem, tk.d3_regs(k)) >= 2


@pytest.mark.parametrize("s_q,t_p,k,dim,want", [
    (248, 496, 10, 128, ("ring", 3, True, 0)),
    (248, 496, 100, 128, ("ring", 3, False, 0)),
    (248, 496, 8, 4, ("ring", 3, True, 0)),
    (1000, 2000, 10, 16, ("ring", 3, True, 0)),
    (16, 20, 1, 960, ("stream", 3, True, 16)),
])
def test_launch_geometry_general_d(s_q, t_p, k, dim, want):
    """Every D other than 3 plans the ring kernel's fixed block (128 rows,
    64-lane chunks, 288 threads) whatever the bucket sizes: its stages,
    where the rows sit and the slices of D follow from Dp4 and k alone, and
    its shared memory fits what a block may opt into."""
    plan = tk.tiled_launch_plan(s_q, t_p, k, dim)
    assert (plan.kernel, plan.stages, plan.rows_in_smem,
            plan.slice_groups) == want
    assert (plan.rows, plan.lanes, plan.threads) == (
        tk.RING_ROWS, tk.RING_LANES, tk.RING_THREADS)
    assert plan == tk.tiled_launch_plan(tk.RING_ROWS, tk.RING_LANES, k, dim)
    assert plan.smem == tk.ring_smem_bytes(plan.dp4, k, plan.stages,
                                           plan.rows_in_smem,
                                           plan.slice_groups)
    assert plan.smem <= tk.SMEM_OPTIN - 1024


#: k above the 903 the first D=3 kernels took (the wide fold), across the
#: borders of the instances' slots a lane (1024, 2048, 4096) and beyond
LARGE_K = [904, 1000, 1024, 1025, 2048, 4096, 4097, 8192, 16384]
#: the smallest k of the wide fold, where the plans change kernel
CROSSOVER_K = [tk.D3_SLOTS_MAX_K, tk.D3_SLOTS_MAX_K + 1]


def first_d3_block(rows, lanes, k):
    """The D=3 plan as it stood for the k the first kernels took (up to
    903): a power of two of slots a lane, its rows beside two tiles, warps
    shed until two blocks fit on an SM. Returns (rows, threads, smem)."""
    slots = 1
    while 32 * slots < k:
        slots *= 2

    def smem(r):
        return 2 * 16 * lanes + r * slots * 32 * 8 + 32

    warps = max(1, min(tk.D3_MAX_WARPS, -(-rows // tk.WARP_ROWS)))
    while warps > 1 and min(2048 // (32 * warps),
                            65_536 // (32 * warps * tk.D3_REGS),
                            tk.SMEM_SM // (smem(4 * warps) + 1024)) < 2:
        warps -= 1
    return 4 * warps, 32 * warps, smem(4 * warps)


def wide_d3_block(rows, stages):
    """The wide fold's plan, written out: a warp's pending buffers
    (``WIDE_WARP_BYTES``: the sort's keys and four rows' buffers of d2 and
    ids) beside ``stages`` staged tiles of ``WIDE_TILE_LANES`` (the flat
    fold's ring) or, with none (the traversal), the rows' tails of
    ``WIDE_BUFFER + 1`` d2 each, and ``WIDE_CTRL_BYTES`` of barriers,
    counts and radius slots, warps shed until two blocks of
    ``WIDE_REGS`` registers a thread fit on an SM. Returns (rows, threads,
    smem)."""
    warp_bytes = tk.WIDE_SORT * 8 + tk.WARP_ROWS * tk.WIDE_BUFFER * 8
    if not stages:
        warp_bytes += -(-4 * (tk.WIDE_BUFFER + 1) * 4 // 16) * 16

    def smem(r):
        return (stages * 16 * tk.WIDE_TILE_LANES + r // 4 * warp_bytes
                + tk.WIDE_CTRL_BYTES)

    warps = max(1, min(tk.D3_MAX_WARPS, -(-rows // tk.WARP_ROWS)))
    while warps > 1 and min(2048 // (32 * warps),
                            65_536 // (32 * warps * tk.WIDE_REGS),
                            tk.SMEM_SM // (smem(4 * warps) + 1024)) < 2:
        warps -= 1
    return 4 * warps, 32 * warps, smem(4 * warps)


@pytest.mark.parametrize("k", sorted(set(LARGE_K + CROSSOVER_K[1:])))
def test_d3_plans_large_k(k):
    """k above ``D3_SLOTS_MAX_K`` plans on the D=3 kernels' wide fold (no
    slots a lane): its rows in place in device memory, no tile staged (a
    warp reads its lanes, ``WIDE_TILE_LANES`` between two decisions, from
    device memory), a block's shared memory its warps' pending buffers,
    counted by ``d3_smem_bytes``, whatever the bucket sizes; every plan
    fits what a block may opt into, says where its rows sit, and keeps at
    least two blocks on an SM."""
    assert tk.d3_slots(k) == 0
    for s_q, t_p in ((248, 496), (4000, 256), (16, 4096), (1, 1)):
        plan = tk.tiled_launch_plan(s_q, t_p, k, 3)
        rows, threads, lanes = tk.launch_geometry(s_q, t_p, k)
        assert (plan.kernel, plan.rows, plan.threads, plan.lanes,
                plan.stages) == ("d3", rows, threads, lanes, 0)
        assert lanes == tk.WIDE_TILE_LANES
        assert not plan.rows_in_smem
        assert (rows, threads, plan.smem) == wide_d3_block(
            min(s_q, 4 * tk.D3_TILED_WARPS), 0)
        assert plan.smem == tk.d3_smem_bytes(rows, lanes, k, "traversal") \
            == (rows // 4 * (tk.WIDE_WARP_BYTES + tk.WIDE_TAIL_BYTES)
                + tk.WIDE_CTRL_BYTES)
        assert plan.smem <= tk.SMEM_OPTIN - 1024
        assert tk.d3_blocks_per_sm(threads, plan.smem, tk.WIDE_REGS) >= 2
    for rows_wanted in (248, 2048):
        lanes = tk.d3_tile_lanes(1024, k)
        for kernel, stages in (("traversal", 0), ("flat", tk.WIDE_STAGES)):
            assert tk.d3_stages(k, kernel) == stages
            rows, threads = tk.d3_block(rows_wanted, lanes, k, kernel)
            smem = tk.d3_smem_bytes(rows, lanes, k, kernel)
            assert (rows, threads, smem) == wide_d3_block(rows_wanted, stages)
            assert smem <= tk.SMEM_OPTIN - 1024


@pytest.mark.parametrize("k", [1, 8, 32, 33, 100, 200, 500, 873, 896, 903])
def test_d3_plans_take_every_k_the_first_kernels_took(k):
    """Every k the first D=3 kernels took (up to 903) plans blocks of both
    kernels that fit twice on an SM: up to ``D3_SLOTS_MAX_K`` (where the
    wide fold stops winning, ``tools/torch_d3_k_sweep.py``) the plan these
    k had before the wide fold (``first_d3_block``), its rows in shared
    memory beside two tiles; above it the wide fold's (``wide_d3_block``),
    its rows in device memory, with no tile staged in the traversal
    (``tiled_launch_plan``) and the ring of ``WIDE_STAGES`` in the flat
    fold (``flat_d3_plan``)."""
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import flat_d3_plan

    wide = k > tk.D3_SLOTS_MAX_K
    for rows_wanted, asked in ((248, 512), (2048, 1024), (16, 256)):
        lanes = tk.d3_tile_lanes(asked, k)
        assert lanes == (tk.WIDE_TILE_LANES if wide else asked)
        tplan = tk.tiled_launch_plan(rows_wanted, asked, k, 3)
        fplan = flat_d3_plan(rows_wanted, asked, k)
        for kernel, plan, wanted in (
                ("traversal", tplan, min(rows_wanted,
                                         4 * tk.D3_TILED_WARPS)),
                ("flat", fplan, rows_wanted)):
            stages = (tk.WIDE_STAGES if kernel == "flat" else 0) if wide \
                else 2
            rows, threads = tk.d3_block(wanted, lanes, k, kernel)
            smem = tk.d3_smem_bytes(rows, lanes, k, kernel)
            assert rows % tk.WARP_ROWS == 0 and threads == 8 * rows
            assert tk.d3_blocks_per_sm(threads, smem, tk.d3_regs(k)) >= 2
            assert (rows, threads, smem) \
                == (wide_d3_block(wanted, stages) if wide
                    else first_d3_block(wanted, lanes, k))
            assert (plan.rows, plan.threads, plan.lanes, plan.stages,
                    plan.smem) == (rows, threads, lanes, stages, smem)
    slots = tk.d3_slots(k)
    if wide:
        assert slots == 0
    else:
        assert 32 * slots >= k and (slots == 1 or 16 * slots < k)
    assert tk.tiled_launch_plan(248, 496, k, 3).rows_in_smem is not wide


def _header_constants():
    text = (Path(tk.__file__).resolve().parents[1] / "csrc"
            / "knn_rows.cuh").read_text()
    names = ("kSlotsMaxK", "kWideBuffer", "kWideSort", "kWideStages",
             "kWideCtrlBytes", "kWarpRows", "kChunkLanes", "kChunkGroups")
    found = {}
    for name in names:
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, name
        found[name] = m.group(1).strip()
    return found


def test_the_header_holds_the_plans_constants():
    """``csrc/knn_rows.cuh`` and the Python plan agree: the largest k of
    the instances of slots a lane (``kSlotsMaxK`` / ``D3_SLOTS_MAX_K``),
    the wide fold's buffer (``kWideBuffer`` / ``WIDE_BUFFER``), its sort's
    scratch (``kWideSort`` / ``WIDE_SORT``, a power of two that holds a
    buffer), a warp's shared memory (``kWideWarpBytes`` /
    ``WIDE_WARP_BYTES``), the ring's stages and control bytes
    (``kWideStages`` / ``WIDE_STAGES``, ``kWideCtrlBytes`` /
    ``WIDE_CTRL_BYTES``), the warp fold's rows and chunks, and the
    instances of slots a lane the launchers dispatch to."""
    c = _header_constants()
    assert int(c["kSlotsMaxK"]) == tk.D3_SLOTS_MAX_K
    assert int(c["kWideBuffer"]) == tk.WIDE_BUFFER
    assert int(c["kWideSort"]) == tk.WIDE_SORT
    assert int(c["kWideStages"]) == tk.WIDE_STAGES
    assert int(c["kWideCtrlBytes"]) == tk.WIDE_CTRL_BYTES
    assert int(c["kWarpRows"]) == tk.WARP_ROWS
    assert c["kChunkLanes"] == "32 * kChunkGroups"
    assert 32 * int(c["kChunkGroups"]) == tk.CHUNK_LANES
    assert tk.WIDE_BUFFER <= tk.WIDE_SORT
    assert tk.WIDE_SORT & (tk.WIDE_SORT - 1) == 0
    assert tk.WIDE_WARP_BYTES == (tk.WIDE_SORT * 8
                                  + tk.WARP_ROWS * tk.WIDE_BUFFER * 8)
    assert tk.WIDE_WARP_BYTES % 16 == 0
    assert tk.WIDE_TAIL_BYTES == -(-tk.WARP_ROWS * (tk.WIDE_BUFFER + 1) * 4
                                   // 16) * 16
    assert tk.WIDE_TILE_LANES % tk.CHUNK_LANES == 0
    # the wide kernels' __launch_bounds__(kD3MaxThreads, blocks) give each
    # thread WIDE_REGS registers; the instances of slots a lane D3_REGS
    csrc = Path(tk.__file__).resolve().parents[1] / "csrc"
    assert int(re.search(r"constexpr int kD3MaxThreads = (\d+);",
                         (csrc / "knn_rows.cuh").read_text()).group(1)) \
        == tk.D3_MAX_WARPS * 32
    for src, kern in (("knn_tiled.cu", "knn_tiled_d3_wide_kernel"),
                      ("knn_bf.cu", "knn_bf_d3_wide_kernel")):
        m = re.search(r"__launch_bounds__\(knn::kD3MaxThreads, (\d)\)\s*"
                      + kern, (csrc / src).read_text())
        assert m, kern
        assert 65_536 // (tk.D3_MAX_WARPS * 32 * int(m.group(1))) \
            == tk.WIDE_REGS
    # the launchers' instances of slots a lane (with_d3_slots's cases) are
    # the slots the plans give up to kSlotsMaxK, and no more
    body = re.search(r"int with_d3_slots\(.*?\n}\n",
                     (csrc / "knn_rows.cuh").read_text(), re.S).group(0)
    cases = {int(s) for s in re.findall(r"case (\d+):", body)}
    assert cases == {tk.d3_slots(k)
                     for k in range(1, tk.D3_SLOTS_MAX_K + 1)}


#: warps an SM holds on the wide fold's plans (two blocks of 8 warps:
#: its registers and its buffers bound both)
WIDE_WARPS_PER_SM = 16


@pytest.mark.parametrize("k", sorted(set(LARGE_K + CROSSOVER_K[1:])))
def test_d3_plans_hold_the_planned_warps(k):
    """The main paths' wide-fold plans keep ``WIDE_WARPS_PER_SM`` warps on
    an SM, their pending buffers and tails included: the traversal's
    8-warp blocks at a bucket of 248 rows against coarsened buckets of 496
    lanes and at the device merge's one bucket of 131,072 rows."""
    for s_q in (248, 131_072):
        plan = tk.tiled_launch_plan(s_q, 496, k, 3)
        assert plan.threads == 32 * tk.D3_TILED_WARPS
        assert tk.d3_blocks_per_sm(plan.threads, plan.smem, tk.d3_regs(k)) \
            * plan.threads // 32 == WIDE_WARPS_PER_SM


def test_d3_lanes_layout():
    """The D=3 kernels' staged lanes: {x, y, z, id bits} bit for bit, and
    lanes past N NaN with id -1, whose d2 is NaN: no strict-< compare
    adopts it."""
    pts = torch.from_numpy(points("dupes", 2 * 37, seed=5)).view(2, 37, 3)
    ids = torch.arange(74, dtype=torch.int32).view(2, 37) - 3
    lanes = tk.d3_lanes(pts, ids, 256)
    assert lanes.shape == (2, 256, 4) and lanes.is_contiguous()
    assert_bitwise(lanes[:, :37, :3].numpy(), pts.numpy())
    bits = lanes.view(torch.int32)
    assert torch.equal(bits[:, :37, 3], ids)
    assert bool((bits[:, 37:, 3] == -1).all())
    assert bool(lanes[:, 37:, :3].isnan().all())
    d2 = elementwise_dist2(pts[:, :4], lanes[..., :3])
    assert bool(d2[:, :, 37:].isnan().all())
    assert not bool((d2[:, :, 37:] < torch.inf).any())


@pytest.mark.parametrize("s_q,t_p,k,dim,want", [
    # phase 10's shape: rows in shared memory beside a 3-stage ring
    (248, 496, 10, 128, ("ring", 128, 64, 288, 128, 3, True)),
    # k=100 at D=128: the rows stay in device memory
    (248, 496, 100, 128, ("ring", 128, 64, 288, 128, 3, False)),
    (248, 496, 10, 5, ("ring", 128, 64, 288, 8, 3, True)),
    (1000, 2000, 10, 130, ("ring", 128, 64, 288, 132, 3, True)),
    # the largest Dp4 the ring takes: 2 stages, rows in device memory
    (248, 496, 10, 224, ("ring", 128, 64, 288, 224, 2, False)),
    # above it D is streamed: 57 float4 groups in 4 slices of 15, and 240
    # in 15 slices of 16
    (248, 496, 10, 225, ("stream", 128, 64, 288, 228, 3, True)),
    (16, 20, 1, 960, ("stream", 128, 64, 288, 960, 3, True)),
    (248, 496, 8, 3, ("d3", 32, 512, 256, 4, 2, True)),
])
def test_tiled_launch_plan(s_q, t_p, k, dim, want):
    """The f32 route is by D and Dp4: D=3 on knn_tiled_d3_kernel with
    launch_geometry's block, other D on the ring kernel (whose shared memory
    fits what a block may opt into): the queries resident up to
    RESIDENT_MAX_DP4, D streamed in slices above it."""
    plan = tk.tiled_launch_plan(s_q, t_p, k, dim)
    assert tuple(plan[:7]) == want
    if plan.kernel == "d3":
        assert plan.smem == tk.d3_smem_bytes(plan.rows, plan.lanes, k,
                                             "traversal")
        rows, threads, lanes = tk.launch_geometry(s_q, t_p, k)
        assert (plan.rows, plan.threads, plan.lanes) == (rows, threads,
                                                         lanes)
        return
    assert plan.smem == tk.ring_smem_bytes(plan.dp4, k, plan.stages,
                                           plan.rows_in_smem,
                                           plan.slice_groups)
    assert plan.smem <= tk.SMEM_OPTIN - 1024
    assert plan.threads == tk.RING_THREADS
    if plan.kernel == "stream":
        groups = plan.dp4 // 4
        g = plan.slice_groups
        assert g == tk.stream_slice_groups(plan.dp4)
        assert 0 < g <= tk.STREAM_SLICE_GROUPS
        # the fewest slices, and none of them empty
        slices = -(-groups // g)
        assert slices == -(-groups // tk.STREAM_SLICE_GROUPS)
        assert groups - (slices - 1) * g > 0
    else:
        assert plan.slice_groups == 0


def test_ring_max_dp4_is_the_largest_the_plan_takes():
    """RESIDENT_MAX_DP4 is the largest Dp4 whose queries and a 2-stage
    chunk ring fit in shared memory; above it the plan streams D, whose
    stages fit at any Dp4. The rows go to device memory where they must,
    so both take any k."""
    budget = tk.SMEM_OPTIN - 1024
    top = tk.RESIDENT_MAX_DP4
    assert top >= 128 and top % 4 == 0
    assert tk.ring_smem_bytes(top, 10_000, 2, False) <= budget
    assert tk.ring_smem_bytes(top + 4, 1, 2, False) > budget
    assert tk.tiled_launch_plan(248, 496, 10, top).kernel == "ring"
    assert tk.tiled_launch_plan(248, 496, 10, top + 1).kernel == "stream"
    groups = tk.STREAM_SLICE_GROUPS
    assert tk.ring_smem_bytes(top + 4, 10_000, 3, False, groups) <= budget
    # rows in device memory: both routes take any k
    assert tk.tiled_launch_plan(248, 496, 2000, 128).kernel == "ring"
    assert tk.tiled_launch_plan(248, 496, 2000, 240).kernel == "stream"


@pytest.mark.parametrize("dim", [128, 240, 960])
def test_traversal_plans_k1000(dim):
    """k=1000 plans at D=128, 240 and 960 (the old general-D kernel
    raised once 32 rows of k no longer fit in shared memory): the rows stay
    in device memory beside a 3-stage ring."""
    plan = tk.tiled_launch_plan(248, 496, 1000, dim)
    assert plan.kernel == ("ring" if dim <= tk.RESIDENT_MAX_DP4
                           else "stream")
    assert (plan.stages, plan.rows_in_smem) == (3, False)
    assert plan.smem <= tk.SMEM_OPTIN - 1024


def kernel_walk_dist2(q_ring, p_ring, plan, num_pb, t_pad):
    """d2 of the first query block's 128 rows against every lane of every
    point bucket, read from the two layouts as the ring kernel reads them:
    chunk by chunk, each chunk's slices of ``plan.slice_groups`` float4
    groups in ascending order (one slice of all of them when the queries
    are resident), each a (block, slice) and a (chunk, slice) run at its
    flat float4 offset; components accumulate left to right from +0 into
    the chunk's tile. Returns f32[num_pb, 128, t_pad]."""
    d4n = plan.dp4 // 4
    g = plan.slice_groups or d4n
    rows, lanes = plan.rows, plan.lanes
    nch = t_pad // lanes
    qf, pf = q_ring.reshape(-1, 4), p_ring.reshape(-1, 4)
    out = torch.empty(num_pb, rows, t_pad)
    for pb in range(num_pb):
        for c in range(nch):
            acc = torch.zeros(rows, lanes)
            for g0 in range(0, d4n, g):
                gn = min(g, d4n - g0)
                qs = qf[g0 * rows:(g0 + gn) * rows].view(gn, rows, 4)
                at = ((pb * nch + c) * d4n + g0) * lanes
                ps = pf[at:at + gn * lanes].view(gn, lanes, 4)
                for d4 in range(gn):
                    for x in range(4):
                        diff = qs[d4, :, None, x] - ps[d4, None, :, x]
                        acc = acc + diff * diff
            out[pb, :, c * lanes:(c + 1) * lanes] = acc
    return out


@pytest.mark.parametrize("t,dim", [(100, 5), (64, 128), (130, 130),
                                   (70, 240), (65, 960)])
def test_ring_layout_matches_plain_distances(t, dim):
    """The ring kernel's layouts, read back: real lanes hold the points bit
    for bit (zero padding components add +0), lanes added to fill the last
    chunk are NaN (the wrapper's fill), whose d2 no strict-< compare adopts,
    and the walk of the kernel over the flat layouts (a chunk whole, or
    slice by slice where D is streamed: D=240 in 4 slices of 15 groups,
    D=960 in 15 of 16) gives every real lane ``elementwise_dist2``'s
    bits."""
    pts = torch.from_numpy(points("normal", 2 * t, seed=t + dim, dim=dim)
                           ).view(2, t, dim)
    plan = tk.tiled_launch_plan(t, t, 4, dim)
    assert plan.kernel == ("ring" if dim <= 130 else "stream")
    t_pad = -(-t // plan.lanes) * plan.lanes
    ring = tk.ring_layout(pts, t_pad, plan.lanes, plan.dp4, float("nan"))
    assert ring.shape == (2, t_pad // plan.lanes, plan.dp4 // 4, plan.lanes,
                          4)
    back = ring.transpose(2, 3).reshape(2, t_pad, plan.dp4)
    assert_bitwise(back[:, :t, :dim].numpy(), pts.numpy())
    assert not back[:, :t, dim:].any()
    assert bool(back[:, t:, :dim].isnan().all())
    queries = torch.from_numpy(points("normal", 2 * 7, seed=dim, dim=dim)
                               ).view(2, 7, dim)
    q_ring = tk.ring_layout(queries, plan.rows, plan.rows, plan.dp4, 0.0)
    got = kernel_walk_dist2(q_ring, ring, plan, 2, t_pad)[:, :7]
    for pb in range(2):
        assert_bitwise(got[pb, :, :t].numpy(),
                       elementwise_dist2(queries[0], pts[pb]).numpy())
    assert bool(got[:, :, t:].isnan().all())
    assert not bool((got[:, :, t:] < torch.inf).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dim,k", [(5, 10), (128, 10), (128, 100),
                                   (240, 10), (960, 10), (128, 1000)])
def test_ring_kernel_matches_plain_on_the_card(dim, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pts = torch.from_numpy(points("normal", 8_000, seed=dim + k, dim=dim)
                           ).cuda()
    q = tpart.partition_points(pts, bucket_size=256)
    pc = tpart.coarsen_buckets(q, 2)
    state = ttiled.warm_start_self(pc, k)
    want = tk.knn_update_tiled_plain(state, q, pc, skip_self=True,
                                     self_group=2)
    route = tk.tiled_launch_plan(q.bucket_size, pc.bucket_size, k,
                                 dim).kernel
    counter = "stream_launches" if route == "stream" else "ring_launches"
    before = getattr(tk.knn_update_tiled_cuda, counter)
    got = tk.knn_update_tiled_cuda(state, q, pc, skip_self=True,
                                   self_group=2)
    torch.cuda.synchronize()
    assert getattr(tk.knn_update_tiled_cuda, counter) == before + 1
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 100])
def test_kernel_matches_plain_on_the_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pts = torch.from_numpy(points("uniform", 20_000, seed=k)).cuda()
    q = tpart.partition_points(pts, bucket_size=256)
    pc = tpart.coarsen_buckets(q, 2)
    state = ttiled.warm_start_self(pc, k)
    want = tk.knn_update_tiled_plain(state, q, pc, skip_self=True,
                                     self_group=2)
    before = tk.knn_update_tiled_cuda.d3_launches
    got = tk.knn_update_tiled_cuda(state, q, pc, skip_self=True,
                                   self_group=2)
    torch.cuda.synchronize()
    assert tk.knn_update_tiled_cuda.d3_launches == before + 1
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)
