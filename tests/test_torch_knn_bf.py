"""The port's flat brute force (``ops/knn_bf.py``) against the JAX package's
Pallas kernel ``knn_update_pallas``, run in interpret mode on the CPU as
``tests/test_pallas_knn.py`` runs it: the same numpy inputs through both,
d2 bitwise equal including the inf pattern, ids equal. The Pallas side
pins ``LSK_FOLD_SEGS=1``: at k >= 32 its multi-segment fold breaks lane
order among exact ties (ROADMAP.md Queue 3), the port keeps lane order."""

import math

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
from mpi_cuda_largescaleknn_torch.ops import candidates as tcand
from mpi_cuda_largescaleknn_torch.ops import knn_bf as tb
from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk
from mpi_cuda_largescaleknn_tpu.core.types import pad_points
from mpi_cuda_largescaleknn_tpu.ops.candidates import init_candidates
from mpi_cuda_largescaleknn_tpu.ops.pallas.knn_bf import knn_update_pallas
from tests.oracle import kth_nn_dist, random_points
from tests.test_torch_knn_tiled import (
    CONTRACT_K,
    k_smallest_by_d2_then_arrival,
)
from tests.test_torch_ops import assert_bitwise, points


@pytest.fixture(autouse=True)
def one_fold_segment(monkeypatch):
    monkeypatch.setenv("LSK_FOLD_SEGS", "1")


def port_update(state, queries, pts, ids=None, **tiles):
    """The port's wrapper on CPU tensors (its plain version)."""
    st = tcand.CandidateState(torch.from_numpy(np.array(state.dist2)),
                              torch.from_numpy(np.array(state.idx)))
    return tb.knn_update_bf_cuda(
        st, torch.from_numpy(np.array(queries)),
        torch.from_numpy(np.array(pts)),
        None if ids is None else torch.from_numpy(np.array(ids)), **tiles)


def assert_state_equal(got, want):
    assert_bitwise(got.dist2.numpy(), np.asarray(want.dist2))
    assert_bitwise(got.idx.numpy(), np.asarray(want.idx))


CASES = {
    # name: (kind, n queries, n points, k, max_radius, D)
    "self_n100_k1": ("uniform", 100, None, 1, math.inf, 3),
    "self_n300_k8": ("uniform", 300, None, 8, math.inf, 3),
    "self_n520_k17": ("uniform", 520, None, 17, math.inf, 3),
    "q130_p400_k9": ("uniform", 130, 400, 9, math.inf, 3),
    "k_above_n": ("uniform", 5, None, 8, math.inf, 3),
    "radius_k10": ("uniform", 260, None, 10, 0.05, 3),
    "dupes_k8": ("dupes", 300, None, 8, math.inf, 3),
    "dupes_k40": ("dupes", 300, None, 40, math.inf, 3),
    "clustered_k33": ("clustered", 280, None, 33, math.inf, 3),
    "self_n300_k100": ("uniform", 300, None, 100, math.inf, 3),
    "radius_k64": ("uniform", 280, None, 64, 0.2, 3),
    # a row of 32 / 33 entries: one lane slot, then two, in the D=3 warp
    # fold
    "dupes_k32": ("dupes", 300, None, 32, math.inf, 3),
    "dupes_k33": ("dupes", 300, None, 33, math.inf, 3),
    # points of other dimensions: the general-D kernel's plain version
    "d4_self_k8": ("uniform", 300, None, 8, math.inf, 4),
    "d4_q130_p400_k9_dupes": ("dupes", 130, 400, 9, math.inf, 4),
    "d16_self_k8": ("normal", 260, None, 8, math.inf, 16),
    "d16_radius_k40": ("normal", 280, None, 40, 5.0, 16),
    # above RESIDENT_MAX_DP4: the ring kernel streams D in slices
    "d240_q70_p200_k10": ("normal", 70, 200, 10, math.inf, 240),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case):
    kind, nq, npts, k, radius, dim = CASES[case]
    pts = points(kind, npts or nq, seed=nq + k, dim=dim)
    q = pts if npts is None else points(kind, nq, seed=nq + k + 1, dim=dim)
    state = init_candidates(nq, k, max_radius=radius)
    want = knn_update_pallas(state, q, pts, query_tile=64, point_tile=128)
    got = port_update(state, q, pts, query_tile=64, point_tile=128)
    assert_state_equal(got, want)
    if npts is None:
        np.testing.assert_allclose(
            tcand.extract_final_result(got).numpy(),
            kth_nn_dist(pts, pts, k, radius), rtol=5e-7, atol=1e-37)


def test_incremental_rounds_match_pallas_and_one_call():
    pts = random_points(384, seed=5)
    q = random_points(96, seed=6)
    k = 7
    state = init_candidates(96, k)
    want = knn_update_pallas(state, q, pts[:150], query_tile=32,
                             point_tile=128)
    want = knn_update_pallas(want, q, pts[150:],
                             point_ids=np.arange(150, 384, dtype=np.int32),
                             query_tile=32, point_tile=128)
    got = port_update(state, q, pts[:150])
    got = tb.knn_update_bf_cuda(got, torch.from_numpy(q),
                                torch.from_numpy(pts[150:]),
                                torch.arange(150, 384, dtype=torch.int32))
    assert_state_equal(got, want)
    one = port_update(state, q, pts)
    assert torch.equal(one.dist2, got.dist2) and torch.equal(one.idx, got.idx)


def test_sentinel_points_are_inert_and_match_pallas():
    pts = random_points(100, seed=9)
    padded, _ = pad_points(pts, 160)
    padded = np.asarray(padded)
    ids = np.where(np.arange(160) < 100, np.arange(160), -1).astype(np.int32)
    k = 4
    state = init_candidates(100, k)
    want = knn_update_pallas(state, pts, padded, point_ids=ids,
                             query_tile=32, point_tile=128)
    got = port_update(state, pts, padded, ids)
    assert_state_equal(got, want)
    ref = port_update(state, pts, pts)
    assert torch.equal(got.dist2, ref.dist2) and torch.equal(got.idx, ref.idx)


def test_padding_query_rows_match_pallas():
    # sentinel queries against sentinel points score 0 and adopt id -1, in
    # the TPU kernel and the port alike
    pts, _ = pad_points(random_points(70, seed=4), 96)
    pts = np.asarray(pts)
    ids = np.where(np.arange(96) < 70, np.arange(96), -1).astype(np.int32)
    state = init_candidates(96, 5)
    want = knn_update_pallas(state, pts, pts, point_ids=ids, query_tile=32,
                             point_tile=128)
    got = port_update(state, pts, pts, ids)
    assert_state_equal(got, want)
    assert np.all(got.dist2.numpy()[70:] == 0.0)
    assert np.all(got.idx.numpy()[70:] == -1)


def test_point_ids_with_an_offset():
    pts = random_points(200, seed=11)
    ids = np.arange(5000, 5200, dtype=np.int32)
    state = init_candidates(200, 5)
    want = knn_update_pallas(state, pts, pts, point_ids=ids, query_tile=64,
                             point_tile=128)
    got = port_update(state, pts, pts, ids)
    assert_state_equal(got, want)
    assert got.idx.min() >= 5000


@pytest.mark.parametrize("query_tile,point_tile", [
    (1, 1), (7, 13), (32, 128), (100, 77), (4096, 4096)])
def test_tiles_do_not_change_the_result(query_tile, point_tile):
    pts = points("dupes", 330, seed=21)
    state = init_candidates(330, 12, max_radius=0.3)
    base = port_update(state, pts, pts)
    got = port_update(state, pts, pts, query_tile=query_tile,
                      point_tile=point_tile)
    assert torch.equal(got.dist2, base.dist2)
    assert torch.equal(got.idx, base.idx)


def test_empty_inputs_return_the_state():
    st = tcand.init_candidates(4, 3)
    got = tb.knn_update_bf_cuda(st, torch.zeros(4, 3),
                                torch.zeros(0, 3))
    assert got is st


@pytest.mark.parametrize("k", CONTRACT_K)
def test_plain_is_k_smallest_by_d2_then_arrival(k):
    """The flat plain version on integer-grid points (many exact ties)
    equals the contract the D=3 kernel's warp fold is built on: the k
    smallest by (d2, arrival) of the row as it came in (here the rows of a
    first call, -r slots included) and the points in row order."""
    rng = np.random.default_rng(200 + k)
    pts = rng.integers(0, 5, (300, 3)).astype(np.float32)
    q = pts[:90]
    ids = np.arange(300, dtype=np.int32)
    state = tcand.init_candidates(90, k, max_radius=2.0)
    first = tb.knn_update_bf_plain(state, torch.from_numpy(q),
                                   torch.from_numpy(pts[:120]),
                                   torch.from_numpy(ids[:120]))
    got = tb.knn_update_bf_plain(first, torch.from_numpy(q),
                                 torch.from_numpy(pts[120:]),
                                 torch.from_numpy(ids[120:]))
    diff = q[:, None, :] - pts[None, 120:]
    lane_d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    want_d2, want_idx = k_smallest_by_d2_then_arrival(
        first.dist2.numpy(), first.idx.numpy(), lane_d2, ids[120:], k)
    assert_bitwise(got.dist2.numpy(), want_d2)
    assert_bitwise(got.idx.numpy(), want_idx)


@pytest.mark.parametrize("query_tile,point_tile,k,want", [
    (2048, 2048, 8, (64, 1024)),
    (2048, 2048, 100, (64, 1024)),
    # above D3_SLOTS_MAX_K: the wide fold's ring of WIDE_TILE_LANES tiles
    (2048, 2048, 200, (32, 256)),
    (96, 300, 100, (64, 512)),
    (50, 5000, 1, (52, 1024)),
])
def test_launch_geometry(query_tile, point_tile, k, want):
    """D=3: warps of 4 query rows, at most 16 a block, fewer where two
    blocks would not fit on an SM; tiles of whole 256-lane chunks, at most
    1024 lanes. Two blocks fit in shared memory and in registers (8
    threads a row; 64 registers a thread on slots a lane: 32 warps
    resident at k=8 and k=100; 128 on the wide fold)."""
    rows, lanes = tb.launch_geometry(query_tile, point_tile, k)
    assert (rows, lanes) == want
    assert rows % tk.WARP_ROWS == 0
    assert rows <= tk.WARP_ROWS * tk.D3_MAX_WARPS
    assert lanes % tk.CHUNK_LANES == 0 and lanes <= tk.D3_MAX_TILE_LANES
    smem = tb.flat_d3_plan(query_tile, point_tile, k).smem
    assert smem <= tk.SMEM_OPTIN - 1024
    assert 2 * (smem + 1024) <= tk.SMEM_SM
    assert 2 * 8 * rows * tk.d3_regs(k) <= 65_536


@pytest.mark.parametrize("query_tile,point_tile,k,dim,want", [
    (2048, 2048, 8, 4, ("ring", 4, 3, True)),
    (2048, 2048, 10, 128, ("ring", 128, 3, True)),
    (2048, 2048, 100, 128, ("ring", 128, 3, False)),
    (50, 5000, 1, 16, ("ring", 16, 3, True)),
])
def test_launch_geometry_general_d(query_tile, point_tile, k, dim, want):
    """At D != 3 the flat fold plans the traversal's ring kernel, whatever
    the engine's tiles: its fixed block of 128 rows and 64-lane chunks, its
    stages and where the rows sit by Dp4 and k, in shared memory a block
    may opt into."""
    plan = tb.flat_plan(k, dim)
    assert (plan.kernel, plan.dp4, plan.stages, plan.rows_in_smem) == want
    assert plan == tk.tiled_launch_plan(query_tile, point_tile, k, dim)
    assert (plan.rows, plan.lanes) == (tk.RING_ROWS, tk.RING_LANES)
    assert plan.smem <= tk.SMEM_OPTIN - 1024


@pytest.mark.parametrize("dim", [128, 240, 960])
def test_flat_plans_k1000(dim):
    """k=1000 plans at D=128, 240 and 960 (the old general-D flat kernel
    raised near k=580 at D=128): rows in device memory, the queries
    resident or D streamed by Dp4."""
    plan = tb.flat_plan(1000, dim)
    assert plan.kernel == ("ring" if dim <= tk.RESIDENT_MAX_DP4
                           else "stream")
    assert not plan.rows_in_smem and plan.smem <= tk.SMEM_OPTIN - 1024
    with pytest.raises(ValueError):
        tb.flat_plan(1000, 3)


FLAT_KINDS = ["uniform", "dupes", "sentinel"]


@pytest.mark.parametrize("kind", FLAT_KINDS)
@pytest.mark.parametrize("k", [1, 8, 33, 100])
def test_flat_schedule_is_the_flat_fold(kind, k):
    """The flat route of the ring kernel rests on this: the traversal's
    plain version on ``flat_buckets`` (one query bucket of every row, all
    real; one point bucket of every point) gives exactly the flat plain
    version's bits, padding query rows included: sentinel queries adopt
    the sentinel points (d2 0, id -1), as in the TPU kernel."""
    dim = 6
    pts = points("uniform" if kind == "sentinel" else kind, 260, seed=k,
                 dim=dim)
    q = points("uniform" if kind == "sentinel" else kind, 90, seed=k + 1,
               dim=dim)
    ids = np.arange(260, dtype=np.int32) + 7
    if kind == "sentinel":
        pts[200:] = PAD_SENTINEL
        ids[200:] = -1
        q[60:] = PAD_SENTINEL
    qt, pt, it = (torch.from_numpy(x) for x in (q, pts, ids))
    state = tcand.init_candidates(90, k, max_radius=0.9 if k == 8 else
                                  math.inf)
    want = tb.knn_update_bf_plain(state, qt, pt, it, query_tile=32,
                                  point_tile=64)
    qb, pb = tb.flat_buckets(qt, pt, it)
    got = tk.knn_update_tiled_plain(state, qb, pb)
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)
    if kind == "sentinel":
        assert bool((got.dist2[60:, :min(k, 60)] == 0).all())
        assert bool((got.idx[60:, :min(k, 60)] == -1).all())


@pytest.mark.parametrize("k", sorted({904, 1000, 1024, 1025, 2048, 4096,
                                      4097, 8192, 16384,
                                      tk.D3_SLOTS_MAX_K + 1}))
def test_flat_d3_plans_large_k(k):
    """k above ``D3_SLOTS_MAX_K`` plans the flat D=3 kernel's wide fold:
    its rows in place in device memory, a block's shared memory its ring of
    ``WIDE_STAGES`` tiles of ``WIDE_TILE_LANES`` and its warps' pending
    buffers (``WIDE_WARP_BYTES`` a warp), counted by ``d3_smem_bytes``,
    whatever the engine's point tile; the plan fits what a block may opt
    into, says where its rows sit and keeps two blocks on an SM: 16 warps
    at the engine's default tiles (its registers and buffers bound
    both)."""
    for query_tile, point_tile in ((2048, 2048), (96, 300), (50, 5000)):
        plan = tb.flat_d3_plan(query_tile, point_tile, k)
        rows, lanes = tb.launch_geometry(query_tile, point_tile, k)
        assert (plan.kernel, plan.rows, plan.lanes, plan.threads,
                plan.dp4, plan.stages) == ("d3", rows, lanes, 8 * rows, 4,
                                           tk.WIDE_STAGES)
        assert lanes == tk.WIDE_TILE_LANES
        assert not plan.rows_in_smem
        assert plan.smem == tk.d3_smem_bytes(rows, lanes, k, "flat") \
            == (tk.WIDE_STAGES * 16 * lanes + rows // 4 * tk.WIDE_WARP_BYTES
                + tk.WIDE_CTRL_BYTES)
        assert plan.smem <= tk.SMEM_OPTIN - 1024
        assert tk.d3_blocks_per_sm(plan.threads, plan.smem,
                                   tk.WIDE_REGS) >= 2
    plan = tb.flat_d3_plan(2048, 2048, k)
    assert tk.d3_blocks_per_sm(plan.threads, plan.smem, tk.WIDE_REGS) \
        * plan.rows // 4 == 16
    # the plans of the k the first kernel took stand as they were
    small = tb.flat_d3_plan(2048, 2048, 100)
    assert (small.rows, small.lanes, small.rows_in_smem) == (64, 1024, True)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 100])
def test_kernel_matches_plain_on_the_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pts = torch.from_numpy(points("uniform", 20_000, seed=k)).cuda()
    state = tcand.init_candidates(20_000, k, device=pts.device)
    want = tb.knn_update_bf_plain(state, pts, pts)
    before = tb.knn_update_bf_cuda.d3_launches
    got = tb.knn_update_bf_cuda(state, pts, pts)
    torch.cuda.synchronize()
    assert tb.knn_update_bf_cuda.d3_launches == before + 1
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,k", [(128, 10), (240, 10), (128, 1000)])
def test_flat_ring_kernel_matches_plain_on_the_card(dim, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pts = torch.from_numpy(points("normal", 6_000, seed=dim + k, dim=dim)
                           ).cuda()
    q = pts[:2_000]
    state = tcand.init_candidates(2_000, k, device=pts.device)
    want = tb.knn_update_bf_plain(state, q, pts)
    before = tb.knn_update_bf_cuda.ring_launches
    got = tb.knn_update_bf_cuda(state, q, pts)
    torch.cuda.synchronize()
    assert tb.knn_update_bf_cuda.ring_launches == before + 1
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)
