"""The port's ``score_dtype="bf16"`` path (the JAX package's ``score_mxu``
branch) against the JAX package on the CPU: the ``ops/distance.py``
helpers, the traversal's plain version against interpret-mode
``knn_update_tiled_pallas`` and the XLA twin ``knn_update_tiled`` in bf16
(default ties), and ``ring_knn`` at R=1 and R=4. Distances are bitwise
equal including the inf pattern, ids equal; the inputs are tie-free
(standard-normal points: zero-mean, as the matmul form's error bound
wants). Real query rows only, as in ``tests/test_torch_knn_tiled.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import convert
from mpi_cuda_largescaleknn_torch import kth_neighbor_distances as torch_knn
from mpi_cuda_largescaleknn_torch.cli import unordered_main as torch_cli
from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
from mpi_cuda_largescaleknn_torch.models.prepartitioned import (
    PrePartitionedKNN,
)
from mpi_cuda_largescaleknn_torch.ops import distance as tdist
from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk
from mpi_cuda_largescaleknn_torch.ops import partition as tpart
from mpi_cuda_largescaleknn_torch.ops import tiled as ttiled
from mpi_cuda_largescaleknn_torch.parallel import ring as tring
from mpi_cuda_largescaleknn_torch.utils.math import round_up
from mpi_cuda_largescaleknn_tpu.ops import distance as jdist
from mpi_cuda_largescaleknn_tpu.ops.pallas.knn_tiled import (
    knn_update_tiled_pallas,
)
from mpi_cuda_largescaleknn_tpu.ops.tiled import knn_update_tiled
from mpi_cuda_largescaleknn_tpu.parallel import ring as jring
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from tests.oracle import random_points
from tests.test_torch_knn_tiled import assert_rows_equal, jax_inputs
from tests.test_torch_ops import assert_bitwise, points


@pytest.fixture(autouse=True)
def one_fold_segment(monkeypatch):
    # the Pallas fold's lane order among exact ties needs one segment
    # (ROADMAP.md Queue 3); the data here is tie-free, the pin keeps the
    # comparison the same as the f32 tests'
    monkeypatch.setenv("LSK_FOLD_SEGS", "1")


def test_score_dtypes_match():
    assert tdist.SCORE_DTYPES == jdist.SCORE_DTYPES
    for sd in tdist.SCORE_DTYPES:
        assert tdist.validate_score_dtype(sd) == jdist.validate_score_dtype(sd)
    for mod in (tdist, jdist):
        with pytest.raises(ValueError, match="unknown score_dtype"):
            mod.validate_score_dtype("fp8")


@pytest.mark.parametrize("dim", [3, 16, 128])
def test_norms2_bitwise(dim):
    x = random_points(300, seed=dim, scale=9.0, dim=dim) - 4.5
    assert_bitwise(tdist.norms2(torch.from_numpy(x)).numpy(),
                   jdist.norms2(jnp.asarray(x)))


def test_split_bf16_bitwise():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 40)) * 10.0 ** rng.integers(
        -6, 7, (64, 40))).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e30, -3.0000002]
    th, tl = tdist.split_bf16(torch.from_numpy(x))
    jh, jl = jdist.split_bf16(jnp.asarray(x))
    assert th.dtype == tl.dtype == torch.bfloat16
    assert_bitwise(th.to(torch.float32).numpy(),
                   np.asarray(jh.astype(jnp.float32)))
    assert_bitwise(tl.to(torch.float32).numpy(),
                   np.asarray(jl.astype(jnp.float32)))


@pytest.mark.parametrize("min_dim,width", [("", ""), ("1", "5"),
                                           ("24", "100"), ("bad", "x"),
                                           ("-3", "0")])
def test_mxu_settings_match(monkeypatch, min_dim, width):
    monkeypatch.setenv("LSK_MXU_MIN_DIM", min_dim)
    monkeypatch.setenv("LSK_RESCORE_WIDTH", width)
    assert tdist.mxu_min_dim() == jdist.mxu_min_dim()
    for k, t in ((1, 512), (8, 512), (40, 128), (100, 64), (3, 10)):
        assert tdist.rescore_width(k, t) == jdist.rescore_width(k, t)


@pytest.mark.parametrize("dim", [16, 32, 128])
def test_mxu_scores_close_to_jax_and_exact(dim):
    """The plain matmul form differs from the JAX package's only in the
    order of accumulation: both lie within the bf16x3 error bound
    (~2^-16 of ||q||^2 + ||p||^2) of the exact distances; we allow 2^-13."""
    q = points("normal", 40, seed=dim, dim=dim)
    p = points("normal", 70, seed=dim + 1, dim=dim)
    got = tdist.mxu_scores(torch.from_numpy(q), torch.from_numpy(p)).numpy()
    want = np.asarray(jdist.mxu_scores(jnp.asarray(q), jnp.asarray(p)))
    exact = tdist.elementwise_dist2(torch.from_numpy(q),
                                    torch.from_numpy(p)).numpy()
    scale = (np.sum(q * q, 1)[:, None] + np.sum(p * p, 1)[None, :])
    tol = scale * 2.0 ** -13
    assert np.all(np.abs(got - want) <= tol)
    assert np.all(np.abs(got - exact) <= tol)


CASES = {
    # name: (n, k, bucket_size, group, radius, warm/skip_self, D,
    #        LSK_MXU_MIN_DIM)
    "d16_k8_skip_self_g2": (512, 8, 32, 2, math.inf, True, 16, ""),
    "d32_k8_cold": (512, 8, 32, 1, math.inf, False, 32, ""),
    "d16_k1_skip_self_g2": (400, 1, 32, 2, math.inf, True, 16, ""),
    "d32_k40_skip_self_g2": (600, 40, 32, 2, math.inf, True, 32, ""),
    "d16_k8_radius": (500, 8, 32, 1, 4.5, False, 16, ""),
    "d32_k8_radius_g2": (512, 8, 32, 2, 6.5, True, 32, ""),
    "d8_k8_min_dim_1_g2": (512, 8, 32, 2, math.inf, True, 8, "1"),
    # above WGMMA_MAX_DP, where the kernel streams D in K-slices
    "d240_k10_skip_self_g2": (300, 10, 32, 2, math.inf, True, 240, ""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bf16_matches_pallas_and_xla_twin(case, monkeypatch):
    n, k, bs, group, radius, warm, dim, min_dim = CASES[case]
    monkeypatch.setenv("LSK_MXU_MIN_DIM", min_dim)
    assert tk.uses_mxu("bf16", dim)
    pts = points("normal", n, seed=n + k + dim, dim=dim)
    q, pc, state = jax_inputs(pts, k, bs, group, radius, warm)
    skip = jnp.int32(1) if warm else None
    want = knn_update_tiled_pallas(state, q, pc, skip_self=skip,
                                   self_group=group, score_dtype="bf16")
    twin = knn_update_tiled(state, q, pc, skip_self=skip, self_group=group,
                            score_dtype="bf16")
    args = (convert.candidate_state(state), convert.bucketed_points(q),
            convert.bucketed_points(pc))
    got = tk.knn_update_tiled_plain(*args, skip_self=warm, self_group=group,
                                    score_dtype="bf16")
    assert_rows_equal(got, want, q.ids)
    assert_rows_equal(got, twin, q.ids)
    exact = tk.knn_update_tiled_plain(*args, skip_self=warm,
                                      self_group=group)
    assert torch.equal(got.dist2, exact.dist2)
    assert torch.equal(got.idx, exact.idx)
    # the entry point takes the plain version for CPU tensors
    via = tk.knn_update_tiled_cuda(*args, skip_self=warm, self_group=group,
                                   score_dtype="bf16")
    assert torch.equal(via.dist2, got.dist2)
    assert torch.equal(via.idx, got.idx)


def test_bf16_below_min_dim_scores_exactly():
    pts = torch.from_numpy(points("uniform", 300, seed=5, dim=4))
    q = tpart.partition_points(pts, bucket_size=16)
    st = ttiled.warm_start_self(q, 6)
    assert not tk.uses_mxu("bf16", 4)
    a = tk.knn_update_tiled_plain(st, q, q, skip_self=True,
                                  score_dtype="bf16")
    b = tk.knn_update_tiled_plain(st, q, q, skip_self=True)
    assert torch.equal(a.dist2, b.dist2) and torch.equal(a.idx, b.idx)


def test_survivor_width_counts_lanes_padded_to_128():
    # 8 point buckets of 24 lanes: the TPU wrapper pads each to 128
    p = tpart.partition_points(torch.zeros(160, 16), bucket_size=20)
    assert p.ids.shape == (8, 24)
    assert tk.survivor_width(8, p) == min(8 * 128, 16)
    assert tk.survivor_width(600, p) == 8 * 128
    assert tk.survivor_width(100, p) == 200


def test_rescore_rows_decodes_and_sorts_stably():
    """Encoded entries get their exact d2 and id; carried-in entries
    (ids >= -1) keep theirs; equal d2 keep row order; rows cut to k."""
    pts = torch.from_numpy(points("normal", 64, seed=1, dim=16))
    p = tpart.partition_points(pts, bucket_size=16)
    q = tpart.partition_points(pts[:8], bucket_size=8)
    exact = tdist.elementwise_dist2(q.pts.reshape(-1, 16),
                                    p.pts.reshape(-1, 16))
    d2 = torch.tensor([[0.5, 7.0, 9.0, math.inf], [2.0, 2.0, 3.0, 50.0]])
    idx = torch.tensor([[5, -2 - 17, -2 - 3, -1], [-1, 4, -2 - 40, 9]],
                       dtype=torch.int32)
    rows = tk.CandidateState(torch.cat([d2, torch.full((6, 4), math.inf)]),
                             torch.cat([idx, torch.full((6, 4), -1,
                                                        dtype=torch.int32)]))
    out = tk.rescore_rows(rows, q, p, 3)
    pid = p.ids.reshape(-1)
    row0 = sorted([(0.5, 5), (float(exact[0, 17]), int(pid[17])),
                   (float(exact[0, 3]), int(pid[3])), (math.inf, -1)],
                  key=lambda e: e[0])[:3]
    assert out.dist2[0].tolist() == [e[0] for e in row0]
    assert out.idx[0].tolist() == [e[1] for e in row0]
    e40 = float(exact[1, 40])
    row1 = sorted([(2.0, -1), (2.0, 4), (e40, int(pid[40])), (50.0, 9)],
                  key=lambda e: e[0])[:3]
    assert out.dist2[1].tolist() == [e[0] for e in row1]
    assert out.idx[1].tolist() == [e[1] for e in row1]


@pytest.mark.parametrize("num_shards", [1, 4])
def test_ring_knn_bf16_matches_jax(num_shards):
    dim, k = 16, 8
    pts = points("normal", num_shards * 128, seed=60 + num_shards, dim=dim)
    ids = np.arange(len(pts), dtype=np.int32)
    want_d, want_c = jring.ring_knn(pts, ids, k, get_mesh(num_shards),
                                    engine="pallas_tiled", bucket_size=16,
                                    score_dtype="bf16",
                                    return_candidates=True)
    got_d, got_c = tring.ring_knn(pts, ids, k, num_shards, bucket_size=16,
                                  score_dtype="bf16", device="cpu",
                                  return_candidates=True)
    assert_bitwise(got_d.numpy(), np.asarray(want_d))
    assert_bitwise(got_c.dist2.numpy(), np.asarray(want_c.dist2))
    assert_bitwise(got_c.idx.numpy(), np.asarray(want_c.idx))
    exact_d, exact_c = tring.ring_knn(pts, ids, k, num_shards,
                                      bucket_size=16, device="cpu",
                                      return_candidates=True)
    assert torch.equal(got_d, exact_d)
    assert torch.equal(got_c.idx, exact_c.idx)


def test_flat_engine_refuses_bf16_as_jax_does():
    pts = points("normal", 64, seed=2, dim=16)
    ids = np.arange(64, dtype=np.int32)
    with pytest.raises(ValueError, match="no score_dtype='bf16' path"):
        tring.ring_knn(pts, ids, 4, 1, engine="pallas", score_dtype="bf16",
                       device="cpu")
    with pytest.raises(ValueError, match="no score_dtype='bf16' path"):
        torch_knn(pts, 4, engine="pallas", score_dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="no score_dtype='bf16' path"):
        jring.ring_knn(pts, ids, 4, get_mesh(1), engine="pallas",
                       score_dtype="bf16")


def test_prepartitioned_scores_f32_whatever_score_dtype():
    parts = [points("normal", 90, seed=s, dim=16) for s in (1, 2, 3)]
    got = [PrePartitionedKNN(KnnConfig(k=5, device="cpu", bucket_size=16,
                                       num_shards=0, score_dtype=sd)
                             ).run(parts)
           for sd in ("f32", "bf16")]
    for a, b in zip(*got):
        assert_bitwise(a, b)


def test_kth_neighbor_distances_bf16_equals_f32():
    pts = points("normal", 400, seed=9, dim=32)
    a, ia = torch_knn(pts, 6, score_dtype="bf16", bucket_size=16,
                      num_shards=2, return_neighbors=True, device="cpu")
    b, ib = torch_knn(pts, 6, bucket_size=16, num_shards=2,
                      return_neighbors=True, device="cpu")
    assert_bitwise(a, b)
    assert_bitwise(ia, ib)


def test_cli_bf16_on_float3_scores_exactly(tmp_path):
    src = tmp_path / "pts.float3"
    random_points(300, seed=3).tofile(src)
    outs = []
    for sd in ("f32", "bf16"):
        out = tmp_path / f"{sd}.float"
        assert torch_cli.main([str(src), "-o", str(out), "-k", "5",
                               "--bucket-size", "16", "--score-dtype", sd,
                               "--device", "cpu"]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dim,w,want", [
    (128, 20, ("wgmma", 128, 3, True, 0)),
    (128, 200, ("wgmma", 128, 3, False, 0)),
    (16, 20, ("wgmma", 16, 3, True, 0)),
    (960, 16, ("wgmma_stream", 960, 3, True, 64)),
    # just above the cap: 15 k-steps, slices of 64, 64, 64, 48
    (240, 20, ("wgmma_stream", 240, 3, True, 64)),
    # Dp=608: 9 slices of 64 and a short last one of 32
    (600, 20, ("wgmma_stream", 608, 3, True, 64)),
    (960, 20, ("wgmma_stream", 960, 3, True, 64)),
    # k=1000: W=2000 rows in device memory
    (960, 2000, ("wgmma_stream", 960, 3, False, 64)),
])
def test_mxu_launch_geometry(dim, w, want):
    """The route is by Dp: the query halves resident up to WGMMA_MAX_DP,
    D streamed in K-slices above it; rows in shared memory where they
    fit; each plan fits the shared memory a block may opt into."""
    plan = tk.mxu_launch_geometry(dim, w)
    assert (*plan[:4], plan.slice_width) == want
    assert plan.smem <= tk.SMEM_OPTIN - 1024
    assert plan.smem == tk.wgmma_smem_bytes(plan.dp, w, plan.stages,
                                            plan.rows_in_smem,
                                            plan.slice_width)
    if plan.kernel == "wgmma":
        assert plan.dp <= tk.WGMMA_MAX_DP
    else:
        assert plan.dp > tk.WGMMA_MAX_DP
        assert plan.slice_width == tk.wgmma_slice_width(plan.dp)


def test_wgmma_max_dp_is_the_largest_the_plan_takes():
    budget = tk.SMEM_OPTIN - 1024
    top = tk.WGMMA_MAX_DP
    assert top >= 128 and top % 16 == 0
    assert tk.wgmma_smem_bytes(top, 10_000, 2, False) <= budget
    assert tk.wgmma_smem_bytes(top + 16, 1, 2, False) > budget
    assert tk.mxu_launch_geometry(top, 20).kernel == "wgmma"
    assert tk.mxu_launch_geometry(top + 1, 20).kernel == "wgmma_stream"


def test_mxu_launch_geometry_refuses_huge_width():
    """Despite the name, no width is refused: at every Dp from 16 to 1024
    the plan takes any W, the rows in shared memory where they fit beside
    2 stages, else in device memory (the kernel reads them in place)."""
    budget = tk.SMEM_OPTIN - 1024
    for dp in range(16, 1025, 16):
        for w in (16, 20, 32, 200, 2000, 20_000):
            plan = tk.mxu_launch_geometry(dp, w)
            assert plan.dp == dp and plan.smem <= budget
            fits = tk.wgmma_smem_bytes(dp, w, 2, True,
                                       plan.slice_width) <= budget
            assert plan.rows_in_smem == fits
            assert plan.stages == 3 or tk.wgmma_smem_bytes(
                dp, w if plan.rows_in_smem else 0, 3, plan.rows_in_smem,
                plan.slice_width) > budget


@pytest.mark.parametrize("dp", [16, 64, 208, 224, 240, 256, 400, 608, 960,
                                1008, 1024])
def test_wgmma_slice_split_is_fewest_and_evenest(dp):
    """The k-steps split into the fewest slices of at most
    WGMMA_SLICE_MAX components, at the narrowest width that keeps that
    count (only the last slice is shorter), covering Dp once; the plan's
    stage holds the widest slice."""
    width = tk.wgmma_slice_width(dp)
    slices = tk.wgmma_slices(dp, width)
    assert len(slices) == -(-dp // tk.WGMMA_SLICE_MAX)
    assert width % 16 == 0 and width <= tk.WGMMA_SLICE_MAX
    assert width == 16 or len(tk.wgmma_slices(dp, width - 16)) > len(slices)
    assert [c0 for c0, _ in slices] == list(range(0, dp, width))
    assert sum(g for _, g in slices) == dp
    assert all(g % 16 == 0 and 0 < g <= width for _, g in slices)
    if dp > tk.WGMMA_MAX_DP:
        plan = tk.mxu_launch_geometry(dp, 20)
        assert plan.slice_width == width
        assert plan.smem >= plan.stages * (4 * tk.WGMMA_ROWS * width * 2
                                           + 2 * tk.WGMMA_LANES * 4)


def _halves_input(t, dim):
    return torch.from_numpy(points("normal", 3 * t, seed=t + dim,
                                   dim=dim)).view(3, t, dim) * 7.0


@pytest.mark.parametrize("t", [64, 496])
@pytest.mark.parametrize("dim", [16, 100, 128])
def test_pack_wgmma_halves_round_trip(dim, t):
    """Unpacking gives split_bf16's halves bit for bit, zero-padded to
    t_pad lanes and Dp components."""
    x = _halves_input(t, dim)
    t_pad, dp = round_up(t, tk.WGMMA_LANES), round_up(dim, 16)
    hi, lo = tk.pack_wgmma_halves(x, t_pad, dp)
    assert hi.shape == lo.shape == (3, t_pad // 8, 8 * dp)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.is_contiguous()
    want = tdist.split_bf16(x)
    for got, ref in zip(tk.unpack_wgmma_halves(hi, lo, dp), want):
        assert got.shape == (3, t_pad, dp)
        assert torch.equal(got[:, :t, :dim].view(torch.int16),
                           ref.view(torch.int16))
        assert not got[:, t:].any() and not got[:, :, dim:].any()


@pytest.mark.parametrize("dim", [16, 100, 128])
def test_wgmma_chunk_is_one_contiguous_run(dim):
    """Lanes [c*64, (c+1)*64) of bucket pb are the ``64 * dp`` values the
    kernel bulk-copies from element ``(pb * t_pad + c * 64) * dp``, in
    core-matrix order: 8-lane groups of [dp/8][8 lanes][8 components]."""
    x = _halves_input(496, dim)
    t_pad, dp, lanes = 512, round_up(dim, 16), tk.WGMMA_LANES
    packed = tk.pack_wgmma_halves(x, t_pad, dp)
    for half, full in zip(packed, tk.unpack_wgmma_halves(*packed, dp)):
        flat = half.reshape(-1)
        for pb, c in ((0, 0), (1, 3), (2, 7)):
            e0 = (pb * t_pad + c * lanes) * dp
            run = flat[e0:e0 + lanes * dp].view(lanes // 8, dp // 8, 8, 8)
            lanes_major = run.transpose(1, 2).reshape(lanes, dp)
            assert torch.equal(lanes_major.view(torch.int16),
                               full[pb, c * lanes:(c + 1) * lanes]
                               .view(torch.int16))


def _padded_halves(x, t_pad, dp):
    """split_bf16's halves, zero-padded: bf16[B, t_pad, dp] each."""
    b, t, dim = x.shape
    out = []
    for half in tdist.split_bf16(x):
        h = torch.zeros((b, t_pad, dp), dtype=torch.bfloat16)
        h[:, :t, :dim] = half
        out.append(h)
    return out


def _resident_layout(x, t_pad, dp):
    """The one-slice layout written out: bf16[B, t_pad/8, dp/8, 8, 8]."""
    return [h.view(h.shape[0], t_pad // 8, 8, dp // 8, 8).transpose(2, 3)
            for h in _padded_halves(x, t_pad, dp)]


@pytest.mark.parametrize("group", [8, 64, 128])
@pytest.mark.parametrize("dim", [16, 100, 240])
def test_full_width_slice_is_the_resident_layout(dim, group):
    """One slice of Dp (any run length) is the resident route's layout,
    bit for bit, and so is the default packing."""
    x = _halves_input(200, dim)
    dp = round_up(dim, 16)
    want = _resident_layout(x, 256, dp)
    for packed in (tk.pack_wgmma_halves(x, 256, dp),
                   tk.pack_wgmma_halves(x, 256, dp, group, dp)):
        for got, ref in zip(packed, want):
            assert torch.equal(got.reshape(-1).view(torch.int16),
                               ref.reshape(-1).view(torch.int16))


@pytest.mark.parametrize("dim", [240, 600, 960, 1000])
def test_sliced_packing_round_trip(dim):
    """In the plan's K-slices, in runs of 128 rows (queries) or of a chunk
    pair's 128 lanes (points), unpacking gives split_bf16's halves bit for
    bit, zero-padded to t_pad lanes and Dp components."""
    x = _halves_input(200, dim)
    dp = round_up(dim, 16)
    width = tk.mxu_launch_geometry(dim, 20).slice_width
    assert width and width < dp
    hi, lo = tk.pack_wgmma_halves(x, 256, dp, 128, width)
    assert hi.shape == lo.shape == (3, 2, 128 * dp)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.is_contiguous()
    for got, ref in zip(tk.unpack_wgmma_halves(hi, lo, dp, width),
                        tdist.split_bf16(x)):
        assert got.shape == (3, 256, dp)
        assert torch.equal(got[:, :200, :dim].view(torch.int16),
                           ref.view(torch.int16))
        assert not got[:, 200:].any() and not got[:, :, dim:].any()


@pytest.mark.parametrize("dim", [240, 600, 960, 1000])
def test_wgmma_slice_is_one_contiguous_run(dim):
    """Each (query block, slice) and each (chunk pair, slice) is the
    ``128 * g`` values the streamed kernel bulk-copies from element
    ``run0 * 128 * dp + 128 * c0`` (run0 = b * S_pad/128 + block, or
    pb * T_pad/128 + pair), in core-matrix order: 8-row groups of
    [g/8][8 rows][8 components]."""
    x = _halves_input(496, dim)
    t_pad, dp = 512, round_up(dim, 16)
    width = tk.wgmma_slice_width(dp)
    packed = tk.pack_wgmma_halves(x, t_pad, dp, 128, width)
    runs = t_pad // 128
    for half, full in zip(packed, _padded_halves(x, t_pad, dp)):
        flat = half.reshape(-1)
        for b, r in ((0, 0), (1, 3), (2, 1)):
            for c0, g in tk.wgmma_slices(dp, width):
                e0 = (b * runs + r) * 128 * dp + 128 * c0
                run = flat[e0:e0 + 128 * g].view(16, g // 8, 8, 8)
                rows_major = run.transpose(1, 2).reshape(128, g)
                assert torch.equal(rows_major.view(torch.int16),
                                   full[b, 128 * r:128 * (r + 1), c0:c0 + g]
                                   .view(torch.int16))


def test_padding_lanes_carry_inf_norms_and_zero_halves():
    x = _halves_input(496, 100)
    n2 = tk.padded_norms2(x, 512)
    assert n2.shape == (3, 512) and n2.is_contiguous()
    assert torch.equal(n2[:, :496], tdist.norms2(x))
    assert bool(torch.isinf(n2[:, 496:]).all()) and bool((n2[:, 496:] > 0)
                                                          .all())
    for half in tk.unpack_wgmma_halves(*tk.pack_wgmma_halves(x, 512, 112),
                                       112):
        assert not half[:, 496:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 128, 240, 600, 960])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_mxu_kernel_matches_plain_on_the_card(k, dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pts = torch.from_numpy(points("normal", 20_000, seed=k, dim=dim)).cuda()
    q = tpart.partition_points(pts, bucket_size=256)
    pc = tpart.coarsen_buckets(q, 2)
    state = ttiled.warm_start_self(pc, k)
    want = tk.knn_update_tiled_plain(state, q, pc, skip_self=True,
                                     self_group=2, score_dtype="bf16")
    got = tk.knn_update_tiled_cuda(state, q, pc, skip_self=True,
                                   self_group=2, score_dtype="bf16")
    torch.cuda.synchronize()
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)
