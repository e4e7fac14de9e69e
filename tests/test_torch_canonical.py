"""Canonical ties and per-query radius rows (the port's
``ops/candidates.py``), ``score_tile`` (``ops/distance.py``) and the
traversal's ``canonical_ties`` (``ops/knn_tiled.py``) against the JAX
package on the CPU: the same numpy inputs through both, bitwise-equal
distances and equal ids. The traversal is held against the JAX Pallas
wrapper in interpret mode (its kernel keeps strict-< adoption in canonical
mode too); real query rows only, as in ``tests/test_torch_knn_tiled.py``.
bf16 inputs are tie-free (standard-normal points)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import convert
from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops import candidates as tcand
from mpi_cuda_largescaleknn_torch.ops import distance as tdist
from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk
from mpi_cuda_largescaleknn_tpu.core.types import CandidateState as JState
from mpi_cuda_largescaleknn_tpu.ops import candidates as jcand
from mpi_cuda_largescaleknn_tpu.ops import distance as jdist
from mpi_cuda_largescaleknn_tpu.ops.pallas.knn_tiled import (
    knn_update_tiled_pallas,
)
from tests.test_torch_knn_tiled import assert_rows_equal, jax_inputs
from tests.test_torch_ops import assert_bitwise, points


def assert_state_equal(got: CandidateState, want) -> None:
    assert_bitwise(got.dist2.numpy(), np.asarray(want.dist2))
    assert_bitwise(got.idx.numpy(), np.asarray(want.idx))


def merge_both(state_d2, state_idx, cand_d2, cand_idx, canonical):
    want = jcand.merge_candidates(
        JState(jnp.asarray(state_d2), jnp.asarray(state_idx)),
        jnp.asarray(cand_d2), jnp.asarray(cand_idx), canonical=canonical)
    got = tcand.merge_candidates(
        CandidateState(torch.tensor(state_d2), torch.tensor(state_idx)),
        torch.from_numpy(cand_d2), torch.from_numpy(cand_idx),
        canonical=canonical)
    return got, want


def grid_tile(rng, rows, t, levels):
    """Integer-valued d2 (exact in f32), so equal distances are frequent,
    and a shuffled id row, so lane order and id order disagree."""
    d2 = rng.integers(0, levels, (rows, t)).astype(np.float32)
    ids = np.stack([rng.permutation(10 * t)[:t] for _ in range(rows)])
    return d2, ids.astype(np.int32)


def seeded_state(rng, rows, k, levels):
    """Ascending rows of integer-valued d2 with distinct ids above the
    tile's, the rows an earlier merge leaves."""
    d2 = np.sort(rng.integers(0, levels, (rows, k)), axis=1)
    ids = 100_000 + rng.permutation(rows * k).reshape(rows, k)
    return d2.astype(np.float32), ids.astype(np.int32)


@pytest.mark.parametrize("t", [40, 200])
@pytest.mark.parametrize("k", [1, 8, 33])
def test_canonical_merge_grid_ties_at_the_k_boundary(k, t):
    """Many lanes tie at the tile's k-th distance: the JAX package's
    ``lax.top_k`` pre-reduce keeps the lower lanes and its tie-fix swaps in
    the smallest ids; the port's two-key sort keeps them directly."""
    rng = np.random.default_rng(k * 1000 + t)
    rows = 64
    cd2, cidx = grid_tile(rng, rows, t, levels=4)
    for sd2, sidx in (seeded_state(rng, rows, k, 6),
                      (np.full((rows, k), np.inf, np.float32),
                       np.full((rows, k), -1, np.int32))):
        got, want = merge_both(sd2, sidx, cd2, cidx, canonical=True)
        assert_state_equal(got, want)
        got, want = merge_both(sd2, sidx, cd2, cidx, canonical=False)
        assert_state_equal(got, want)


@pytest.mark.parametrize("k", [1, 8, 33])
def test_canonical_merge_inf_ties_against_init_slots(k):
    """Tiles with few finite lanes: at an infinite k-th distance the JAX
    package skips its tie-fix, and no (inf, id) entry displaces an init
    slot (inf, -1) under either sort."""
    rng = np.random.default_rng(k)
    rows, t = 48, 64
    cd2, cidx = grid_tile(rng, rows, t, levels=5)
    finite = rng.integers(0, k + 2, rows)
    cd2[np.arange(t)[None, :] >= finite[:, None]] = np.inf
    sd2 = np.full((rows, k), np.inf, np.float32)
    sidx = np.full((rows, k), -1, np.int32)
    # half the rows already hold some finite entries
    sd2[::2, :k // 2] = 0.5
    sidx[::2, :k // 2] = np.arange(k // 2, dtype=np.int32) + 7_000
    got, want = merge_both(sd2, sidx, cd2, cidx, canonical=True)
    assert_state_equal(got, want)
    assert not np.any((got.dist2.numpy() == np.inf) & (got.idx.numpy() >= 0))


@pytest.mark.parametrize("k", [1, 8, 33])
def test_canonical_merge_finite_radius(k):
    """Candidates exactly at a finite radius never displace its slots
    (strict-< adoption); below it they enter by (d2, idx)."""
    rng = np.random.default_rng(50 + k)
    rows, t = 40, 100
    radius = np.float32(2.0)
    init = jcand.init_candidates(rows, k, radius)
    cd2, cidx = grid_tile(rng, rows, t, levels=6)     # 4.0 = radius**2 ties
    got, want = merge_both(np.asarray(init.dist2), np.asarray(init.idx),
                           cd2, cidx, canonical=True)
    assert_state_equal(got, want)
    assert np.all(got.dist2.numpy() <= radius * radius)


def test_sort_rows_canonical_keeps_signed_zeros_in_order():
    d2 = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    idx = torch.tensor([[3, 3, 1, 2, 2]], dtype=torch.int32)
    out_d2, out_idx = tcand.sort_rows_canonical(d2, idx)
    assert out_idx.tolist() == [[2, 2, 3, 3, 1]]
    # equal (d2, idx) keys keep their input order: -0.0 before 0.0 for id
    # 2, 0.0 before -0.0 for id 3
    signs = torch.signbit(out_d2).tolist()[0]
    assert signs == [True, False, False, True, False]


@pytest.mark.parametrize("k", [1, 8, 33])
def test_init_candidates_radius_row(k):
    radius = np.abs(points("normal", 1, seed=k, dim=50)[0]) + 0.25
    radius[3] = np.inf
    want = jcand.init_candidates(50, k, jnp.asarray(radius))
    got = tcand.init_candidates(50, k, torch.from_numpy(radius))
    assert_state_equal(got, want)
    got = tcand.init_candidates(50, k, radius)          # a numpy row
    assert_state_equal(got, want)
    assert_state_equal(tcand.init_candidates(50, k, 1.5),
                       jcand.init_candidates(50, k, 1.5))
    with pytest.raises(ValueError, match="per-query max_radius"):
        tcand.init_candidates(49, k, torch.from_numpy(radius))
    with pytest.raises(ValueError, match="per-query max_radius"):
        jcand.init_candidates(49, k, jnp.asarray(radius))


def score_inputs(dim, mask_layout, seed):
    """A [C, S, D] query tile, a [C, T, D] point tile with ids [C, T], and
    a mask in one of the JAX package's two layouts: per tile row
    [C, 1, T] or per query row [C, S, T]."""
    c, s, t = 3, 20, 96
    rng = np.random.default_rng(seed)
    q = points("normal", c * s, seed=seed, dim=dim).reshape(c, s, dim)
    p = points("normal", c * t, seed=seed + 1, dim=dim).reshape(c, t, dim)
    pid = rng.permutation(c * t).astype(np.int32).reshape(c, t)
    if mask_layout == "none":
        mask = None
    elif mask_layout == "tile":
        mask = rng.random((c, 1, t)) < 0.6
        mask[1] = False                    # a tile with no live lane
    else:
        mask = rng.random((c, s, t)) < 0.6
        mask[0, 0] = False
        mask[2, 1, :5] = True
        mask[2, 1, 5:] = False             # fewer live lanes than W
    return q, p, pid, mask


@pytest.mark.parametrize("mask_layout", ["none", "tile", "query"])
@pytest.mark.parametrize("score_dtype,dim,skip_rescore", [
    ("f32", 3, False), ("f32", 16, False), ("bf16", 3, False),
    ("bf16", 16, False), ("bf16", 128, False), ("bf16", 16, True),
    ("bf16", 128, True)])
@pytest.mark.parametrize("k", [1, 8, 33])
def test_score_tile_matches_jax(k, score_dtype, dim, skip_rescore,
                                mask_layout):
    q, p, pid, mask = score_inputs(dim, mask_layout, seed=dim + k)
    pn2 = tdist.norms2(torch.from_numpy(p))
    want_d2, want_idx = jdist.score_tile(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(pid), k,
        score_dtype=score_dtype,
        mask=None if mask is None else jnp.asarray(mask),
        pn2=jnp.asarray(pn2.numpy()), skip_rescore=skip_rescore)
    got_d2, got_idx = tdist.score_tile(
        torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(pid), k,
        score_dtype=score_dtype,
        mask=None if mask is None else torch.from_numpy(mask), pn2=pn2,
        skip_rescore=skip_rescore)
    want_d2, want_idx = np.asarray(want_d2), np.asarray(want_idx)
    assert_bitwise(got_idx.contiguous().numpy(), want_idx)
    if skip_rescore and dim >= tdist.mxu_min_dim():
        # raw matmul-form scores: the two packages accumulate the bf16x3
        # cross term in different orders, so the bits differ within the
        # form's error bound (tests/test_torch_mxu.py allows 2^-13 of the
        # norms' sum); the +inf pattern and the 0 clamp are exact
        got = got_d2.numpy()
        scale = (np.sum(q * q, -1)[..., :, None]
                 + np.sum(p * p, -1)[..., None, :])
        assert np.array_equal(np.isinf(got), np.isinf(want_d2))
        fin = np.isfinite(want_d2)
        assert np.all(np.abs(got[fin] - want_d2[fin])
                      <= scale[np.broadcast_to(fin, scale.shape)]
                      * 2.0 ** -13)
        assert np.all(got >= 0.0)
    else:
        assert_bitwise(got_d2.numpy(), want_d2)
    if score_dtype == "bf16" and dim >= 16 and not skip_rescore:
        assert got_d2.shape[-1] == tdist.rescore_width(k, p.shape[1])


CANONICAL_CASES = {
    # name: (kind, n, k, bucket_size, group, radius, warm, D, score_dtype)
    "d3_k8_grid": ("grid", 600, 8, 16, 1, math.inf, False, 3, "f32"),
    "d3_k33_grid_g2": ("grid", 640, 33, 32, 2, math.inf, True, 3, "f32"),
    "d3_k8_radius": ("uniform", 500, 8, 16, 1, 0.1, False, 3, "f32"),
    "d128_k8_f32_g2": ("normal", 400, 8, 32, 2, math.inf, True, 128, "f32"),
    "d128_k8_bf16_g2": ("normal", 400, 8, 32, 2, math.inf, True, 128,
                        "bf16"),
    "d128_k33_bf16": ("normal", 400, 33, 32, 1, math.inf, False, 128,
                      "bf16"),
}


def canonical_points(kind, n, seed, dim):
    if kind != "grid":
        return points(kind, n, seed=seed, dim=dim)
    # integer coordinates on a 6^3 grid: exact, and thick with ties
    rng = np.random.default_rng(seed)
    return rng.integers(0, 6, (n, dim)).astype(np.float32)


@pytest.mark.parametrize("case", list(CANONICAL_CASES))
def test_plain_canonical_ties_match_pallas_wrapper(case, monkeypatch):
    """``knn_update_tiled_plain(canonical_ties=True)`` against the JAX
    Pallas wrapper in interpret mode: one two-key sort of the finished
    rows (the widened rows under bf16), ids included."""
    monkeypatch.setenv("LSK_FOLD_SEGS", "1")
    kind, n, k, bs, group, radius, warm, dim, sd = CANONICAL_CASES[case]
    pts = canonical_points(kind, n, seed=n + k, dim=dim)
    q, pc, state = jax_inputs(pts, k, bs, group, radius, warm)
    skip = jnp.int32(1) if warm else None
    want = knn_update_tiled_pallas(state, q, pc, skip_self=skip,
                                   self_group=group, canonical_ties=True,
                                   score_dtype=sd)
    args = (convert.candidate_state(state), convert.bucketed_points(q),
            convert.bucketed_points(pc))
    got = tk.knn_update_tiled_plain(*args, skip_self=warm, self_group=group,
                                    canonical_ties=True, score_dtype=sd)
    assert_rows_equal(got, want, q.ids)
    via, visits, folds = tk.knn_update_tiled_cuda(
        *args, skip_self=warm, self_group=group, canonical_ties=True,
        score_dtype=sd, with_stats="full")
    assert torch.equal(via.dist2, got.dist2)
    assert torch.equal(via.idx, got.idx)
    assert int(folds) == int(visits.sum())
    # the same rows as the default ties', re-sorted by (d2, idx)
    plain = tk.knn_update_tiled_plain(*args, skip_self=warm,
                                      self_group=group, score_dtype=sd)
    assert torch.equal(got.dist2, plain.dist2)
    d2, idx = tcand.sort_rows_canonical(plain.dist2, plain.idx)
    assert torch.equal(got.idx, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,sd,k", [(3, "f32", 8), (3, "f32", 100),
                                      (128, "f32", 10), (128, "bf16", 10)])
def test_canonical_ties_on_the_card_match_plain(dim, sd, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from mpi_cuda_largescaleknn_torch.ops import partition as tpart
    from mpi_cuda_largescaleknn_torch.ops import tiled as ttiled

    kind = "grid" if dim == 3 else "normal"
    pts = torch.from_numpy(canonical_points(kind, 20_000, k, dim)).cuda()
    q = tpart.partition_points(pts, bucket_size=256)
    pc = tpart.coarsen_buckets(q, 2)
    state = ttiled.warm_start_self(pc, k)
    kw = dict(skip_self=True, self_group=2, score_dtype=sd,
              canonical_ties=True)
    want = tk.knn_update_tiled_plain(state, q, pc, **kw)
    got = tk.knn_update_tiled_cuda(state, q, pc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.dist2, want.dist2)
    assert torch.equal(got.idx, want.idx)
