"""The engine ``tree`` (the port's ``ops/build_tree.py`` and
``ops/traverse.py``) against the JAX package on the CPU.

``build_tree`` is held bitwise (tree and ids) on any data. The traversal is
held bitwise on dyadic points (multiples of 1/64 below 8), where every
product and sum of the squared distance is exact: the JAX package's
``knn_update_tree`` computes ``(dx*dx + dy*dy) + dz*dz`` with no guard
against fused multiply-add, and XLA:CPU contracts it, so on general floats
its distances differ from the uncontracted ones by an ulp (the port keeps
each operation rounded on its own, as every other scorer of both packages
does). On uniform floats the port is held bitwise to the uncontracted
numpy brute force instead."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import convert
from mpi_cuda_largescaleknn_torch.ops import build_tree as tb
from mpi_cuda_largescaleknn_torch.ops import candidates as tcand
from mpi_cuda_largescaleknn_torch.ops import traverse as tt
from tests.test_torch_ops import assert_bitwise

# the JAX package's ops/__init__.py re-exports functions under these
# module names
jb = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.build_tree")
jt = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.traverse")
jcand = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.candidates")


def dyadic(n: int, seed: int) -> np.ndarray:
    """Points whose squared distances are exact in f32 (and with many
    repeated coordinates)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (n, 3)) / 64).astype(np.float32)


def both_trees(pts, ids=None):
    want = jb.build_tree(jnp.asarray(pts),
                         None if ids is None else jnp.asarray(ids))
    got = tb.build_tree(torch.from_numpy(pts),
                        None if ids is None else torch.from_numpy(ids))
    return got, want


def test_left_subtree_size_and_depth_small_n():
    n = np.arange(0, 4097, dtype=np.int32)
    assert_bitwise(tb.left_subtree_size(torch.from_numpy(n)).numpy(),
                   np.asarray(jb.left_subtree_size(jnp.asarray(n))))
    assert_bitwise(tb.node_depth(torch.from_numpy(n)).numpy(),
                   np.asarray(jb.node_depth(jnp.asarray(n))))


def test_left_subtree_size_and_depth_near_2_24_and_2_31():
    """Integer arithmetic where a float log2 would round: log2(2**24 - 1)
    is 24.0 in f32."""
    edges = [2**24 + d for d in range(-3, 4)] + [2**30 + d for d in
                                                 range(-2, 3)]
    edges += [2**31 - d for d in range(1, 5)]
    n = np.array(edges, dtype=np.int32)
    assert_bitwise(tb.left_subtree_size(torch.from_numpy(n)).numpy(),
                   np.asarray(jb.left_subtree_size(jnp.asarray(n))))
    assert_bitwise(tb.node_depth(torch.from_numpy(n)).numpy(),
                   np.asarray(jb.node_depth(jnp.asarray(n))))
    assert tb.node_depth(torch.tensor([2**24 - 2])).item() == 23
    assert tb.node_depth(torch.tensor([2**24 - 1])).item() == 24


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 1000])
def test_build_tree_uniform(n):
    pts = np.random.default_rng(n).random((n, 3)).astype(np.float32)
    ids = (np.arange(n, dtype=np.int32) * 7 + 3)
    for id_arg in (None, ids):
        (got_t, got_i), (want_t, want_i) = both_trees(pts, id_arg)
        assert_bitwise(got_t.numpy(), np.asarray(want_t))
        assert_bitwise(got_i.numpy(), np.asarray(want_i))


def test_build_tree_repeated_coordinates_and_signed_zeros():
    """Equal keys keep their input order in both sorts, and -0.0 equals
    0.0 there (``lax.sort`` keeps the zeros in input order)."""
    pts = dyadic(1000, seed=3)
    pts[::3, 0] = 0.0
    pts[1::3, 0] = -0.0
    pts[::4, 1] = -0.0
    pts[::5, 2] = 0.0
    pts[::6, 2] = -0.0
    pts[500:520] = pts[480]
    (got_t, got_i), (want_t, want_i) = both_trees(pts)
    assert_bitwise(got_t.numpy(), np.asarray(want_t))
    assert_bitwise(got_i.numpy(), np.asarray(want_i))


def test_build_tree_refuses_other_d():
    with pytest.raises(ValueError, match="D=3"):
        tb.build_tree(torch.zeros(10, 4))


def traverse_both(tree_pair, q, k, radius=float("inf"), state=None):
    jtree, jids = tree_pair
    jstate = state if state is not None else jcand.init_candidates(
        len(q), k, radius)
    want = jt.knn_update_tree(jstate, jnp.asarray(q), jtree, jids)
    got = tt.knn_update_tree(convert.candidate_state(jstate),
                             torch.from_numpy(q),
                             *convert.kd_tree(jtree, jids))
    return got, want


@pytest.mark.parametrize("k", [1, 8, 33])
def test_knn_update_tree_matches_jax_on_a_jax_built_tree(k):
    """The port's traversal folds the JAX package's tree (carried across
    by ``convert.kd_tree``) into a JAX candidate state, twice: a state
    carried in from JAX, then the folded one again."""
    pts = dyadic(1500, seed=k)
    q = dyadic(300, seed=k + 100)
    tree_pair = jb.build_tree(jnp.asarray(pts))
    got, want = traverse_both(tree_pair, q, k)
    assert_bitwise(got.dist2.numpy(), np.asarray(want.dist2))
    assert_bitwise(got.idx.numpy(), np.asarray(want.idx))
    # a second tree folded into the carried state
    pts2 = dyadic(700, seed=k + 200)
    tree2 = jb.build_tree(jnp.asarray(pts2),
                          jnp.arange(700, dtype=jnp.int32) + 5000)
    got2, want2 = traverse_both(tree2, q, k, state=want)
    assert_bitwise(got2.dist2.numpy(), np.asarray(want2.dist2))
    assert_bitwise(got2.idx.numpy(), np.asarray(want2.idx))
    # and the port's own tree is the same tree
    own = tb.build_tree(torch.from_numpy(pts))
    got3 = tt.knn_update_tree(tcand.init_candidates(300, k),
                              torch.from_numpy(q), *own)
    assert torch.equal(got3.dist2, got.dist2)
    assert torch.equal(got3.idx, got.idx)


def test_knn_update_tree_finite_radius():
    pts = dyadic(1200, seed=5)
    q = dyadic(200, seed=6)
    got, want = traverse_both(jb.build_tree(jnp.asarray(pts)), q, 8,
                              radius=0.25)
    assert_bitwise(got.dist2.numpy(), np.asarray(want.dist2))
    assert_bitwise(got.idx.numpy(), np.asarray(want.idx))
    assert np.any(got.idx.numpy() == -1)


def test_knn_update_tree_k_above_n():
    pts = dyadic(20, seed=7)
    q = dyadic(30, seed=8)
    got, want = traverse_both(jb.build_tree(jnp.asarray(pts)), q, 33)
    assert_bitwise(got.dist2.numpy(), np.asarray(want.dist2))
    assert_bitwise(got.idx.numpy(), np.asarray(want.idx))
    assert np.all(np.isinf(got.dist2.numpy()[:, 20:]))


@pytest.mark.parametrize("k", [1, 8, 33])
def test_knn_update_tree_is_exact_on_uniform_floats(k):
    """On general floats: the k smallest uncontracted squared distances,
    bit for bit, and ids whose uncontracted distances are those."""
    rng = np.random.default_rng(k)
    pts = rng.random((1500, 3)).astype(np.float32)
    q = rng.random((200, 3)).astype(np.float32)
    got = tt.knn_update_tree(tcand.init_candidates(200, k),
                             torch.from_numpy(q),
                             *tb.build_tree(torch.from_numpy(pts)))
    d = q[:, None, :] - pts[None, :, :]
    exact = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]
    want = np.sort(exact, axis=1)[:, :k]
    assert_bitwise(got.dist2.numpy(), want)
    assert_bitwise(np.take_along_axis(exact, got.idx.numpy().astype(np.int64),
                                      1), want)


def test_liveness_check_every_32_steps_gives_the_per_step_rows(monkeypatch):
    """Steps after every query finished change nothing: checking the
    predicate every step gives the same rows."""
    pts = dyadic(900, seed=9)
    q = dyadic(150, seed=10)
    tree = tb.build_tree(torch.from_numpy(pts))
    init = tcand.init_candidates(150, 8)
    steps0 = tt.knn_update_tree.steps
    a = tt.knn_update_tree(init, torch.from_numpy(q), *tree)
    steps_a = tt.knn_update_tree.steps - steps0
    monkeypatch.setattr(tt, "LIVENESS_EVERY", 1)
    b = tt.knn_update_tree(init, torch.from_numpy(q), *tree)
    steps_b = tt.knn_update_tree.steps - steps0 - steps_a
    assert torch.equal(a.dist2, b.dist2) and torch.equal(a.idx, b.idx)
    # the same walk, ended at the first multiple of 32 at or past its end
    assert steps_a % 32 == 0 and steps_b <= steps_a < steps_b + 32


def test_tree_warns_above_the_jax_limit():
    n = tt._TREE_WARN_N + 1
    assert tt._TREE_WARN_N == jt._TREE_WARN_N
    tree = (torch.zeros(n, 3), torch.arange(n, dtype=torch.int32))
    state = tcand.init_candidates(0, 4)
    with pytest.warns(RuntimeWarning, match="lockstep"):
        tt.knn_update_tree(state, torch.zeros(0, 3), *tree)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt.knn_update_tree(state, torch.zeros(0, 3), tree[0][:-1],
                           tree[1][:-1])


def test_knn_update_tree_refuses_other_d():
    with pytest.raises(ValueError, match="D=3"):
        tt.knn_update_tree(tcand.init_candidates(4, 2), torch.zeros(4, 5),
                           torch.zeros(10, 5))
