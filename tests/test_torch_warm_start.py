"""The self-join's warm start on the traversal kernels
(``ops/knn_tiled.py`` ``warm_start_self_cuda``) against the eager
``ops/tiled.py`` ``warm_start_self``, which ``tests/test_torch_ops.py``
holds to the JAX package bit for bit.

On the CPU: the contract the launch rests on. Folding one bucket once into
cold rows, by strict-< adoption in lane order after equal entries (the
plain traversal on that bucket alone: one visit), gives
``warm_start_self``'s rows bit for bit, rows of padding queries included;
and the kernels' schedule check takes the one-visit schedule. On the card
(marked ``cuda``): the launch on every f32 route against the eager rows,
and whole walks from cold rows on the D=3 kernel's instance for them.
This file imports no JAX, so the card tests also run where there is none:
``python -m pytest --noconftest -m cuda tests/test_torch_warm_start.py``.
"""

import math

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.models.sharding import pad_and_flatten
from mpi_cuda_largescaleknn_torch.ops import knn_tiled as tk
from mpi_cuda_largescaleknn_torch.ops import partition as tpart
from mpi_cuda_largescaleknn_torch.ops import tiled as ttiled
from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
from mpi_cuda_largescaleknn_torch.parallel import demand as tdemand
from mpi_cuda_largescaleknn_torch.parallel import ring as tring


def points(kind: str, n: int, seed: int, dim: int = 3) -> np.ndarray:
    """Seeded f32[n, dim] points: uniform in [0, 1)^D, standard normal, or
    on the integer grid {0..3}^D (many exact ties in d2, d2 integers)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((n, dim)).astype(np.float32)
    if kind == "normal":
        return rng.standard_normal((n, dim)).astype(np.float32)
    return rng.integers(0, 4, (n, dim)).astype(np.float32)


def resident(kind, n, bucket_size, group, dim, seed, device="cpu"):
    """The ring driver's resident side of one shard: the partition
    coarsened by ``group``, on ``device``."""
    pts = torch.from_numpy(points(kind, n, seed, dim)).to(device)
    return tpart.coarsen_buckets(
        tpart.partition_points(pts, bucket_size=bucket_size), group)


def assert_rows_equal(got: CandidateState, want: CandidateState):
    # bits: -0.0 / 0.0 and NaN patterns compare too
    assert torch.equal(got.dist2.view(torch.int32),
                       want.dist2.view(torch.int32))
    assert torch.equal(got.idx, want.idx)


#: name: (kind, n, k, bucket_size, group, max_radius, D). Every n leaves
#: padding rows; the grid's radii 1 and 2 put candidates exactly at the
#: radius (d2 1 and 4), which strict-< never adopts
CASES = {
    "uniform_k1_g1": ("uniform", 300, 1, 16, 1, math.inf, 3),
    "uniform_k8_g2": ("uniform", 500, 8, 16, 2, math.inf, 3),
    "uniform_k100_g2": ("uniform", 900, 100, 64, 2, math.inf, 3),
    "uniform_k8_radius_g1": ("uniform", 400, 8, 16, 1, 0.1, 3),
    "grid_k1_g2": ("grid", 480, 1, 16, 2, math.inf, 3),
    "grid_k8_g2": ("grid", 480, 8, 16, 2, math.inf, 3),
    "grid_k100_g1": ("grid", 700, 100, 64, 1, math.inf, 3),
    "grid_k8_at_radius_g2": ("grid", 480, 8, 16, 2, 1.0, 3),
    "grid_k100_at_radius_g2": ("grid", 600, 100, 32, 2, 2.0, 3),
    # k above the bucket's rows: the rows keep init slots past S
    "grid_k40_above_s_g1": ("grid", 200, 40, 16, 1, math.inf, 3),
    "uniform_k50_above_s_g2": ("uniform", 300, 50, 16, 2, math.inf, 3),
    "normal_d128_k10_g2": ("normal", 400, 10, 16, 2, math.inf, 128),
    "normal_d128_k100_g1": ("normal", 700, 100, 64, 1, math.inf, 128),
    "grid_d128_k8_at_radius_g1": ("grid", 300, 8, 16, 1, 6.0, 128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_visit_fold_is_the_warm_start(case):
    """Each coarse bucket folded once into cold rows (the plain traversal
    of the bucket alone: one visit, no ``skip_self``) gives
    ``warm_start_self``'s rows of that bucket, bit for bit and whole:
    real rows, rows of padding queries (cold in both), init slots past the
    bucket's real points. The entry point takes the eager version for CPU
    tensors."""
    kind, n, k, bs, group, radius, dim = CASES[case]
    pc = resident(kind, n, bs, group, dim, seed=n + k)
    num_qb, s = pc.ids.shape
    assert bool((pc.ids < 0).any())
    want = ttiled.warm_start_self(pc, k, radius)
    visited = 0
    for b in range(num_qb):
        one = tpart.BucketedPoints(*(t[b:b + 1] for t in pc))
        got, visits = tk.knn_update_tiled_plain(
            init_candidates(s, k, radius), one, one, with_stats=True)
        rows = slice(b * s, (b + 1) * s)
        assert_rows_equal(got, CandidateState(want.dist2[rows],
                                              want.idx[rows]))
        assert int(visits) == int(bool((one.ids >= 0).any()))
        visited += int(visits)
    assert visited >= 1
    assert_rows_equal(tk.warm_start_self_cuda(pc, k, radius), want)


def _schedule(num_qb, width, order_dtype=torch.int32,
              d2_dtype=torch.float32):
    order = torch.zeros((num_qb, width), dtype=order_dtype)
    return order, torch.zeros((num_qb, width), dtype=d2_dtype)


@pytest.mark.parametrize("bad", ["order_i64", "sorted_d2_f64", "wrong_bq",
                                 "wider_than_bp", "no_column",
                                 "shapes_differ", "not_contiguous"])
def test_schedule_check_refuses(bad):
    """The kernels' schedule is i32 / f32 [Bq, V] with 1 <= V <= Bp,
    contiguous: anything else raises before a launch."""
    pc = resident("uniform", 300, 16, 2, 3, seed=3)
    num_qb, num_pb = pc.ids.shape[0], pc.ids.shape[0]
    rows = init_candidates(pc.ids.numel(), 4)
    order, d2 = {
        "order_i64": lambda: _schedule(num_qb, 1, order_dtype=torch.int64),
        "sorted_d2_f64": lambda: _schedule(num_qb, 1,
                                           d2_dtype=torch.float64),
        "wrong_bq": lambda: _schedule(num_qb + 1, 1),
        "wider_than_bp": lambda: _schedule(num_qb, num_pb + 1),
        "no_column": lambda: _schedule(num_qb, 0),
        "shapes_differ": lambda: (_schedule(num_qb, 1)[0],
                                  _schedule(num_qb, 2)[1]),
        "not_contiguous": lambda: tuple(t[:, ::2]
                                        for t in _schedule(num_qb, 2)),
    }[bad]()
    with pytest.raises(ValueError):
        tk._check_schedule(order, d2, pc, pc, rows)


@pytest.mark.parametrize("width", ["one", "all"])
def test_schedule_check_takes_one_visit_and_the_full_walk(width):
    pc = resident("uniform", 300, 16, 2, 3, seed=3)
    num_qb = pc.ids.shape[0]
    order, d2 = _schedule(num_qb, 1 if width == "one" else num_qb)
    tk._check_schedule(order, d2, pc, pc, init_candidates(pc.ids.numel(), 4))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


#: name: (kind, D, k, max_radius, the route's counter): every f32 route
CARD_ROUTES = {
    "d3_k8": ("uniform", 3, 8, math.inf, "d3_launches"),
    "d3_k100": ("uniform", 3, 100, math.inf, "d3_launches"),
    "d3_k100_grid_at_radius": ("grid", 3, 100, 1.0, "d3_launches"),
    "d3_k1000_wide": ("uniform", 3, 1000, math.inf, "d3_wide_launches"),
    "d128_k10_ring": ("normal", 128, 10, math.inf, "ring_launches"),
    "d240_k10_stream": ("normal", 240, 10, math.inf, "stream_launches"),
}
COUNTERS = ("launches", "d3_launches", "d3_wide_launches", "ring_launches",
            "stream_launches")


def _counts(fn):
    return {c: getattr(fn, c) for c in COUNTERS}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CARD_ROUTES))
def test_warm_start_on_the_card_is_the_eager_one(card, route):
    """One launch on the route the bucket's shapes name gives the eager
    rows bit for bit, rows of padding queries included; it counts in the
    warm start's counters and in none of the traversal's."""
    kind, dim, k, radius, counter = CARD_ROUTES[route]
    n = 20_000 if dim == 3 else 8_000
    pc = resident(kind, n, 256, 2, dim, seed=dim + k, device=card)
    assert bool((pc.ids < 0).any())
    want = ttiled.warm_start_self(pc, k, radius)
    before, traversal = (_counts(tk.warm_start_self_cuda),
                         _counts(tk.knn_update_tiled_cuda))
    got = tk.warm_start_self_cuda(pc, k, radius)
    torch.cuda.synchronize()
    after = _counts(tk.warm_start_self_cuda)
    assert after["launches"] == before["launches"] + 1
    assert after[counter] == before[counter] + 1
    if counter == "d3_wide_launches":
        assert after["d3_launches"] == before["d3_launches"] + 1
    assert _counts(tk.knn_update_tiled_cuda) == traversal
    assert_rows_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,score_dtype,counter", [
    (3, "f32", "d3_launches"), (128, "bf16", "ring_launches")])
def test_ring_warm_starts_each_shard_once(card, dim, score_dtype, counter):
    """A ``pallas_tiled`` self-join of 2 shards warm-starts each shard
    with one f32 launch, under bf16 too (the ring kernel at D=128; the
    traversal after it takes the matmul form), and its answers are the CPU
    run's: the kernels' rows are the plain version's."""
    shards = [points("normal", 3_000, seed=40 + r, dim=dim)
              for r in range(2)]
    flat, ids, _, _ = pad_and_flatten(shards, [0, 3_000], dim)
    before = _counts(tk.warm_start_self_cuda)
    mxu = tk.knn_update_tiled_cuda.mxu_launches
    got = tring.ring_knn(flat, ids, 10, 2, engine="pallas_tiled",
                         score_dtype=score_dtype, device=card)
    after = _counts(tk.warm_start_self_cuda)
    assert after["launches"] == before["launches"] + 2
    assert after[counter] == before[counter] + 2
    assert (tk.knn_update_tiled_cuda.mxu_launches > mxu) \
        == (score_dtype == "bf16")
    want = tring.ring_knn(flat, ids, 10, 2, engine="pallas_tiled",
                          score_dtype=score_dtype, device="cpu")
    real = torch.as_tensor(ids) >= 0
    assert torch.equal(got.cpu()[real], want[real])


@pytest.mark.cuda
@pytest.mark.parametrize("dim,counter", [(3, "d3_launches"),
                                         (128, "ring_launches")])
def test_demand_warm_starts_each_shard_once(card, dim, counter):
    """The pre-partitioned pipeline's demand ring (``demand_knn``) over 4
    overlapping shards warm-starts each shard with one f32 launch on the
    card, and its distances, ids and rounds are its CPU run's, whose warm
    start is the eager one."""
    shards = [points("normal", 2_000 + 300 * r, seed=60 + r, dim=dim)
              for r in range(4)]
    bases = np.cumsum([0] + [len(s) for s in shards[:-1]]).tolist()
    flat, ids, _, _ = pad_and_flatten(shards, bases, dim)
    before = _counts(tk.warm_start_self_cuda)
    got = tdemand.demand_knn(flat, ids, 10, 4, engine="pallas_tiled",
                             device=card, return_stats=True)
    after = _counts(tk.warm_start_self_cuda)
    assert after["launches"] == before["launches"] + 4
    assert after[counter] == before[counter] + 4
    want = tdemand.demand_knn(flat, ids, 10, 4, engine="pallas_tiled",
                              device="cpu", return_stats=True)
    real = torch.as_tensor(ids) >= 0
    assert torch.equal(got[0].cpu()[real], want[0][real])
    assert torch.equal(got[1].idx.cpu()[real], want[1].idx[real])
    assert got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k,radius", [
    ("uniform", 8, math.inf), ("uniform", 100, math.inf),
    ("grid", 100, 1.0), ("grid", 33, 0.5)])
def test_cold_walk_on_the_card_is_the_plain_one(card, kind, k, radius):
    """A whole walk from cold rows (no warm start) on the D=3 kernel's
    instance for cold rows, which enters each row by a sort at its first
    chunk and inserts after it, and on the traversal's instance: on grid
    points (hundreds of copies of each point, ties at every distance) and
    below a radius that keeps rows flat, the plain traversal's bits."""
    pts = torch.from_numpy(points(kind, 20_000, seed=k, dim=3)).to(card)
    q = tpart.partition_points(pts, bucket_size=256)
    pc = tpart.coarsen_buckets(q, 2)
    rows = init_candidates(q.ids.numel(), k, radius, device=card)
    want = tk.knn_update_tiled_plain(rows, q, pc)
    sorted_d2, order = tpart.nearest_first_order(q.lower, q.upper, pc.lower,
                                                 pc.upper)
    plan = tk.tiled_launch_plan(q.bucket_size, pc.bucket_size, k, 3)
    for cold in (True, False):
        got = CandidateState(rows.dist2.clone(), rows.idx.clone())
        tk.launch_f32_plan(plan, order, sorted_d2, q, pc, got,
                           skip_self=False, self_group=1, cold_rows=cold)
        torch.cuda.synchronize()
        assert_rows_equal(got, want)
