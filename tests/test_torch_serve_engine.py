"""The port's serving engine (``serve/engine.py`` ``ResidentKnnEngine``,
``device="cpu"``: the kernels' plain versions) against the JAX package's,
on the same seeded points and queries: distances byte-equal, ids equal on
tie-free data, and the same launch-plan count (``compile_count``), query
buckets and twin tile counters, on meshes of 1 and 8 (the port: 1 and 8
virtual shards). The JAX package's ``pallas_tiled`` engine runs its
kernel in interpret mode here."""

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.serve.engine import (
    ResidentKnnEngine as PortEngine,
)
from mpi_cuda_largescaleknn_torch.serve.engine import UnservableShapeError
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from mpi_cuda_largescaleknn_tpu.serve.engine import (
    ResidentKnnEngine as JaxEngine,
)
from tests.oracle import assert_dist_equal, kth_nn_dist, random_points

K = 8
N_POINTS = 1500
SIZES = (0, 1, 7, 16, 100, 128)
BASE = dict(bucket_size=32, max_batch=128, min_batch=16)


@pytest.fixture(scope="module")
def points():
    return random_points(N_POINTS, seed=7)


@pytest.fixture(scope="module")
def pair_cache():
    return {}


def _pair(cache, pts, shards, engine, **kw):
    """(JAX engine, port engine), both warmed, built once a module."""
    key = (id(pts), shards, engine, tuple(sorted(kw.items())))
    if key not in cache:
        args = dict(BASE, **kw)
        j = JaxEngine(pts, K, mesh=get_mesh(shards), engine=engine, **args)
        p = PortEngine(pts, K, num_shards=shards, engine=engine,
                       device="cpu", **args)
        j.warmup()
        p.warmup()
        cache[key] = (j, p)
    return cache[key]


def _queries(n, seed):
    return (random_points(n, seed=seed) if n
            else np.zeros((0, 3), np.float32))


def _same(j, p, q, ids=True, **kw):
    jd, ji = j.query(q, **kw)
    pd, pi = p.query(q, **kw)
    assert pd.dtype == np.float32 and pi.dtype == np.int32
    assert jd.tobytes() == pd.tobytes()
    if ids:
        np.testing.assert_array_equal(ji, pi)
    return pd, pi


CASES = [(shards, engine, merge, qb)
         for shards in (1, 8)
         for engine, qbs in (("tiled", (0, 1)), ("bruteforce", (0,)))
         for merge in ("host", "device")
         for qb in qbs]


@pytest.mark.parametrize("shards,engine,merge,qb", CASES)
def test_engine_matches_jax(pair_cache, points, shards, engine, merge, qb):
    j, p = _pair(pair_cache, points, shards, engine, merge=merge,
                 query_buckets=qb)
    assert p.merge_mode == j.merge_mode == merge
    assert p.shape_buckets == j.shape_buckets
    assert p.query_buckets == j.query_buckets
    assert p.sort_queries == j.sort_queries
    assert p.canonical_ties == j.canonical_ties
    assert p.compile_count == j.compile_count == len(p.shape_buckets)
    for n in SIZES:
        q = _queries(n, 99 + n)
        d, _ = _same(j, p, q)
        assert_dist_equal(d, kth_nn_dist(q, points, K))
    # no client batch size builds another plan
    assert p.compile_count == j.compile_count == len(p.shape_buckets)
    js, ps = j.stats(), p.stats()
    assert set(js) == set(ps)
    for key in ("compile_count", "compiled_shapes", "query_buckets",
                "shape_buckets", "tiles_executed", "tiles_skipped",
                "tiles_executed_vpu", "tiles_skipped_vpu", "fetch_bytes",
                "result_rows", "merge", "engine", "num_shards",
                "shard_bounds", "sort_queries", "canonical_ties"):
        assert ps[key] == js[key], key


@pytest.mark.parametrize("shards", [1, 8])
def test_pallas_tiled_matches_interpret_mode_pallas(pair_cache, points,
                                                    shards):
    """The traversal kernel's plain version in the port's engine against
    the JAX engine's Pallas kernel (interpret mode): distances and ids;
    the plan counts and query buckets too (the kernel's tile counts are
    its own: the port refreshes the radius after every bucket)."""
    j, p = _pair(pair_cache, points, shards, "pallas_tiled")
    assert p.engine_name == j.engine_name == "pallas_tiled"
    for n in SIZES:
        _same(j, p, _queries(n, 300 + n))
    js, ps = j.stats(), p.stats()
    for key in ("compile_count", "query_buckets", "shape_buckets"):
        assert ps[key] == js[key], key
    # executed + skipped is the kernel's ceiling: buckets x rows
    num_pb = p._buckets[0].ids.shape[0]
    # warmup runs every bucket once; SIZES pad to 16, 16, 16, 128, 128
    rows = sum(p.shape_buckets) + 16 * 3 + 128 * 2
    assert ps["tiles_executed"] + ps["tiles_skipped"] == \
        shards * rows * num_pb
    assert 0 < ps["tiles_executed"] < shards * rows * num_pb


def test_twin_tiles_partition_the_schedule(pair_cache, points):
    """On the twin, executed + skipped tile rows equal the schedule's
    ceiling, batch by batch (the JAX engine's counters, equal to it)."""
    from mpi_cuda_largescaleknn_torch.ops.tiled import tile_schedule_slots

    j, p = _pair(pair_cache, points, 8, "tiled", merge="host",
                 query_buckets=0)
    num_pb = p._buckets[0].ids.shape[0]
    for n in (5, 60, 128):
        before = (p.stats()["tiles_executed"], p.stats()["tiles_skipped"])
        _same(j, p, _queries(n, 700 + n))
        ex = p.stats()["tiles_executed"] - before[0]
        sk = p.stats()["tiles_skipped"] - before[1]
        assert ex + sk == 8 * p.bucket_for(n) * tile_schedule_slots(num_pb)
        assert ex > 0


def test_bf16_at_d16_matches_jax():
    """bf16 at D=16 (the matmul form engages): the twin and the flat twin
    against JAX's same engines, and the port's traversal kernel (plain)
    against JAX's twin: exact rescored distances, ids on tie-free data."""
    rng = np.random.default_rng(16)
    pts = rng.standard_normal((1200, 16)).astype(np.float32)
    cache = {}
    for engine in ("tiled", "bruteforce"):
        j, p = _pair(cache, pts, 4, engine, score_dtype="bf16")
        assert p.score_mode == j.score_mode == "mxu"
        for n in (1, 16, 100):
            _same(j, p, rng.standard_normal((n, 16)).astype(np.float32))
        if engine == "tiled":
            assert p.stats()["tiles_executed_mxu"] == \
                j.stats()["tiles_executed_mxu"] > 0
    j, _ = _pair(cache, pts, 4, "tiled", score_dtype="bf16")
    p = PortEngine(pts, K, num_shards=4, engine="pallas_tiled",
                   score_dtype="bf16", device="cpu", **BASE)
    assert p.query_buckets == j.query_buckets   # D != 3: one bucket
    f32 = PortEngine(pts, K, num_shards=4, engine="tiled", device="cpu",
                     **BASE)
    for n in (3, 64, 128):
        q = rng.standard_normal((n, 16)).astype(np.float32)
        pd, _ = _same(j, p, q)
        assert pd.tobytes() == f32.query(q)[0].tobytes()


@pytest.mark.parametrize("engine", ["tiled", "pallas_tiled", "bruteforce"])
def test_finite_radius_underfull_rows_match_jax(engine):
    pts = random_points(800, seed=3)
    j = JaxEngine(pts, K, mesh=get_mesh(4), engine=engine, max_radius=0.05,
                  **BASE)
    p = PortEngine(pts, K, num_shards=4, engine=engine, max_radius=0.05,
                   device="cpu", **BASE)
    q = _queries(100, 17)
    d, idx = _same(j, p, q)
    assert np.isclose(d, 0.05).any() and (idx == -1).any()
    assert_dist_equal(d, kth_nn_dist(q, pts, K, max_radius=0.05))


def test_seeded_radius_rows_match_jax_and_unseeded(pair_cache, points):
    """Certified seeds (strictly above each row's k-th distance, as the
    query cache makes them; inf for unseeded rows) change no bit, and the
    port runs the same seeded batch as JAX."""
    j, p = _pair(pair_cache, points, 8, "tiled", merge="device",
                 query_buckets=0)
    q = _queries(100, 41)
    want, want_idx = p.query(q)
    seeds = np.nextafter(want * np.float32(1.001), np.float32(np.inf))
    seeds[::3] = np.inf
    before = p.stats()["timers"].get("seeded_rows", 0)
    d, idx = _same(j, p, q, seed_radius=seeds)
    assert d.tobytes() == want.tobytes()
    np.testing.assert_array_equal(idx, want_idx)
    assert p.stats()["timers"]["seeded_rows"] - before == \
        int(np.sum(np.isfinite(seeds)))
    with pytest.raises(ValueError, match="seed_radius"):
        p.dispatch(q, seed_radius=seeds[:5])


def test_grid_ties_canonical_across_query_buckets():
    """Integer-grid points (most distances tie many times over): the
    twin's canonical ids are the same with the Morton sort and many query
    buckets as with one unsorted bucket, and the same as JAX's."""
    rng = np.random.default_rng(11)
    pts = rng.integers(0, 12, (900, 3)).astype(np.float32)
    q = rng.integers(0, 12, (128, 3)).astype(np.float32)
    got = []
    for qb in (1, 0):
        for shards in (1, 4):
            j = JaxEngine(pts, K, mesh=get_mesh(shards), engine="tiled",
                          query_buckets=qb, **BASE)
            p = PortEngine(pts, K, num_shards=shards, engine="tiled",
                           query_buckets=qb, device="cpu", **BASE)
            assert p.sort_queries == (qb != 1)
            for n in (17, 128):
                got.append(_same(j, p, q[:n]))
    for d, idx in got[2::2]:
        assert d.tobytes() == got[0][0].tobytes()
        np.testing.assert_array_equal(idx, got[0][1])


def test_degrade_swaps_to_the_twin(points):
    p = PortEngine(points, K, num_shards=2, engine="pallas_tiled",
                   device="cpu", **BASE)
    q = _queries(50, 5)
    want = p.query(q)
    assert p.can_degrade()
    p.degrade("RuntimeError: kernel launch failed")
    assert not p.can_degrade() and p.engine_name == "tiled"
    assert p.stats()["degraded_reason"] == \
        "RuntimeError: kernel launch failed"
    got = p.query(q)
    assert got[0].tobytes() == want[0].tobytes()
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(RuntimeError, match="no fallback"):
        p.degrade("again")


def test_shapes_refusals_and_device(points, monkeypatch):
    p = PortEngine(points[:200], K, engine="tiled", device="cpu", **BASE)
    with pytest.raises(UnservableShapeError):
        p.query(_queries(129, 1))
    assert p.bucket_for(1) == 16 and p.bucket_for(17) == 32
    h = p.dispatch(_queries(20, 2))
    assert h.qpad == 32 and h.done is None
    p.complete(h)
    with pytest.raises(ValueError, match="serving engine"):
        PortEngine(points, K, engine="tree", device="cpu")
    # device=None is the card: it raises without CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortEngine(points, K)


def test_device_bytes_count_the_prepared_side(points):
    t = PortEngine(points, K, num_shards=2, engine="tiled", device="cpu",
                   **BASE)
    k = PortEngine(points, K, num_shards=2, engine="pallas_tiled",
                   device="cpu", **BASE)
    extra = sum(pp.nbytes() for pp in k._prepared)
    assert extra > 0 and k.device_bytes == t.device_bytes + extra
