"""The PyTorch port's host-side modules and ops against the JAX package, on
the CPU: the same numpy inputs through both, bitwise-equal arrays."""

import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import convert
from mpi_cuda_largescaleknn_torch.core import config as tconfig
from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.models import sharding as tshard
from mpi_cuda_largescaleknn_torch.obs import selfcheck as tcheck
from mpi_cuda_largescaleknn_torch.ops import candidates as tcand
from mpi_cuda_largescaleknn_torch.ops import distance as tdist
from mpi_cuda_largescaleknn_torch.ops import partition as tpart
from mpi_cuda_largescaleknn_torch.ops import tiled as ttiled
from mpi_cuda_largescaleknn_torch.utils import math as tmath
from mpi_cuda_largescaleknn_tpu.core import config as jconfig
from mpi_cuda_largescaleknn_tpu.core.types import CandidateState as JState
from mpi_cuda_largescaleknn_tpu.models import sharding as jshard
from mpi_cuda_largescaleknn_tpu.obs import selfcheck as jcheck
from mpi_cuda_largescaleknn_tpu.ops import candidates as jcand
from mpi_cuda_largescaleknn_tpu.ops import distance as jdist
from mpi_cuda_largescaleknn_tpu.ops import partition as jpart
from mpi_cuda_largescaleknn_tpu.ops import tiled as jtiled
from mpi_cuda_largescaleknn_tpu.utils import math as jmath
from tests.oracle import random_points


def points(kind: str, n: int, seed: int, dim: int = 3) -> np.ndarray:
    """Seeded test point sets of dimension ``dim``: uniform, standard
    normal (zero-mean, for the matmul form), two far clusters, or uniform
    with exact duplicates (ties in coordinates, box and point distances)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((n, dim)).astype(np.float32)
    if kind == "normal":
        return rng.standard_normal((n, dim)).astype(np.float32)
    if kind == "clustered":
        half = n // 2
        a = rng.random((half, dim)) * 0.1
        b = rng.random((n - half, dim)) * 0.1 + 50.0
        return np.concatenate([a, b]).astype(np.float32)
    base = rng.random((n // 3 + 1, dim)).astype(np.float32)
    return base[rng.integers(0, len(base), n)]


def assert_bitwise(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def both_partitions(pts, bucket_size, ids=None):
    jq = jpart.partition_points(jnp.asarray(pts), None if ids is None
                                else jnp.asarray(ids),
                                bucket_size=bucket_size)
    tq = tpart.partition_points(torch.from_numpy(pts), None if ids is None
                                else torch.from_numpy(ids),
                                bucket_size=bucket_size)
    return jq, tq


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 255, 256, 257, 1000])
def test_math_helpers_match(n):
    for b in (1, 3, 8, 128):
        assert tmath.cdiv(n, b) == jmath.cdiv(n, b)
        assert tmath.round_up(n, b) == jmath.round_up(n, b)
    assert tmath.next_pow2(n) == jmath.next_pow2(n)


@pytest.mark.parametrize("n,target", [(1, 16), (100, 16), (600, 32),
                                      (1_000_000, 256), (250_000, 256),
                                      (32_768, 256)])
def test_choose_buckets_matches(n, target):
    assert tpart.choose_buckets(n, target) == jpart.choose_buckets(n, target)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "dupes"])
@pytest.mark.parametrize("n,bucket_size", [(5, 16), (100, 16), (600, 32),
                                           (333, 8)])
def test_partition_bitwise(kind, n, bucket_size):
    pts = points(kind, n, seed=n)
    ids = np.arange(1000, 1000 + n, dtype=np.int32)
    jq, tq = both_partitions(pts, bucket_size, ids)
    for name in ("pts", "ids", "lower", "upper", "pos"):
        assert_bitwise(getattr(tq, name).numpy(), getattr(jq, name))


@pytest.mark.parametrize("kind", ["uniform", "clustered", "dupes"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_coarsen_and_visit_order_bitwise(kind, group):
    pts = points(kind, 500, seed=3)
    jq, tq = both_partitions(pts, 16)
    jc = jpart.coarsen_buckets(jq, group)
    tc = tpart.coarsen_buckets(tq, group)
    for name in ("pts", "ids", "lower", "upper", "pos"):
        assert_bitwise(getattr(tc, name).numpy(), getattr(jc, name))
    assert_bitwise(
        tpart.bucket_box_dist2(tq.lower, tq.upper, tc.lower, tc.upper).numpy(),
        jpart.bucket_box_dist2(jq.lower, jq.upper, jc.lower, jc.upper))
    jd2, jorder = jpart.nearest_first_order(jq.lower, jq.upper,
                                            jc.lower, jc.upper)
    td2, torder = tpart.nearest_first_order(tq.lower, tq.upper,
                                            tc.lower, tc.upper)
    assert_bitwise(td2.numpy(), jd2)
    assert_bitwise(torder.numpy(), jorder)


@pytest.mark.parametrize("dim", [3, 16])
def test_box_dist2_per_component_equals_broadcast_form(dim):
    """One component at a time gives the bits of the [Bq, Bp, D] broadcast
    form; at D=3 also the JAX package's."""
    pts = points("uniform", 600, seed=dim, dim=dim)
    jq, tq = both_partitions(pts, 16)
    tc = tpart.coarsen_buckets(tq, 2)
    diff = torch.clamp_min(
        torch.maximum(tq.lower[:, None, :] - tc.upper[None, :, :],
                      tc.lower[None, :, :] - tq.upper[:, None, :]), 0.0)
    want = None
    for i in range(dim):
        sq = diff[..., i] * diff[..., i]
        want = sq if want is None else want + sq
    want = torch.where(torch.isnan(want), torch.inf, want)
    got = tpart.bucket_box_dist2(tq.lower, tq.upper, tc.lower, tc.upper)
    assert_bitwise(got.numpy(), want.numpy())
    if dim == 3:
        jc = jpart.coarsen_buckets(jq, 2)
        assert_bitwise(got.numpy(), jpart.bucket_box_dist2(
            jq.lower, jq.upper, jc.lower, jc.upper))


def test_scatter_back_matches():
    pts = points("uniform", 150, seed=5)
    jq, tq = both_partitions(pts, 16)
    vals = np.random.default_rng(0).random(jq.ids.shape).astype(np.float32)
    want = jpart.scatter_back(jnp.asarray(vals), jq.pos, 160, fill=jnp.inf)
    got = tpart.scatter_back(torch.from_numpy(vals), tq.pos, 160,
                             fill=torch.inf)
    assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("dim", [2, 3, 5, 16, 128])
def test_elementwise_dist2_bitwise(dim):
    q = random_points(37, seed=1, scale=7.0, dim=dim)
    p = random_points(53, seed=2, scale=7.0, dim=dim)
    assert_bitwise(tdist.elementwise_dist2(torch.from_numpy(q),
                                           torch.from_numpy(p)).numpy(),
                   jdist.elementwise_dist2(jnp.asarray(q), jnp.asarray(p)))


@pytest.mark.parametrize("radius", [math.inf, 0.35, 1e-3])
def test_init_candidates_matches(radius):
    j = jcand.init_candidates(10, 4, radius)
    t = tcand.init_candidates(10, 4, radius)
    assert_bitwise(t.dist2.numpy(), j.dist2)
    assert_bitwise(t.idx.numpy(), j.idx)


@pytest.mark.parametrize("k,t", [(1, 5), (4, 4), (8, 3), (8, 40), (100, 130)])
def test_merge_candidates_bitwise_with_ties(k, t):
    rng = np.random.default_rng(k * 1000 + t)
    q = 24
    # few distinct values: ties between existing and new entries, and
    # among new lanes, at every position including the k-boundary
    levels = np.array([0.0, 0.25, 0.5, 1.0, np.inf], np.float32)
    st_d2 = np.sort(rng.choice(levels, (q, k)), axis=1).astype(np.float32)
    st_idx = rng.integers(-1, 50, (q, k)).astype(np.int32)
    c_d2 = rng.choice(levels, (q, t)).astype(np.float32)
    c_idx = rng.integers(100, 200, (q, t)).astype(np.int32)
    j = jcand.merge_candidates(JState(jnp.asarray(st_d2), jnp.asarray(st_idx)),
                               jnp.asarray(c_d2), jnp.asarray(c_idx))
    tt = tcand.merge_candidates(CandidateState(torch.from_numpy(st_d2),
                                               torch.from_numpy(st_idx)),
                                torch.from_numpy(c_d2),
                                torch.from_numpy(c_idx))
    assert_bitwise(tt.dist2.numpy(), j.dist2)
    assert_bitwise(tt.idx.numpy(), j.idx)


def test_extract_final_result_is_correctly_rounded():
    # values whose f32 square root PyTorch's vectorized CPU sqrt misses
    # by one ulp; the port must give the JAX package's (and numpy's) bits
    d2 = random_points(4096, seed=9, dim=4).astype(np.float32)
    d2[:, -1] = np.sort(d2[:, -1])
    d2[:5, -1] = [0.016817069, 0.0, np.inf, 1e-30, 3.0]
    want = jcand.extract_final_result(JState(jnp.asarray(d2),
                                             jnp.zeros(d2.shape, jnp.int32)))
    got = tcand.extract_final_result(CandidateState(
        torch.from_numpy(d2), torch.zeros(d2.shape, dtype=torch.int32)))
    assert_bitwise(got.numpy(), want)
    assert_bitwise(got.numpy(), np.sqrt(d2[:, -1]))


@pytest.mark.parametrize("kind", ["uniform", "dupes"])
@pytest.mark.parametrize("k,group,radius", [(1, 1, math.inf), (8, 2, math.inf),
                                            (100, 2, math.inf), (8, 4, 0.05),
                                            (40, 1, 0.1)])
def test_warm_start_self_bitwise(kind, k, group, radius):
    pts = points(kind, 450, seed=k)
    jq, tq = both_partitions(pts, 16)
    j = jtiled.warm_start_self(jpart.coarsen_buckets(jq, group), k, radius)
    t = ttiled.warm_start_self(tpart.coarsen_buckets(tq, group), k, radius)
    assert_bitwise(t.dist2.numpy(), j.dist2)
    assert_bitwise(t.idx.numpy(), j.idx)


def test_convert_round_trip():
    pts = points("uniform", 200, seed=4)
    jq, tq = both_partitions(pts, 16)
    conv = convert.bucketed_points(jq)
    for name in ("pts", "ids", "lower", "upper", "pos"):
        assert torch.equal(getattr(conv, name), getattr(tq, name))
    st = jcand.init_candidates(12, 3, 0.5)
    cs = convert.candidate_state(st)
    assert cs.dist2.dtype == torch.float32 and cs.idx.dtype == torch.int32
    assert_bitwise(cs.dist2.numpy(), st.dist2)


@pytest.mark.parametrize("n,r", [(10, 1), (10, 3), (1001, 4), (7, 8)])
def test_sharding_helpers_match(n, r):
    assert tshard.slab_bounds(n, r) == jshard.slab_bounds(n, r)
    pts = random_points(n, seed=n)
    bounds = tshard.slab_bounds(n, r)
    shards = [pts[b:e] for b, e in bounds]
    bases = [b for b, _ in bounds]
    got = tshard.pad_and_flatten(shards, id_bases=bases, dim=3)
    want = jshard.pad_and_flatten(shards, id_bases=bases, dim=3)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    assert got[2:] == want[2:]
    flat = np.arange(r * got[3], dtype=np.float32)
    for a, b in zip(tshard.trim_per_shard(flat, got[2], got[3]),
                    jshard.trim_per_shard(flat, want[2], want[3])):
        assert_bitwise(a, b)


def test_neighbor_id_capacity():
    tshard.check_neighbor_id_capacity(2**31)
    with pytest.raises(ValueError):
        tshard.check_neighbor_id_capacity(2**31 + 1)


@pytest.mark.parametrize("k,radius", [(1, math.inf), (5, math.inf),
                                      (5, 0.05)])
def test_selfcheck_matches(k, radius):
    pts = random_points(700, seed=k)
    idx = np.arange(0, 700, 7)
    assert_bitwise(tcheck.kth_distance_exact(pts, idx, k, radius),
                   jcheck.kth_distance_exact(pts, idx, k, radius))
    good = jcheck.kth_distance_exact(pts, np.arange(700), k, radius)
    assert tcheck.verify_sample(pts, good, k, 50, max_radius=radius) == 50
    bad = good.copy()
    bad[:] = bad * 1.01 + 1e-3
    with pytest.raises(AssertionError):
        tcheck.verify_sample(pts, bad, k, 50, max_radius=radius)


@pytest.mark.parametrize("field,value,exc", [
    ("k", 0, ValueError),
    ("engine", "nope", ValueError),
    ("score_dtype", "fp8", ValueError),
    ("merge", "nope", ValueError),
    ("checkpoint_every", 0, ValueError),
    ("point_group", 3, ValueError),
    ("query_tile", 0, ValueError),
])
def test_config_refuses_what_is_not_ported(field, value, exc):
    kw = {"k": 4, field: value}
    with pytest.raises(exc) as err:
        tconfig.KnnConfig(**kw).validate()
    if exc is NotImplementedError:
        assert "ROADMAP.md" in str(err.value)


@pytest.mark.parametrize("field,value", [
    ("query_chunk", 64), ("checkpoint_dir", "ckpt"), ("merge", "device"),
    ("merge", "auto"), ("checkpoint_every", 3)])
def test_config_accepts_chunk_merge_and_checkpoint_options(field, value):
    tconfig.KnnConfig(k=4, **{field: value}).validate()
    jconfig.KnnConfig(k=4, **{field: value}).validate()


@pytest.mark.parametrize("score_dtype", ["f32", "bf16"])
def test_config_accepts_both_score_dtypes(score_dtype):
    tconfig.KnnConfig(k=4, score_dtype=score_dtype).validate()


def test_config_accepts_profile_dir():
    tconfig.KnnConfig(k=4, profile_dir="prof").validate()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconfig.resolve_device(None)
    from mpi_cuda_largescaleknn_torch import kth_neighbor_distances
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kth_neighbor_distances(random_points(20, seed=0), 2)
    assert tconfig.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    # modules loaded before the port's import (site hooks) do not count
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import mpi_cuda_largescaleknn_torch\n"
        "import mpi_cuda_largescaleknn_torch.cli.unordered_main\n"
        "import mpi_cuda_largescaleknn_torch.cli.prepartitioned_main\n"
        "import mpi_cuda_largescaleknn_torch.cli.partition_main\n"
        "import mpi_cuda_largescaleknn_torch.parallel.demand\n"
        "import mpi_cuda_largescaleknn_torch.ops.knn_bf\n"
        "import mpi_cuda_largescaleknn_torch.ops.knn_tiled\n"
        "import mpi_cuda_largescaleknn_torch.convert\n"
        "import mpi_cuda_largescaleknn_torch.utils.cuda_build\n"
        "import mpi_cuda_largescaleknn_torch.io.native\n"
        "bad = [m for m in set(sys.modules) - before"
        " if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'mpi_cuda_largescaleknn_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
