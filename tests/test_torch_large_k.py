"""The port's D=3 slice at k above 903, the largest k the first D=3 kernels
took (the kernels' wide fold), against the JAX package on the CPU: the
one-call API (``auto``) against the JAX ``pallas_tiled`` engine (its
traversal kernel in interpret mode), the flat engine ``pallas`` against
the JAX ``pallas`` engine, and a ``ResidentKnnEngine`` batch against the
JAX serving engine's. Inputs are seeded numpy points; the port runs its
kernels' plain versions here (``chip_smoke.py`` holds the kernels to them
bit for bit on the card). Tolerance: distances and neighbor ids bitwise.
The JAX Pallas fold runs with one segment (``LSK_FOLD_SEGS=1``), as in
the port's other parity tests: at k >= 32 its multi-segment fold breaks
lane order on exact ties, which a few thousand uniform f32 points at
k=1000 do meet."""

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch import kth_neighbor_distances as torch_knn
from mpi_cuda_largescaleknn_torch.serve.engine import (
    ResidentKnnEngine as PortEngine,
)
from mpi_cuda_largescaleknn_tpu import kth_neighbor_distances as jax_knn
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from mpi_cuda_largescaleknn_tpu.serve.engine import (
    ResidentKnnEngine as JaxEngine,
)
from tests.oracle import kth_nn_dist, random_points
from tests.test_torch_ops import assert_bitwise


@pytest.fixture(autouse=True)
def one_fold_segment(monkeypatch):
    monkeypatch.setenv("LSK_FOLD_SEGS", "1")


@pytest.mark.parametrize("num_shards,k", [(1, 1000), (4, 1025)])
def test_kth_neighbor_distances_match_jax_above_903(num_shards, k):
    """``auto`` (the traversal) at R=1 and R=4 against the JAX
    ``pallas_tiled`` engine, k=1000 and 1025, on 1,400 points."""
    pts = random_points(1400, seed=19 + k)
    want_d, want_i = jax_knn(pts, k, num_shards=num_shards,
                             engine="pallas_tiled", return_neighbors=True)
    got_d, got_i = torch_knn(pts, k, num_shards=num_shards,
                             return_neighbors=True, device="cpu")
    assert_bitwise(got_d, np.asarray(want_d))
    assert_bitwise(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_d, kth_nn_dist(pts, pts, k), rtol=5e-7,
                               atol=1e-37)


def test_flat_engine_matches_jax_above_903():
    """``--engine pallas`` (the flat fold) at k=1000 against the JAX
    ``pallas`` engine (its flat kernel in interpret mode), on 1,500
    points."""
    pts = random_points(1500, seed=1000)
    want_d, want_i = jax_knn(pts, 1000, num_shards=1, engine="pallas",
                             return_neighbors=True)
    got_d, got_i = torch_knn(pts, 1000, num_shards=1, engine="pallas",
                             return_neighbors=True, device="cpu")
    assert_bitwise(got_d, np.asarray(want_d))
    assert_bitwise(got_i, np.asarray(want_i))


def test_resident_engine_matches_jax_above_903():
    """A ``ResidentKnnEngine`` batch of 100 rows at k=1000,
    ``pallas_tiled``, against the JAX serving engine's, both over the same
    1,500 points: distances byte-equal, ids equal, and the exact answer
    within the oracle's tolerance."""
    pts = random_points(1500, seed=7)
    q = random_points(100, seed=8)
    kw = dict(engine="pallas_tiled", bucket_size=32, max_batch=128,
              min_batch=16)
    jax_eng = JaxEngine(pts, 1000, mesh=get_mesh(1), **kw)
    port_eng = PortEngine(pts, 1000, num_shards=1, device="cpu", **kw)
    jd, ji = jax_eng.query(q)
    pd, pi = port_eng.query(q)
    assert pd.dtype == np.float32 and pi.dtype == np.int32
    assert jd.tobytes() == pd.tobytes()
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, kth_nn_dist(q, pts, 1000), rtol=5e-7,
                               atol=1e-37)
