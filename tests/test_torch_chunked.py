"""The port's chunked loops against the JAX package on the CPU:
``ring_knn_chunked`` (both merges, both engines, uneven chunks, bf16),
``demand_knn_chunked`` (rounds per chunk and the summed counts), the
device merge's tie order, and ``resolve_merge``. Stated tolerance: d2 and
ids bit-equal on tie-free data (the device merge's ties are pinned
against numpy's stable argsort). The JAX side runs its Pallas kernels in
interpret mode under explicit engine names."""

import logging

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.models.sharding import (
    pad_and_flatten,
    slab_bounds,
)
from mpi_cuda_largescaleknn_torch.ops.candidates import tree_merge_candidates
from mpi_cuda_largescaleknn_torch.parallel import demand as tdemand
from mpi_cuda_largescaleknn_torch.parallel import ring as tring
from mpi_cuda_largescaleknn_tpu.parallel import demand as jdemand
from mpi_cuda_largescaleknn_tpu.parallel import ring as jring
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from tests.oracle import random_points
from tests.test_torch_demand import separated
from tests.test_torch_mxu import points
from tests.test_torch_ops import assert_bitwise

TILES = {"query_tile": 64, "point_tile": 128}


def sharded(pts, num_shards):
    bounds = slab_bounds(len(pts), num_shards)
    flat, ids, _counts, _npad = pad_and_flatten(
        [pts[b:e] for b, e in bounds], [b for b, _ in bounds], pts.shape[1])
    return flat, ids


def assert_rows_match(got_d, got_c, want_d, want_c, ids):
    real = ids >= 0
    assert_bitwise(got_d.numpy()[real], np.asarray(want_d)[real])
    assert_bitwise(got_c.dist2.numpy()[real],
                   np.asarray(want_c.dist2)[real])
    assert_bitwise(got_c.idx.numpy()[real], np.asarray(want_c.idx)[real])


@pytest.mark.parametrize("chunk_rows", [16, 23, 40])
@pytest.mark.parametrize("merge", ["host", "device"])
@pytest.mark.parametrize("engine", ["pallas_tiled", "pallas"])
def test_ring_chunked_matches_jax(engine, merge, chunk_rows):
    flat, ids = sharded(random_points(400, seed=chunk_rows), 4)
    kw = dict(chunk_rows=chunk_rows, engine=engine, merge=merge,
              bucket_size=16, return_candidates=True, return_stats=True,
              **TILES)
    want_d, want_c, want_s = jring.ring_knn_chunked(flat, ids, 6,
                                                    get_mesh(4), **kw)
    got_d, got_c, got_s = tring.ring_knn_chunked(flat, ids, 6, 4,
                                                 device="cpu", **kw)
    assert got_d.device.type == "cpu"
    assert_rows_match(got_d, got_c, want_d, want_c, ids)
    if engine == "pallas":
        # the traversal's visit counts follow each kernel's pruning
        # granularity; the flat engine's pairs are analytic
        assert got_s == want_s


def test_ring_chunked_bf16_matches_jax():
    pts = points("normal", 300, seed=71, dim=16)
    flat, ids = sharded(pts, 2)
    kw = dict(chunk_rows=40, bucket_size=16, score_dtype="bf16",
              return_candidates=True)
    want_d, want_c = jring.ring_knn_chunked(flat, ids, 8, get_mesh(2),
                                            engine="pallas_tiled", **kw)
    got_d, got_c = tring.ring_knn_chunked(flat, ids, 8, 2, device="cpu",
                                          **kw)
    assert_rows_match(got_d, got_c, want_d, want_c, ids)
    exact_d = tring.ring_knn(flat, ids, 8, 2, bucket_size=16, device="cpu")
    assert torch.equal(got_d[ids >= 0], exact_d[ids >= 0])


def test_chunked_equals_fused_and_depths_and_groups_agree():
    flat, ids = sharded(random_points(520, seed=5), 4)
    real = ids >= 0
    fused_d, fused_c = tring.ring_knn(flat, ids, 7, 4, bucket_size=16,
                                      device="cpu", return_candidates=True)
    runs = [tring.ring_knn_chunked(flat, ids, 7, 4, chunk_rows=48,
                                   bucket_size=16, device="cpu",
                                   pipeline_depth=depth, point_group=group,
                                   return_candidates=True)
            for depth, group in ((1, 0), (2, 0), (3, 0), (2, 1), (2, 4))]
    for d, c in runs:
        assert torch.equal(d[real], fused_d[real])
        assert torch.equal(c.idx[real], fused_c.idx[real])
        assert torch.equal(c.dist2, runs[0][1].dist2)


@pytest.mark.parametrize("engine", ["pallas_tiled", "pallas"])
def test_demand_chunked_matches_jax(engine):
    parts = separated(4, 60, 0.85, 60)
    parts[1] = parts[1][:25]     # uneven: some chunks hold no real rows
    flat, ids, _counts, _npad = pad_and_flatten(
        parts, list(np.cumsum([0] + [len(p) for p in parts])[:-1]), 3)
    kw = dict(chunk_rows=24, engine=engine, bucket_size=16,
              return_candidates=True, return_stats=True, **TILES)
    want_d, want_c, want_s = jdemand.demand_knn_chunked(flat, ids, 8,
                                                        get_mesh(4), **kw)
    got_d, got_c, got_s = tdemand.demand_knn_chunked(flat, ids, 8, 4,
                                                     device="cpu", **kw)
    assert_rows_match(got_d, got_c, want_d, want_c, ids)
    assert got_s == {"rounds": np.asarray(want_s["rounds"]).tolist(),
                     "kernels_run": np.asarray(
                         want_s["kernels_run"]).tolist(),
                     "rotations_run": np.asarray(
                         want_s["rotations_run"]).tolist()}
    assert len(got_s["rounds"]) == 3 and min(got_s["rounds"]) < 3


def grid_states(num_shards, rows, k, seed):
    """Per-shard sorted rows of integer-grid distances (many exact ties),
    ids distinct across shards."""
    rng = np.random.default_rng(seed)
    d2 = np.sort(rng.integers(0, 4, (num_shards, rows, k)).astype(
        np.float32), axis=2)
    d2[:, :, -1:][rng.random((num_shards, rows, 1)) < 0.3] = np.inf
    idx = np.arange(num_shards * rows * k, dtype=np.int32).reshape(
        num_shards, rows, k)
    return d2, idx


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_device_merge_ties_follow_a_stable_argsort(num_shards):
    rows, k = 33, 5
    d2, idx = grid_states(num_shards, rows, k, seed=num_shards)
    states = [CandidateState(torch.from_numpy(d2[s]),
                             torch.from_numpy(idx[s]))
              for s in range(num_shards)]
    # shard-major columns, the lower (shard, slot) first among equals
    cat_d2 = d2.transpose(1, 0, 2).reshape(rows, num_shards * k)
    cat_idx = idx.transpose(1, 0, 2).reshape(rows, num_shards * k)
    cols = np.argsort(cat_d2, axis=1, kind="stable")[:, :k]
    want_d2 = np.take_along_axis(cat_d2, cols, 1)
    want_idx = np.take_along_axis(cat_idx, cols, 1)
    for via in ("a2a", "tree"):
        dists, st = tring.device_merge_final(states, via=via)
        assert_bitwise(st.dist2.numpy(), want_d2)
        assert_bitwise(st.idx.numpy(), want_idx)
        assert_bitwise(dists.numpy(), np.sqrt(want_d2[:, -1]))
    tree = tree_merge_candidates(states)
    assert_bitwise(tree.idx.numpy(), want_idx)
    with pytest.raises(ValueError, match="reduction"):
        tring.device_merge_final(states, via="ring")


def test_resolve_merge_falls_back_and_raises_at_three_shards(caplog):
    with caplog.at_level(logging.WARNING):
        assert tring.resolve_merge("auto", 3) == "host"
    assert "not a power of two" in caplog.text
    assert tring.resolve_merge("auto", 4) == "device"
    assert tring.resolve_merge("host", 3) == "host"
    with pytest.raises(ValueError, match="power-of-two"):
        tring.resolve_merge("device", 3)
    with pytest.raises(ValueError, match="unknown merge mode"):
        tring.resolve_merge("nope", 4)
    with pytest.raises(ValueError, match="power-of-two"):
        tree_merge_candidates([None] * 3)
    for fn in (jring.resolve_merge, tring.resolve_merge):
        assert fn("auto", 3) == "host" and fn("auto", 8) == "device"
    # a chunked run at R=3 under auto is the host merge
    flat, ids = sharded(random_points(90, seed=2), 3)
    auto = tring.ring_knn_chunked(flat, ids, 4, 3, chunk_rows=16,
                                  bucket_size=16, merge="auto", device="cpu")
    fused = tring.ring_knn(flat, ids, 4, 3, bucket_size=16, device="cpu")
    assert torch.equal(auto, fused)
