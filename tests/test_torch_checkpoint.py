"""Checkpoint and resume in the port against the JAX package on the CPU:
``ring_knn_stepwise`` and ``demand_knn_stepwise`` (rows, ids and the
demand counts), a resume after ``max_rounds=1`` (and ``max_chunks=2`` for
the chunked ring, both merges) equal to the uninterrupted run, the
checkpoint cleared once a run completes, and a changed configuration or
input refused. Stated tolerance: d2 and ids bit-equal on tie-free data.
The JAX side runs its Pallas kernels in interpret mode. Also: every
entry point's ``device=None`` is the card, which raises without CUDA."""

import os

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.core.config import KnnConfig as TConfig
from mpi_cuda_largescaleknn_torch.models.prepartitioned import (
    PrePartitionedKNN as TPre,
)
from mpi_cuda_largescaleknn_torch.models.sharding import pad_and_flatten
from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN
from mpi_cuda_largescaleknn_torch.parallel import demand as tdemand
from mpi_cuda_largescaleknn_torch.parallel import ring as tring
from mpi_cuda_largescaleknn_torch.utils import checkpoint as ckpt
from mpi_cuda_largescaleknn_tpu.parallel import demand as jdemand
from mpi_cuda_largescaleknn_tpu.parallel import ring as jring
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from tests.oracle import kth_nn_dist, random_points
from tests.test_torch_chunked import TILES, assert_rows_match, sharded
from tests.test_torch_demand import separated
from tests.test_torch_ops import assert_bitwise


def state_file(cdir) -> str:
    return os.path.join(cdir, "ring_state.npz")


def padded(parts):
    """Pre-partitioned parts as the demand loops take them."""
    return pad_and_flatten(
        parts, list(np.cumsum([0] + [len(p) for p in parts])[:-1]), 3)


@pytest.mark.parametrize("engine", ["pallas_tiled", "pallas"])
def test_ring_stepwise_matches_jax_and_resumes(tmp_path, engine):
    flat, ids = sharded(random_points(360, seed=11), 4)
    kw = dict(engine=engine, bucket_size=16, return_candidates=True, **TILES)
    want_d, want_c = jring.ring_knn_stepwise(flat, ids, 6, get_mesh(4), **kw)
    got_d, got_c, stats = tring.ring_knn_stepwise(
        flat, ids, 6, 4, device="cpu", return_stats=True, **kw)
    assert_rows_match(got_d, got_c, want_d, want_c, ids)
    fused_d, fused_c, fused_s = tring.ring_knn(
        flat, ids, 6, 4, device="cpu", return_stats=True, **kw)
    assert torch.equal(got_d, fused_d) and stats == fused_s

    cdir = str(tmp_path / "ck")
    part_d, part_s = tring.ring_knn_stepwise(
        flat, ids, 6, 4, device="cpu", checkpoint_dir=cdir, max_rounds=1,
        return_stats=True, **{**kw, "return_candidates": False})
    assert os.path.exists(state_file(cdir))
    assert not torch.equal(part_d, fused_d)
    res_d, res_c, res_s = tring.ring_knn_stepwise(
        flat, ids, 6, 4, device="cpu", checkpoint_dir=cdir,
        return_stats=True, **kw)
    assert torch.equal(res_d, fused_d) and torch.equal(res_c.idx,
                                                       fused_c.idx)
    # the two runs' work adds up to the uninterrupted run's
    assert part_s["pair_evals"] + res_s["pair_evals"] == \
        fused_s["pair_evals"]
    assert not os.path.exists(state_file(cdir))


def test_checkpoint_refuses_another_config_or_input(tmp_path):
    flat, ids = sharded(random_points(200, seed=12), 4)
    cdir = str(tmp_path / "ck")
    tring.ring_knn_stepwise(flat, ids, 5, 4, bucket_size=16, device="cpu",
                            checkpoint_dir=cdir, max_rounds=1)
    with pytest.raises(ValueError, match="was written for config"):
        tring.ring_knn_stepwise(flat, ids, 6, 4, bucket_size=16,
                                device="cpu", checkpoint_dir=cdir)
    edited = flat.copy()
    edited[0, 0] += 0.5
    with pytest.raises(ValueError, match="was written for config"):
        tring.ring_knn_stepwise(edited, ids, 5, 4, bucket_size=16,
                                device="cpu", checkpoint_dir=cdir)
    assert ckpt.data_digest(flat, ids) != ckpt.data_digest(edited, ids)
    assert ckpt.data_digest(torch.from_numpy(flat), ids) == \
        ckpt.data_digest(flat, ids)
    # the saved round and its ring pair are what the run reached
    assert ckpt.peek_round(cdir, _stepwise_fp(flat, ids, 5)) == 1


def _stepwise_fp(flat, ids, k):
    return ckpt.fingerprint(
        n=int(flat.shape[0]), k=k, shards=4, engine="pallas_tiled",
        max_radius=float("inf"), bucket_size=16, point_group=2,
        query_tile=2048, point_tile=2048, ring="bidir",
        data=ckpt.data_digest(flat, ids))


@pytest.mark.parametrize("merge", ["host", "device"])
def test_ring_chunked_resumes_after_two_chunks(tmp_path, merge):
    flat, ids = sharded(random_points(300, seed=13), 4)
    kw = dict(chunk_rows=16, merge=merge, bucket_size=16, device="cpu",
              return_candidates=True)
    want_d, want_c = tring.ring_knn_chunked(flat, ids, 5, 4, **kw)
    cdir = str(tmp_path / "ck")
    part_d, _ = tring.ring_knn_chunked(flat, ids, 5, 4, checkpoint_dir=cdir,
                                       max_chunks=2, pipeline_depth=3, **kw)
    assert torch.isinf(part_d.view(4, -1)[:, 32:]).all()
    assert torch.isfinite(part_d.view(4, -1)[:, :32]).all()
    got_d, got_c = tring.ring_knn_chunked(flat, ids, 5, 4,
                                          checkpoint_dir=cdir, **kw)
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_c.idx, want_c.idx)
    assert not os.path.exists(state_file(cdir))


@pytest.mark.parametrize("engine", ["pallas_tiled", "pallas"])
def test_demand_stepwise_matches_jax_and_resumes(tmp_path, engine):
    parts = separated(4, 50, 0.85, 60)
    flat, ids, _counts, _npad = padded(parts)
    kw = dict(engine=engine, bucket_size=16, return_stats=True, **TILES)
    want_d, want_c, want_s = jdemand.demand_knn_stepwise(
        flat, ids, 8, get_mesh(4), **kw)
    got_d, got_c, got_s = tdemand.demand_knn_stepwise(flat, ids, 8, 4,
                                                      device="cpu", **kw)
    assert_rows_match(got_d, got_c, want_d, want_c, ids)
    assert got_s == {"rounds": int(np.max(want_s["rounds"])),
                     "kernels_run": np.asarray(
                         want_s["kernels_run"]).tolist(),
                     "rotations_run": np.asarray(
                         want_s["rotations_run"]).tolist()}
    assert got_s["rounds"] >= 2   # so max_rounds=1 cuts the run

    cdir = str(tmp_path / "ck")
    tdemand.demand_knn_stepwise(flat, ids, 8, 4, device="cpu",
                                checkpoint_dir=cdir, max_rounds=1, **kw)
    assert os.path.exists(state_file(cdir))
    res_d, res_c, res_s = tdemand.demand_knn_stepwise(
        flat, ids, 8, 4, device="cpu", checkpoint_dir=cdir, **kw)
    assert torch.equal(res_d, got_d) and torch.equal(res_c.idx, got_c.idx)
    assert res_s == got_s   # the counts carry over the runs
    assert not os.path.exists(state_file(cdir))


def test_demand_chunked_resumes_and_clears(tmp_path, monkeypatch):
    parts = separated(4, 40, 0.85, 61)
    flat, ids, _counts, _npad = padded(parts)
    kw = dict(chunk_rows=16, bucket_size=16, device="cpu",
              return_candidates=True, return_stats=True)
    want = tdemand.demand_knn_chunked(flat, ids, 6, 4, **kw)
    cdir = str(tmp_path / "ck")
    save = ckpt.save_ring_state

    def save_then_die(*args, **kwargs):
        save(*args, **kwargs)
        raise KeyboardInterrupt

    # a run killed right after its first chunk's snapshot
    monkeypatch.setattr(ckpt, "save_ring_state", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        tdemand.demand_knn_chunked(flat, ids, 6, 4, checkpoint_dir=cdir,
                                   **kw)
    monkeypatch.undo()
    assert os.path.exists(state_file(cdir))
    got = tdemand.demand_knn_chunked(flat, ids, 6, 4, checkpoint_dir=cdir,
                                     **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].idx, want[1].idx)
    assert got[2] == want[2] and len(got[2]["rounds"]) == 3
    assert not os.path.exists(state_file(cdir))


def test_models_route_to_the_chunked_and_stepwise_loops(tmp_path):
    pts = random_points(260, seed=15)
    oracle = kth_nn_dist(pts, pts, 5)
    outs = []
    for extra in ({}, {"query_chunk": 40}, {"query_chunk": 40,
                                            "merge": "device"},
                  {"checkpoint_dir": str(tmp_path / "u")}):
        model = UnorderedKNN(TConfig(k=5, num_shards=4, bucket_size=16,
                                     device="cpu", **extra))
        outs.append(model.run(pts))
    for out in outs:
        assert_bitwise(out, outs[0])
    np.testing.assert_allclose(outs[0], oracle, rtol=5e-7)
    parts = separated(4, 40, 0.85, 62)
    pre = []
    for extra in ({}, {"query_chunk": 16},
                  {"checkpoint_dir": str(tmp_path / "p")}):
        model = TPre(TConfig(k=5, bucket_size=16, num_shards=0,
                             device="cpu", **extra))
        pre.append(np.concatenate(model.run(parts)))
        assert ("rounds_per_chunk" in model.last_stats) == \
            ("query_chunk" in extra)
    for out in pre:
        assert_bitwise(out, pre[0])


def test_device_none_is_the_card_and_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("device=None runs on the card here")
    flat, ids = sharded(random_points(40, seed=1), 2)
    for fn, kw in ((tring.ring_knn, {}),
                   (tring.ring_knn_stepwise, {}),
                   (tring.ring_knn_chunked, {"chunk_rows": 8}),
                   (tdemand.demand_knn, {}),
                   (tdemand.demand_knn_stepwise, {}),
                   (tdemand.demand_knn_chunked, {"chunk_rows": 8})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(flat, ids, 3, 2, **kw)
