"""The D=3 wide fold's policy, on the CPU: ``chip_smoke.py``'s
``wide_walk_model`` replays one block of ``knn_tiled_d3_wide_kernel`` step
for step (pending buffers of ``WIDE_BUFFER`` entries filled against each
row's k-th d2 as of its last merge, a merge where a group of 32 lanes would
overflow one, and at each bucket's start the prune on the block's radius
bounds, merging every row only where the box d2 falls between them). Its
rows and visits must be the plain traversal's, bit for bit, whatever the
buffers hold when a decision comes: that is the claim the kernel's lazy
flush rests on, and the card run uses the model to show that its edge
cases reach the flush."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
    D3_SLOTS_MAX_K,
    WIDE_BUFFER,
    knn_update_tiled_plain,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    coarsen_buckets,
    partition_points,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_wide", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _pts(kind, n, seed):
    return (CS.seeded_points("uniform", n, seed) if kind == "uniform"
            else CS.grid_points(n, seed))


def _check(state, q, p, group, skip_self, buckets):
    want, vis = knn_update_tiled_plain(state, q, p, skip_self=skip_self,
                                       self_group=group, with_stats=True)
    s = q.bucket_size
    lazy = 0
    for b in buckets:
        d2, ids, nvis, n_lazy, merges = CS.wide_walk_model(
            state, q, p, b, self_group=group, skip_self=skip_self)
        rows = slice(b * s, b * s + d2.shape[0])
        np.testing.assert_array_equal(d2, want.dist2[rows].numpy())
        np.testing.assert_array_equal(ids, want.idx[rows].numpy())
        assert merges >= 1
        if d2.shape[0] == s:  # one block a bucket: the visits are its own
            assert nvis == int(vis[b])
        lazy += n_lazy
    return lazy


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("k", [D3_SLOTS_MAX_K + 1, 1000])
def test_lazy_flush_keeps_the_plain_walk(kind, k):
    """Warm rows in buckets of 32 (one block a bucket): the walk prunes, so
    the decisions at bucket starts meet rows with pending entries; the
    model's rows and visits are the plain fold's, and some decision needed
    the lazy flush."""
    q = partition_points(torch.from_numpy(_pts(kind, 4096, 7)),
                         bucket_size=32)
    lazy = _check(warm_start_self(q, k), q, q, 1, True, (0, 5, 77))
    assert lazy >= 1


@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_coarsened_warm_walk(kind):
    """Warm rows against point buckets coarsened by 2 (T=64, two tiles of
    lanes), k=1000."""
    q = partition_points(torch.from_numpy(_pts(kind, 8192, 8)),
                         bucket_size=32)
    pc = coarsen_buckets(q, 2)
    _check(warm_start_self(pc, 1000), q, pc, 2, True, (0, 9))


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("extra", [0, 1])
def test_buffer_edges(kind, extra):
    """Cold rows against point buckets of exactly ``WIDE_BUFFER`` and
    ``WIDE_BUFFER`` + 1 points (``exact_buckets``): one tile brings a row
    exactly a full buffer, or one lane more than it holds."""
    per = WIDE_BUFFER + extra
    pts = torch.from_numpy(_pts(kind, 8 * per, 9 + extra))
    q = partition_points(pts, bucket_size=256)
    cold = init_candidates(q.num_buckets * q.bucket_size,
                           D3_SLOTS_MAX_K + 1)
    _check(cold, q, CS.exact_buckets(pts, per), 1, False, (0, 3))


def test_cold_chunk_without_pruning():
    """The device merge's shape, small: one query bucket of cold rows whose
    box spans the points (every box d2 0, nothing prunes), k=1000, with a
    finite ``-r`` so that slots of max_radius^2 stay until something
    strictly closer arrives."""
    from mpi_cuda_largescaleknn_torch.parallel.ring import chunk_bucket

    pts = torch.from_numpy(_pts("uniform", 6000, 10))
    qb = chunk_bucket(pts[:64])
    pc = partition_points(pts, bucket_size=256)
    cold = init_candidates(64, 1000, 0.4)
    _check(cold, qb, pc, 1, False, (0,))
