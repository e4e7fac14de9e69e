"""Two helpers of the card runs, on the CPU: the planner that splits a
traversal launch into grid-y pieces (``ops/knn_tiled.py``
``grid_y_pieces``: every block once, in order, at most the cap a launch)
and ``chip_smoke.py``'s card-side selfcheck twin (``kth_distance_card``,
run here with ``device="cpu"``), bitwise equal to the port's
``obs/selfcheck.py`` ``kth_distance_exact``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
    MAX_GRID_Y,
    grid_y_pieces,
)


@pytest.mark.parametrize("cap", [1, 3, MAX_GRID_Y])
@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 65_535, 65_536, 131_071,
                                    262_144])
def test_pieces_cover_every_block_once_in_order(blocks, cap):
    pieces = grid_y_pieces(blocks, cap)
    assert all(1 <= ny <= cap for _y0, ny in pieces)
    covered = [y for y0, ny in pieces for y in range(y0, y0 + ny)]
    assert covered == list(range(blocks))
    assert len(pieces) == -(-blocks // cap)


def test_the_fault_shape_takes_two_launches():
    """A D=3 bucket of 2,097,152 rows in blocks of 32 rows: 65,536 blocks,
    one past the grid's y limit."""
    assert grid_y_pieces(2_097_152 // 32) == [(0, 65_535), (65_535, 1)]
    assert grid_y_pieces(0) == []
    for cap in (0, MAX_GRID_Y + 1):
        with pytest.raises(ValueError):
            grid_y_pieces(10, cap)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_twin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _points(n, dim, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, dim)).astype(np.float32)
    pts[5] = pts[9]  # an exact duplicate: a zero distance
    pts[20:24] = pts[20]  # ties
    return pts


@pytest.mark.parametrize("dim,k,radius,block", [
    (3, 8, np.inf, 1 << 26), (3, 31, 0.3, 2048), (128, 10, np.inf, 4096),
    (128, 1, np.inf, 1 << 26), (3, 100, np.inf, 1024)])
def test_card_twin_is_bitwise_the_host_check(dim, k, radius, block):
    from mpi_cuda_largescaleknn_torch.obs.selfcheck import kth_distance_exact

    cs = _chip_smoke()
    pts = _points(400, dim, seed=dim + k)
    idx = np.random.default_rng(k).choice(len(pts), 60, replace=False)
    got = cs.kth_distance_card(pts, idx, k, radius, device="cpu",
                               block_elems=block)
    want = kth_distance_exact(pts, idx, k, radius)
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_card_selfcheck_accepts_and_fails_as_the_host_one(monkeypatch):
    from mpi_cuda_largescaleknn_torch.obs.selfcheck import (
        kth_distance_exact,
        verify_sample,
    )

    cs = _chip_smoke()
    pts = _points(300, 3, seed=2)
    dists = kth_distance_exact(pts, np.arange(len(pts)), 8)
    assert cs.verify_sample_card(pts, dists, 8, 50, device="cpu") == 50
    assert verify_sample(pts, dists, 8, 50) == 50
    bad = dists.copy()
    bad[np.random.default_rng(0).choice(300, 50, replace=False)[7]] *= 1.01

    def boom(msg):
        raise AssertionError(msg)

    monkeypatch.setattr(cs, "fail", boom)
    with pytest.raises(AssertionError, match="selfcheck FAILED"):
        cs.verify_sample_card(pts, bad, 8, 50, device="cpu")
    with pytest.raises(AssertionError, match="selfcheck FAILED"):
        verify_sample(pts, bad, 8, 50)
