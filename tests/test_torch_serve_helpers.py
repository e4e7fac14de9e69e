"""The serving core's helpers in the PyTorch port against the JAX package:
Morton codes and the admission sort, ``slab_aabbs``,
``resolve_query_buckets``, the latency histograms and their metric lines, the
timers' report; the traversal's prepared point side; and the serving
modules' imports (no JAX)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.models import sharding as t_sharding
from mpi_cuda_largescaleknn_torch.obs import timers as t_timers
from mpi_cuda_largescaleknn_torch.ops import knn_tiled as t_kt
from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
from mpi_cuda_largescaleknn_torch.parallel import ring as t_ring
from mpi_cuda_largescaleknn_torch.utils import math as t_math
from mpi_cuda_largescaleknn_tpu.core.types import PAD_SENTINEL
from mpi_cuda_largescaleknn_tpu.models import sharding as j_sharding
from mpi_cuda_largescaleknn_tpu.obs import timers as j_timers
from mpi_cuda_largescaleknn_tpu.parallel import ring as j_ring
from mpi_cuda_largescaleknn_tpu.utils import math as j_math


def _queries(n, seed):
    """Uniform points, a few outside the unit box, and pad rows."""
    rng = np.random.default_rng(seed)
    q = rng.random((n, 3), dtype=np.float32)
    q[: n // 8] = rng.uniform(-2.0, 3.0, (n // 8, 3)).astype(np.float32)
    q[-(n // 10):] = PAD_SENTINEL
    return q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_morton_codes_and_argsort_equal_jax(seed):
    q = _queries(500, seed)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    codes = t_math.morton_codes(q, lo, hi)
    np.testing.assert_array_equal(codes, j_math.morton_codes(q, lo, hi))
    np.testing.assert_array_equal(t_math.morton_argsort(q, lo, hi),
                                  j_math.morton_argsort(q, lo, hi))
    # pads sort last, and the codes round-trip through the grid
    assert (codes[-(500 // 10):] == t_math.MORTON_PAD_CODE).all()
    grid = np.random.default_rng(seed).integers(0, 1 << 21, (100, 3))
    inter = t_math.morton_interleave(grid)
    np.testing.assert_array_equal(inter, j_math.morton_interleave(grid))
    np.testing.assert_array_equal(t_math.morton_deinterleave(inter), grid)


def test_morton_degenerate_box_equals_jax():
    q = _queries(64, 5)
    lo = np.array([0.5, 0.0, 0.0], np.float32)
    hi = np.array([0.5, 1.0, 0.0], np.float32)   # flat in x and z
    np.testing.assert_array_equal(t_math.morton_codes(q, lo, hi),
                                  j_math.morton_codes(q, lo, hi))


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_slab_aabbs_equal_jax(shards):
    pts = np.random.default_rng(shards).random((37, 3), dtype=np.float32)
    for n in (37, 5, 0):
        bounds = t_sharding.slab_bounds(n, shards)
        assert t_sharding.slab_aabbs(pts[:n], bounds) == \
            j_sharding.slab_aabbs(pts[:n], bounds)


def test_resolve_query_buckets_equal_jax():
    for qpad in (8, 16, 32, 64, 128, 256, 1024, 4096):
        for k in (1, 4, 8, 9, 16, 33, 100, 1000):
            for qb in (0, 1, 2, 3, 5, 64, 10_000):
                assert t_ring.resolve_query_buckets(qb, qpad, k) == \
                    j_ring.resolve_query_buckets(qb, qpad, k), (qb, qpad, k)


def _record_all(hists, values):
    for h in hists:
        for v in values:
            h.record(v)


def test_latency_histogram_equals_jax():
    rng = np.random.default_rng(3)
    vals = [float(v) for v in np.concatenate([
        rng.lognormal(-6.0, 2.0, 2000), [0.0, 1e-7, 200.0, 1e-3]])]
    t, j = t_timers.LatencyHistogram(), j_timers.LatencyHistogram()
    _record_all((t, j), vals)
    assert t.counts == j.counts
    for p in (0, 1, 50, 95, 99, 99.9, 100):
        assert t.percentile(p) == j.percentile(p)
    assert t.report() == j.report()
    assert t.prometheus_lines("x_seconds") == j.prometheus_lines("x_seconds")
    empty = t_timers.LatencyHistogram().report()
    assert empty == j_timers.LatencyHistogram().report()
    assert empty["p50"] is None
    json.loads(json.dumps(empty))


def test_phase_timers_report_equals_jax(monkeypatch):
    """The same record sequence gives the same report (the clock pinned,
    so the phases' seconds are equal too)."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    clock = lambda: float(next(ticks))  # noqa: E731
    reports = []
    for mod in (t_timers, j_timers):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        tm = mod.PhaseTimers()
        with tm.phase("index_build"):
            pass
        with tm.phase("exchange"):
            pass
        with tm.phase("index_build"):
            pass
        tm.hist("engine_batch_seconds").record(0.004)
        tm.hist("engine_batch_seconds").record(0.02)
        tm.gauge("occupancy", 3)
        tm.count("fetch_bytes", 4096)
        tm.count("fetch_bytes")
        tm.count("tiles_executed", 7)
        assert tm.counter("fetch_bytes") == 4097
        reports.append((tm.report(), tm.dump()))
    assert reports[0] == reports[1]


def _bucketed(dim, seed, n=1000, bucket_size=200):
    pts = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, dim)).astype(np.float32))
    return partition_points(pts, bucket_size=bucket_size)


@pytest.mark.parametrize("dim,score_dtype,kind", [
    (3, "f32", "d3"), (16, "f32", "ring"), (240, "f32", "ring"),
    (3, "bf16", "d3"), (16, "bf16", "wgmma"), (240, "bf16", "wgmma")])
def test_prepared_point_side_is_the_per_launch_layout(dim, score_dtype,
                                                      kind):
    """``prepare_points`` gives the bits the launchers lay out at every
    launch, for the route the launch plans (D=3 lanes, the ring layout of
    either ring route, the packed halves in the plan's K-slices)."""
    p = _bucketed(dim, dim)
    prep = t_kt.prepare_points(p, score_dtype)
    assert prep.kind == kind == t_kt.prepared_kind(dim, score_dtype)
    num_pb, t_p = p.ids.shape
    torch.testing.assert_close(prep.ids, p.ids, rtol=0, atol=0)
    if kind == "d3":
        want = t_kt.d3_lanes(p.pts, p.ids, t_kt.round_up(t_p, 256))
        assert prep.lanes.view(torch.int32).equal(want.view(torch.int32))
    elif kind == "ring":
        plan = t_kt.tiled_launch_plan(16, t_p, 10, dim)
        want = t_kt.ring_layout(p.pts, t_kt.round_up(t_p, plan.lanes),
                                plan.lanes, plan.dp4, float("nan"))
        assert prep.lanes.view(torch.int32).equal(want.view(torch.int32))
    else:
        w = t_kt.survivor_width(10, p)
        plan = t_kt.mxu_launch_geometry(dim, w)
        t_pad = t_kt.round_up(t_p, 2 * t_kt.WGMMA_LANES)
        want = t_kt.pack_wgmma_halves(p.pts, t_pad, plan.dp,
                                      2 * t_kt.WGMMA_LANES, plan.slice_width)
        for got, ref in zip(prep.lanes, want):
            assert got.view(torch.int16).equal(ref.view(torch.int16))
        assert prep.norms.view(torch.int32).equal(
            t_kt.padded_norms2(p.pts, t_pad).view(torch.int32))
    assert prep.nbytes() > 0


def test_prepared_point_side_is_checked_and_plain_ignores_it():
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates

    p = _bucketed(16, 1)
    q = _bucketed(16, 2, n=256, bucket_size=64)
    prep = t_kt.prepare_points(p, "f32")
    num_pb, t_p = p.ids.shape
    shape = (num_pb, t_kt.round_up(t_p, 64) // 64, 4, 64, 4)
    with pytest.raises(ValueError, match="prepared point side"):
        t_kt._prepared_for(prep, "wgmma", p, shape)
    with pytest.raises(ValueError, match="prepared point side"):
        t_kt._prepared_for(prep, "ring", q, shape)
    with pytest.raises(ValueError, match="prepared point side"):
        t_kt._prepared_for(prep, "ring", p, (num_pb, 1, 4, 64, 4))
    assert t_kt._prepared_for(prep, "ring", p, shape) is prep
    made = t_kt._prepared_for(None, "ring", p, shape)
    assert made.lanes.view(torch.int32).equal(prep.lanes.view(torch.int32))
    state = init_candidates(q.ids.numel(), 5)
    a = t_kt.knn_update_tiled_cuda(state, q, p)
    b = t_kt.knn_update_tiled_cuda(state, q, p, prepared=prep)
    assert torch.equal(a.dist2, b.dist2) and torch.equal(a.idx, b.idx)


def test_serving_modules_import_no_jax():
    code = (
        "import sys\n"
        "import mpi_cuda_largescaleknn_torch.serve as s\n"
        "from mpi_cuda_largescaleknn_torch.serve import (admission, "
        "batcher, engine, faults, qcache, recall, server)\n"
        "from mpi_cuda_largescaleknn_torch.cli import serve_main\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'mpi_cuda_largescaleknn_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
