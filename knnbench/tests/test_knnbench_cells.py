"""Whole runs of each driver on the CPU at tiny sizes, past the harness's
look for a card: sound, each comes out correct; with the timed path broken
underneath, each fault a cell can have makes ``correct`` false."""

import time

import numpy as np
import pytest
import torch
from conftest import ROOT, program_spans

from knnbench import drivers
from knnbench.run import execute

CPU = torch.device("cpu")


def run(root, cell, seconds=1.0, trace=False, seed=2**31 + 11):
    return execute(cell, seed, seconds, trace, CPU, time.perf_counter(),
                   root=root)


def _state_unchanged(monkeypatch):
    from mpi_cuda_largescaleknn_torch.parallel import ring

    orig = ring._make_ring_fns

    def broken(*a, **kw):
        fns = orig(*a, **kw)
        return fns._replace(round_fn=lambda s, r, heaps, rnd: (list(heaps),
                                                                None))
    monkeypatch.setattr(ring, "_make_ring_fns", broken)


def _half_left_out(monkeypatch):
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN

    orig = UnorderedKNN.run

    def half(self, points, return_neighbors=False):
        out = orig(self, points[:len(points) // 2])
        return np.concatenate([out, np.full(len(points) - len(out),
                                            out.mean(), np.float32)])
    monkeypatch.setattr(UnorderedKNN, "run", half)


def _answer_altered(monkeypatch):
    from mpi_cuda_largescaleknn_torch.parallel import ring

    orig = ring.final_rows

    def altered(*a, **kw):
        dists, cands = orig(*a, **kw)
        return dists * (1 + 1e-3), cands
    monkeypatch.setattr(ring, "final_rows", altered)


def test_selfjoin_cell_is_correct_and_reports_its_metrics(tiny_root):
    out = run(tiny_root, "tiny-sj")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"selfjoin_points_per_s", "setup_s",
                                   "peak_device_mib"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["kth_rel_err_max"]["value"] < 1e-6
    parts = out["setup_parts"]
    assert list(parts) == ["imports", "port_and_device", "warmup_points",
                           "warmup_job"]
    assert sum(parts.values()) == pytest.approx(out["metrics"]["setup_s"]
                                                ["value"])
    traced = run(tiny_root, "tiny-sj", trace=True)
    assert traced["correct"]
    assert set(traced["metrics"]) == program_spans(tiny_root, "tiny-sj")


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_selfjoin_cell_catches_fault(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    assert not run(tiny_root, "tiny-sj")["correct"]


def _serve_fault(kind):
    def apply(monkeypatch):
        from mpi_cuda_largescaleknn_torch.serve.engine import (
            ResidentKnnEngine,
        )

        orig = ResidentKnnEngine.complete

        def broken(self, batch):
            d, n = orig(self, batch)
            d = np.array(d, np.float32)
            if kind == "state_unchanged":
                d[:] = np.inf
            elif kind == "half_left_out":
                d[len(d) // 2:] = d[:max(1, len(d) // 2)].mean()
            else:
                d *= 1 + 1e-3
            return d, n
        monkeypatch.setattr(ResidentKnnEngine, "complete", broken)
    apply.__name__ = kind
    return apply


def test_serve_cell_is_correct_and_reports_its_metrics(tiny_root):
    out = run(tiny_root, "tiny-serve", seconds=2.0)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 40
    assert set(out["metrics"]) == {"served_rows_per_s", "setup_s",
                                   "peak_device_mib"}
    assert out["latency_ms"]["p99"] >= out["latency_ms"]["p50"] > 0
    traced = run(tiny_root, "tiny-serve", seconds=2.0, trace=True)
    assert traced["correct"]
    assert "serve.batch_rows_mean" in traced["metrics"]


@pytest.mark.parametrize("fault", [_serve_fault("state_unchanged"),
                                   _serve_fault("half_left_out"),
                                   _serve_fault("answer_altered")],
                         ids=lambda f: f.__name__)
def test_serve_cell_catches_fault(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    assert not run(tiny_root, "tiny-serve", seconds=2.0)["correct"]


BROKEN_RANK = '''
import sys
from mpi_cuda_largescaleknn_torch.parallel import mesh
mesh.ShardRing.rotate = lambda self, forward=True, backward=True: None
from knnbench.rank import main
sys.exit(main())
'''


def test_ring_cell_is_correct(tiny_root):
    out = run(tiny_root, "tiny-ring")
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and out["attempted"] >= 1
    assert list(out["setup_parts"]) == ["imports", "connect",
                                        "warmup_points", "warmup_job"]


def test_ring_cell_catches_the_exchange_left_out(tiny_root, tmp_path,
                                                 monkeypatch):
    from mpi_cuda_largescaleknn_torch.parallel import mesh

    (tmp_path / "broken_rank.py").write_text(BROKEN_RANK)
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
    monkeypatch.setattr(drivers, "RANK_MODULE", "broken_rank")
    monkeypatch.setattr(mesh.ShardRing, "rotate",
                        lambda self, forward=True, backward=True: None)
    assert not run(tiny_root, "tiny-ring")["correct"]
