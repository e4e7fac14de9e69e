"""Shared fixtures of the benchmark's own tests (``python -m pytest
knnbench/tests`` from the checkout's root).

``tiny_root`` is a temporary checkout: a ``BENCHMARK.json`` and a
``knnbench/`` of data files (and pipeline files, once there are any) copied
from this one, plus small cells of each driver (``tiny-sj``, ``tiny-serve``,
``tiny-ring``) that a CPU runs in seconds; the harness's code is this
checkout's. No serving cell is in ``BENCHMARK.json``, so ``tiny-serve`` and
its metrics are written out here: the index of ``unordered3d_k100``, the
open loop's mix."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: name -> (the cell it copies, its configuration's and mix's overrides)
TINY = {
    "tiny-sj": ("selfjoin-3d-k100", {"points_per_rank": 3000,
                                     "points_total": 3000, "k": 8}, {}),
    "tiny-serve": ("serve", {"points_per_rank": 20000,
                             "points_total": 20000, "k": 8},
                   {"rate_per_s": 20, "workers": 8, "sample_requests": 6,
                    "rows": {"dist": "log_uniform", "max": 64}}),
    "tiny-ring": ("selfjoin-3d-k100-4rank", {"points_per_rank": 1500,
                                             "points_total": 6000,
                                             "k": 8}, {}),
}
#: the serving cell the tiny one copies, and the metrics it reports
SERVE = {"config": "unordered3d_k100", "traffic": "open_poisson_1to1024",
         "chips": 1, "why": "a resident index under open-loop queries",
         "check": {"kth_rel_err_max": 3e-4, "answers_bad": 0}}
SERVE_METRICS = {
    "end_to_end": [{"name": "served_rows_per_s", "unit": "rows/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [{"name": name, "unit": unit, "better": better,
                   "source": source, "layer": layer,
                   "moves": "served_rows_per_s"}
                  for name, unit, better, source, layer in (
                      ("serve.knn_tiled_d3_roofline", "%", "higher",
                       "device_trace", "D=3 kernels"),
                      ("serve.batch_rows_mean", "rows", "higher",
                       "program_counter", "batcher"),
                      ("device.idle_share.serve", "%", "lower",
                       "device_trace", "device"))],
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips where there is none)")


def make_root(dest: Path) -> Path:
    """A checkout at ``dest`` describing the real cells and the tiny
    ones; returns ``dest``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kb = dest / "knnbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "pipelines"):
        if (ROOT / "knnbench" / sub).is_dir():
            shutil.copytree(ROOT / "knnbench" / sub, kb / sub)
    for group, metrics in SERVE_METRICS.items():
        bench[group] += [dict(m, workloads=["tiny-serve"]) for m in metrics]
    for name, (like, config, traffic) in TINY.items():
        if like == "serve":
            cell = dict(SERVE)
            entry = {k: SERVE[k] for k in ("config", "traffic", "chips",
                                           "why")}
        else:
            cell = json.loads(
                (kb / "workloads" / f"{like}.json").read_text())
            entry = next(w for w in bench["workloads"] if w["name"] == like)
            for m in bench["end_to_end"] + bench["per_layer"]:
                if like in m.get("workloads", ()):
                    m["workloads"].append(name)
        cell["config_params"] = config
        cell["traffic_params"] = {**cell.get("traffic_params", {}),
                                  **traffic}
        (kb / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append(dict(entry, name=name))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def program_spans(root: Path, cell: str) -> set:
    """The per-layer metrics of ``cell`` in ``root``'s ``BENCHMARK.json``
    that a CPU run reads: those from the program's spans (a device trace
    has nothing to read there)."""
    from knnbench.spec import load_cell

    return {m["name"] for m in load_cell(cell, root).per_layer
            if m["source"] == "program_span"}


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "checkout")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
