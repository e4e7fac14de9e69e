"""BENCHMARK.json against the contract, and a cell, a configuration, a
mix and a metric added as new files alone."""

import json
import re

import pytest
from conftest import ROOT

from knnbench.spec import load_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["knnbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"knnbench/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200
        assert sorted(json.loads((ROOT / c["file"]).read_text())["reduced"]
                      ) == c["reduced"]
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert w["config"] in names
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(cells) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_metrics(cell):
    c = load_cell(cell)
    assert c.chips in (1, 4) and c.check
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]))
        assert metric_reader(m["name"])({"jobs": 0, "trace": None,
                                         "stages": {}, "batcher": {}}) is None


def test_new_cell_config_mix_and_metric_are_files_alone(tiny_root):
    kb = tiny_root / "knnbench"
    (kb / "configs" / "grid3d_k8.json").write_text(json.dumps({
        "points": {"kind": "uniform", "dim": 3}, "points_per_rank": 4096,
        "ranks": 1, "k": 8, "control_precision": "bf16"}))
    (kb / "traffic" / "open_fixed_16.json").write_text(json.dumps({
        "loop": "open", "arrivals": "fixed", "rate_per_s": 10,
        "rows": {"dist": "fixed", "rows": 16}, "sample_requests": 2}))
    (kb / "workloads" / "serve-grid-k8.json").write_text(json.dumps({
        "config": "grid3d_k8", "traffic": "open_fixed_16", "chips": 1,
        "why": "x", "check": {"kth_rel_err_max": 1e-4, "answers_bad": 0}}))
    (kb / "metrics" / "serve.rows_ok.py").write_text(
        "def read(record):\n    return float(record['rows_ok'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "grid3d_k8", "source": "s", "why": "w",
                             "file": "knnbench/configs/grid3d_k8.json",
                             "reduced": []})
    bench["workloads"].append({"name": "serve-grid-k8", "config":
                               "grid3d_k8", "traffic": "open_fixed_16",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "serve.rows_ok", "unit": "rows",
                               "better": "higher", "source":
                               "program_counter", "layer": "batcher",
                               "moves": "served_rows_per_s",
                               "workloads": ["serve-grid-k8"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("serve-grid-k8", tiny_root)
    assert cell.config["points_per_rank"] == 4096
    assert cell.traffic["rows"] == {"dist": "fixed", "rows": 16}
    assert [m["name"] for m in cell.per_layer] == ["serve.rows_ok"]
    assert metric_reader("serve.rows_ok", tiny_root)({"rows_ok": 3}) == 3.0


def test_cell_files_must_agree_with_benchmark_json(tiny_root):
    cell = tiny_root / "knnbench" / "workloads" / "tiny-sj.json"
    data = json.loads(cell.read_text())
    cell.write_text(json.dumps(dict(data, traffic="open_poisson_1to1024")))
    with pytest.raises(ValueError):
        load_cell("tiny-sj", tiny_root)
    with pytest.raises(KeyError):
        load_cell("no-such-cell", tiny_root)


@pytest.mark.parametrize("where, key", [
    ("configs/unordered3d_k100.json", "dtype"),
    ("configs/unordered3d_k100.json", "num_shards"),
    ("traffic/jobs_back_to_back.json", "clients"),
    ("workloads/tiny-sj.json", "seconds"),
])
def test_a_key_no_driver_reads_is_refused(tiny_root, where, key):
    path = tiny_root / "knnbench" / where
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    **{key: 1})))
    with pytest.raises(ValueError, match=key):
        load_cell("tiny-sj", tiny_root)


def test_keys_one_driver_reads_are_refused_by_another(tiny_root):
    path = tiny_root / "knnbench" / "workloads" / "tiny-ring.json"
    cell = json.loads(path.read_text())
    cell["config_params"]["query_chunk"] = 1024
    path.write_text(json.dumps(cell))
    with pytest.raises(ValueError, match="query_chunk"):
        load_cell("tiny-ring", tiny_root)
    points = tiny_root / "knnbench" / "configs" / "sift1m_k10.json"
    config = json.loads(points.read_text())
    config["points"]["clusters_per_job"] = 2
    points.write_text(json.dumps(config))
    with pytest.raises(ValueError, match="clusters_per_job"):
        load_cell("selfjoin-sift1m-k10", tiny_root)


def test_sizes_that_disagree_are_refused(tiny_root):
    path = tiny_root / "knnbench" / "workloads" / "tiny-sj.json"
    cell = json.loads(path.read_text())
    cell["config_params"]["points_total"] = 6000
    path.write_text(json.dumps(cell))
    with pytest.raises(ValueError, match="points_total"):
        load_cell("tiny-sj", tiny_root)


def test_the_configurations_options_reach_the_port(tiny_root, monkeypatch):
    """``engine``, ``score_dtype``, ``query_chunk`` and ``merge`` from the
    configuration are the ``KnnConfig`` the job driver builds."""
    import torch

    from knnbench import drivers
    from mpi_cuda_largescaleknn_torch.models import unordered

    path = tiny_root / "knnbench" / "workloads" / "tiny-sj.json"
    cell = json.loads(path.read_text())
    cell["config_params"].update(engine="bruteforce", score_dtype="bf16",
                                 query_chunk=1024, merge="device")
    path.write_text(json.dumps(cell))
    seen = []

    class Stop(Exception):
        pass

    def init(self, config):
        seen.append(config)
        raise Stop
    monkeypatch.setattr(unordered.UnorderedKNN, "__init__", init)
    with pytest.raises(Stop):
        drivers.drive(load_cell("tiny-sj", tiny_root), 1, 1.0, False,
                      torch.device("cpu"), 0.0)
    (config,) = seen
    assert (config.k, config.engine, config.score_dtype, config.query_chunk,
            config.merge) == (8, "bruteforce", "bf16", 1024, "device")


def test_a_rank_that_imported_jax_prints_no_result(monkeypatch, capsys):
    import sys
    import types

    from knnbench import drivers, rank, spec

    monkeypatch.setattr(drivers, "ring_rank", lambda *a: {"rank": 1})
    monkeypatch.setattr(spec, "load_cell", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["rank", json.dumps({
        "workload": "w", "root": ".", "seed": 1, "seconds": 1, "trace": 0,
        "rank": 1, "world": 2, "port": 1, "device_type": "cpu"})])
    assert rank.main() == 0
    assert json.loads(capsys.readouterr().out) == {"rank": 1}
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert rank.main() == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
