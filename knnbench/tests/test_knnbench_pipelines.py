"""A cell driven by a pipeline file, ``pipelines/<name>.py``, that exists
only in the temporary checkout: its configuration, cell, pipeline file and
``BENCHMARK.json`` entries are all it takes. Pipelines that are missing,
carry a built-in driver's name or define too little are refused, and the
real cells never look for one."""

import hashlib
import json
import sys
import time

import pytest
import torch
from conftest import ROOT, program_spans

from knnbench import drivers, spec
from knnbench.run import execute
from knnbench.spec import driver_of, load_cell

CPU = torch.device("cpu")
#: the pipeline file of the tests: the job loop with ``tiny-sj``'s reads,
#: and the configuration keys in ``{extra}`` besides
PIPELINE = '''
from knnbench import drivers, spec

READS = (spec.READS["jobs"][0] | {extra}, spec.READS["jobs"][1])


def check(name, config, traffic):
    if int(config["k"]) > int(config["points_per_rank"]):
        raise ValueError(f"{{name}}: k is above the points")


def run(cell, seed, seconds, trace, device, t_start):
    return drivers.run_jobs(cell, seed, seconds, trace, device, t_start)
'''


def add_piped_cell(root, name="tiny_jobs",
                   source=PIPELINE.format(extra="set()"), **config):
    """The cell ``tiny-piped``: ``tiny-sj`` (with ``config`` over its
    configuration's keys) on the configuration ``tiny_piped``, which is
    ``unordered3d_k100`` naming the pipeline ``name``; and
    ``pipelines/<name>.py`` holding ``source`` unless that is None. Only
    new files, and entries in ``BENCHMARK.json``."""
    kb = root / "knnbench"
    if source is not None:
        (kb / "pipelines").mkdir(exist_ok=True)
        (kb / "pipelines" / f"{name}.py").write_text(source)
    base = json.loads((kb / "configs" / "unordered3d_k100.json").read_text())
    (kb / "configs" / "tiny_piped.json").write_text(json.dumps(
        dict(base, name="tiny_piped", pipeline=name)))
    cell = json.loads((kb / "workloads" / "tiny-sj.json").read_text())
    (kb / "workloads" / "tiny-piped.json").write_text(json.dumps(
        dict(cell, config="tiny_piped",
             config_params={**cell["config_params"], **config})))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_piped", "source": "s", "why": "w",
                             "file": "knnbench/configs/tiny_piped.json",
                             "reduced": []})
    bench["workloads"].append({"name": "tiny-piped", "config": "tiny_piped",
                               "traffic": cell["traffic"], "chips": 1,
                               "why": "tiny-sj through a pipeline file"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-sj" in m.get("workloads", ()):
            m["workloads"].append("tiny-piped")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def digest(tree) -> dict:
    """Each file under ``tree`` (bytecode caches aside) by its SHA-256."""
    return {str(p.relative_to(tree)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def run(root, cell, trace=False, seed=2**31 + 29):
    return execute(cell, seed, 1.0, trace, CPU, time.perf_counter(),
                   root=root)


def test_a_cell_runs_through_a_pipeline_file_alone(tiny_root, monkeypatch):
    before = digest(ROOT / "knnbench")
    add_piped_cell(tiny_root)
    assert not (ROOT / "knnbench" / "pipelines" / "tiny_jobs.py").exists()
    cell = load_cell("tiny-piped", tiny_root)
    assert driver_of(cell.config, cell.traffic) == "tiny_jobs"
    driven = []
    run_jobs = drivers.run_jobs

    def spy(cell, *args):
        # the cell, and the module that handed it to the job loop
        driven.append((cell.name, sys._getframe(1).f_globals["__name__"]))
        return run_jobs(cell, *args)
    monkeypatch.setattr(drivers, "run_jobs", spy)
    out = run(tiny_root, "tiny-piped")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {
        m["name"] for m in load_cell("tiny-sj", tiny_root).end_to_end}
    traced = run(tiny_root, "tiny-piped", trace=True)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == program_spans(tiny_root, "tiny-sj")
    assert driven == [("tiny-piped", "knnbench_pipeline_tiny_jobs")] * 2
    assert digest(ROOT / "knnbench") == before


@pytest.mark.parametrize("reads, refused", [("set()", True),
                                            ("{'bucket_size'}", False)])
def test_the_pipeline_files_reads_decide_which_keys_pass(tiny_root, reads,
                                                         refused):
    add_piped_cell(tiny_root, source=PIPELINE.format(extra=reads),
                   bucket_size=128)
    if refused:
        with pytest.raises(ValueError, match="bucket_size"):
            load_cell("tiny-piped", tiny_root)
    else:
        assert load_cell("tiny-piped", tiny_root).config["bucket_size"] == 128


@pytest.mark.parametrize("name, source, why", [
    ("absent", None, "no file"),
    ("jobs", PIPELINE.format(extra="set()"), "built-in"),
    ("ring", PIPELINE.format(extra="set()"), "built-in"),
    ("no_reads", "def run(*args):\n    pass\n", "READS"),
    ("no_run", "READS = (set(), set())\n", "run"),
])
def test_a_pipeline_without_a_sound_file_is_refused(tiny_root, name, source,
                                                     why):
    add_piped_cell(tiny_root, name, source)
    with pytest.raises(ValueError, match=why):
        load_cell("tiny-piped", tiny_root)


def test_a_missing_pipeline_is_refused_with_an_empty_directory(tiny_root):
    (tiny_root / "knnbench" / "pipelines").mkdir()
    add_piped_cell(tiny_root, "absent", None)
    assert load_cell("tiny-sj", tiny_root).config["k"] == 8
    with pytest.raises(ValueError, match="no file"):
        load_cell("tiny-piped", tiny_root)


@pytest.mark.parametrize("sizes, refused", [
    ({"ranks": 4, "points_total": 12000}, None),
    ({"points_per_rank": 4, "points_total": 4}, "k is above the points")])
def test_the_pipelines_own_check_holds_and_not_the_ring_rule(tiny_root, sizes,
                                                            refused):
    """The built-in drivers' rule that only the ring runs ranks does not
    bind a pipeline; its own ``check`` does."""
    add_piped_cell(tiny_root, **sizes)
    if refused:
        with pytest.raises(ValueError, match=refused):
            load_cell("tiny-piped", tiny_root)
    else:
        assert load_cell("tiny-piped", tiny_root).config["ranks"] == 4


@pytest.mark.parametrize("cell, driver", [
    ("selfjoin-3d-k100", "jobs"), ("selfjoin-sift1m-k10", "jobs"),
    ("selfjoin-3d-k100-4rank", "ring"), ("tiny-sj", "jobs")])
def test_the_benchmarks_cells_take_a_built_in_driver(tiny_root, monkeypatch,
                                                     cell, driver):
    """No cell of ``BENCHMARK.json`` looks for a pipeline file, in loading
    or in driving."""
    def no_lookup(*args):
        raise AssertionError("looked for a pipeline file")
    monkeypatch.setattr(spec, "pipeline", no_lookup)
    monkeypatch.setattr(drivers, "pipeline", no_lookup)
    c = load_cell(cell, tiny_root)
    assert driver_of(c.config, c.traffic) == driver

    class Stop(Exception):
        pass

    def stop(*args):
        raise Stop
    monkeypatch.setattr(drivers, {"jobs": "run_jobs", "ring": "run_ring"}
                        [driver], stop)
    with pytest.raises(Stop):
        drivers.drive(c, 1, 1.0, False, CPU, 0.0)
