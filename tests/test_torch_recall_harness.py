"""``tools/torch_recall_harness.py`` against the JAX package's
``tools/recall_harness.py`` on the CPU: the same workload query sets byte
for byte, the same candidate plans, and — the port's ``tiled`` engine
being bitwise the JAX twin — the same measured recall matrix and
calibrated policy, exactly; the CLI's policy file loads through the
port's ``RecallPolicy.from_file``."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_points=2048, k=8, n_queries=64, max_batch=64, seed=3)


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harnesses():
    return (_load("t_recall_harness", "tools/torch_recall_harness.py"),
            _load("j_recall_harness", "tools/recall_harness.py"))


@pytest.mark.parametrize("workload", ["uniform", "clustered", "sweep"])
def test_workload_queries_equal_jax(harnesses, workload):
    port, jax = harnesses
    got = port.workload_queries(workload, 300, seed=5, scale=2.0)
    want = jax.workload_queries(workload, 300, seed=5, scale=2.0)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("grid", [False, True])
def test_candidate_plans_equal_jax(harnesses, grid):
    port, jax = harnesses
    assert [p.to_json() for p in port.candidate_plans(grid)] == \
        [p.to_json() for p in jax.candidate_plans(grid)]


@pytest.fixture(scope="module")
def calibrated(harnesses):
    port, jax = harnesses
    return (port.calibrate(**SMALL, device="cpu"), jax.calibrate(**SMALL))


def test_calibrate_equals_jax(calibrated):
    got, want = calibrated
    assert got["kind"] == want["kind"] == "recall_harness"
    assert got["measured"] == want["measured"]
    assert got["plans"] == want["plans"]
    fixture = dict(got["fixture"])
    assert fixture.pop("device") == "cpu"
    assert fixture == want["fixture"]
    # the calibration measured real approximation: not every plan exact
    assert any(v < 1.0 for per in got["measured"].values()
               for v in per.values())


def test_cli_policy_loads_in_port(harnesses, tmp_path, capsys):
    from mpi_cuda_largescaleknn_torch.serve.recall import RecallPolicy

    port, _ = harnesses
    out = tmp_path / "policy.json"
    rc = port.main(["--points", "1024", "--k", "4", "--queries", "32",
                    "--max-batch", "32", "--workloads", "uniform,sweep",
                    "--device", "cpu", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert report["fixture"]["workloads"] == ["uniform", "sweep"]
    policy = RecallPolicy.from_file(str(out))
    assert [p.name for p in policy.plans] == [
        p["name"] for p in report["plans"]]
    for per in report["measured"].values():
        assert all(0.0 <= v <= 1.0 for v in per.values())
