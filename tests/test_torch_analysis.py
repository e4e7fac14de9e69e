"""The port's analyzer (``mpi_cuda_largescaleknn_torch/analysis/``) against
the JAX package's: the same findings (rule, path, line, waived) over the
JAX package, over the port's tree before and after its annotations were
repaired, and over small snippets; the PyTorch spellings of the
determinism rules on their own snippets; the port's tree gating clean,
its lock-order graph acyclic and its serving classes annotated; and the
launch-plan contract against its golden and against the JAX package's
``docs/aot_contract.json``. Every comparison is exact equality."""

from __future__ import annotations

import ast
import copy
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from mpi_cuda_largescaleknn_torch.analysis import findings as t_findings
from mpi_cuda_largescaleknn_torch.analysis import locks as t_locks
from mpi_cuda_largescaleknn_torch.analysis import runner as t_runner
from mpi_cuda_largescaleknn_torch.analysis import waivers as t_waivers
from mpi_cuda_largescaleknn_tpu.analysis import findings as j_findings
from mpi_cuda_largescaleknn_tpu.analysis import locks as j_locks
from mpi_cuda_largescaleknn_tpu.analysis import runner as j_runner
from mpi_cuda_largescaleknn_tpu.analysis import waivers as j_waivers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "mpi_cuda_largescaleknn_torch"

#: rules whose message texts differ on purpose: the port's names its own
#: tool and golden, and drops a reference to the JAX package's history
_OWN_MESSAGES = {"except-swallow", "aot-contract"}


def _check(mods, src: str):
    """Full pipeline of one package's passes over one in-memory module."""
    runner, locks = mods
    findings, classes, waivers = runner.analyze_source(src, "snippet.py")
    locks.resolve_inheritance(classes)
    findings += locks.check_lock_discipline(classes,
                                            {"snippet.py": waivers})
    order, _edges = locks.lock_order_findings(classes)
    findings += order
    runner.apply_waivers(findings, {"snippet.py": waivers})
    return findings


def port_check(src):
    return _check((t_runner, t_locks), src)


def jax_check(src):
    return _check((j_runner, j_locks), src)


def keys(findings):
    return sorted((f.rule, f.path, f.line, f.waived) for f in findings)


def messages(findings):
    return sorted((f.rule, f.line, f.message) for f in findings
                  if f.rule not in _OWN_MESSAGES)


def unwaived(findings, rule=None):
    return [f for f in findings
            if not f.waived and (rule is None or f.rule == rule)]


# ------------------------------------------------------------ snippets

_LOCKED = """
import threading
from mpi_cuda_largescaleknn_torch.analysis import guarded_by

class Ctr:
    def __init__(self):
        self._lock = threading.Lock()
        self.n: guarded_by("_lock") = 0

    def inc(self):
        with self._lock:
            self.n += 1
"""

#: the JAX package's analyzer test sources, one case per rule behavior
SNIPPETS = {
    "wallclock": "import time\nt = time.time()\n",
    "wallclock_waived": "import time\n"
        "t = time.time()  # lsk: allow[wallclock] epoch for a report\n",
    "wallclock_datetime": "import datetime\na = datetime.datetime.now()\n"
        "b = datetime.date.today()\n",
    "wallclock_clean": "import time\nt = time.perf_counter()\n"
        "u = time.monotonic()\n",
    "rng_global": "import random\nx = random.random()\n",
    "rng_unseeded_ctors": "import random\nimport numpy as np\n"
        "a = random.Random()\nb = np.random.default_rng()\n"
        "c = np.random.rand(3)\n",
    "rng_seeded": "import random\nimport numpy as np\n"
        "a = random.Random(7)\nb = np.random.default_rng(0)\n"
        "c = np.random.default_rng((1, 2))\n",
    "float_eq_dist": "ok = d2 == kth\n",
    "float_eq_literal": "ok = x == 0.5\n",
    "float_eq_config": 'ok = score_dtype == "f32"\n'
        "none_ok = max_radius == None\n",
    "float_eq_waived":
        "tied = d2 == kth  # lsk: allow[float-eq] bitwise tie class\n",
    "argsort": "import numpy as np\no = np.argsort(d2)\n",
    "argsort_stable": "import numpy as np\n"
        "o = np.argsort(d2, kind='stable')\n",
    "np_value_sort": "import numpy as np\no = np.sort(d2, axis=1)\n",
    "lax_sort_one_key": "from jax import lax\n"
        "o = lax.sort((d2, idx), num_keys=1)\n",
    "lax_sort_two_key": "from jax import lax\n"
        "o = lax.sort((d2, idx), num_keys=2)\n"
        "p = lax.sort((d2, idx), num_keys=1, is_stable=True)\n",
    "dict_fold": "def fold_hosts(parts):\n    acc = 0.0\n"
        "    for p in parts.values():\n        acc += p\n    return acc\n",
    "dict_fold_sorted": "def fold_hosts(parts):\n    acc = 0.0\n"
        "    for _k, p in sorted(parts.items()):\n        acc += p\n"
        "    return acc\n",
    "except_swallow": "try:\n    x = 1\nexcept Exception:\n    pass\n",
    "bare_except": "try:\n    x = 1\nexcept:\n    pass\n",
    "except_counted": "try:\n    x = 1\nexcept Exception as e:\n"
        "    errors += 1\n    last = str(e)\n",
    "narrow_except": "try:\n    x = 1\nexcept ValueError:\n    pass\n",
    "waiver_no_reason": "x = 1  # lsk: allow[wallclock]\n",
    "waiver_unknown_rule": "x = 1  # lsk: allow[not-a-rule] because\n",
    "waiver_garbled": "x = 1  # lsk: allwo[wallclock] typo\n",
    "locked_clean": _LOCKED,
    "unguarded_read": _LOCKED + "\n    def peek(self):\n"
        "        return self.n\n",
    "unguarded_write": _LOCKED + "\n    def reset(self):\n"
        "        self.n = 0\n",
    "guard_waived": _LOCKED + "\n    def peek(self):\n        return "
        "self.n  # lsk: allow[lock-guard] racy gauge is fine here\n",
    "lambda_body": _LOCKED + "\n    def f(self, pool):\n"
        "        pool.submit(lambda: self.n)\n",
    "subclass": _LOCKED + "\nclass Sub(Ctr):\n    def bad(self):\n"
        "        return self.n\n\n    def good(self):\n"
        "        with self._lock:\n            return self.n\n",
    "holds_contract": _LOCKED + "\n    def _bump(self):  # lsk: holds[_lock]\n"
        "        self.n += 1\n\n    def good_call(self):\n"
        "        with self._lock:\n            self._bump()\n\n"
        "    def bad_call(self):\n        self._bump()\n",
    "inversion": """
import threading

class A:
    def __init__(self):
        self._la = threading.Lock()

    def with_both(self, b):
        with self._la:
            b.locked_op()

    def locked_op(self):
        with self._la:
            pass

class B:
    def __init__(self):
        self._lb = threading.Lock()

    def with_both(self, a):
        with self._lb:
            a.locked_op()

    def locked_op(self):
        with self._lb:
            pass
""",
    "self_deadlock": """
import threading

class M:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self):
        with self._lock:
            with self._lock:
                pass

    def helper(self):  # lsk: holds[_lock]
        with self._lock:
            pass
""",
    "rlock_and_semaphore": """
import threading
from mpi_cuda_largescaleknn_torch.analysis import guarded_by

class M:
    def __init__(self):
        self._lock = threading.RLock()
        self._slots = threading.Semaphore(2)
        self.n: guarded_by("_lock") = 0

    def outer(self):
        with self._lock:
            self.inner()
            self.n += 1

    def inner(self):
        with self._lock:
            self.n += 1

    def f(self):
        with self._slots:
            with self._slots:
                pass
""",
    "direct_nesting": """
import threading

class M:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                pass

    def ba(self):
        with self._b:
            with self._a:
                pass
""",
    # PyTorch spellings the JAX passes ignore must not change what they
    # do see: a numpy argsort beside a stable torch sort
    "mixed_spellings": "import numpy as np\nimport torch\n"
        "a = np.argsort(dist)\n"
        "b = torch.sort(d2, dim=1, stable=True)\n",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_match_jax(name):
    src = SNIPPETS[name]
    got, want = port_check(src), jax_check(src)
    assert keys(got) == keys(want)
    assert messages(got) == messages(want)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_waiver_tables_match_jax(name):
    src = SNIPPETS[name]
    got = t_waivers.parse_waivers(src, "f.py")
    want = j_waivers.parse_waivers(src, "f.py")
    assert got.allows == want.allows
    assert got.holds == want.holds
    assert keys(got.errors) == keys(want.errors)


def test_rule_registry_matches_jax():
    assert set(t_findings.RULES) == set(j_findings.RULES)


# ------------------------------------------------ the PyTorch spellings

#: (source, unwaived findings of the port's pass by rule)
TORCH_CASES = {
    "generator_unseeded": ("import torch\ng = torch.Generator()\n",
                           {"rng-unseeded": 1}),
    "generator_device_unseeded": (
        "import torch\ng = torch.Generator(device='cuda')\n",
        {"rng-unseeded": 1}),
    "generator_seeded_later": (
        "import torch\ng = torch.Generator(device='cpu')\n"
        "g.manual_seed(7)\n", {}),
    "generator_seeded_chained": (
        "import torch\ng = torch.Generator().manual_seed(7)\n", {}),
    "generator_attr_seeded": (
        "import torch\n\nclass S:\n    def __init__(self, seed):\n"
        "        self.gen = torch.Generator()\n"
        "        self.gen.manual_seed(seed)\n", {}),
    "global_samplers": (
        "import torch\na = torch.rand(4)\nb = torch.randn(2, 3)\n"
        "c = torch.randint(0, 5, (3,))\nd = torch.randperm(8)\n",
        {"rng-unseeded": 4}),
    "samplers_with_generator": (
        "import torch\ng = torch.Generator().manual_seed(1)\n"
        "a = torch.rand(4, generator=g)\n"
        "d = torch.randperm(8, generator=g)\n", {}),
    "torch_sort_unstable": (
        "import torch\nv, i = torch.sort(d2, dim=1)\n"
        "o = torch.argsort(dist)\n", {"sort-unstable": 2}),
    "torch_sort_stable": (
        "import torch\nv, i = torch.sort(d2, dim=1, stable=True)\n"
        "o = torch.argsort(dist, stable=True)\n", {}),
    "torch_sort_stable_false": (
        "import torch\nv, i = torch.sort(d2, stable=False)\n",
        {"sort-unstable": 1}),
    "tensor_sort_methods": (
        "v, i = d2.sort(dim=1)\no = kth_d2.argsort()\n",
        {"sort-unstable": 2}),
    "tensor_sort_methods_stable": (
        "v, i = d2.sort(dim=1, stable=True)\n"
        "o = dist.argsort(kind='stable')\n", {}),
    "topk": ("import torch\nv, i = torch.topk(d2, 4, largest=False)\n"
             "w, j = dist.topk(4, dim=1, largest=False, sorted=True)\n",
             {"sort-unstable": 2}),
    "topk_waived": (
        "import torch\n# lsk: allow[sort-unstable] ties cannot occur here\n"
        "v, i = torch.topk(d2, 4)\n", {}),
    "not_distance_like": (
        "import torch\nv, i = torch.sort(ids, dim=1)\n"
        "o = keys.argsort()\nt = scores.topk(3)\n"
        "plans.sort(key=len)\n", {}),
    "np_value_sort_still_clean": (
        "import numpy as np\no = np.sort(d2, axis=1)\n", {}),
}


@pytest.mark.parametrize("name", sorted(TORCH_CASES))
def test_torch_spellings(name):
    src, want = TORCH_CASES[name]
    got = {}
    for f in unwaived(port_check(src)):
        got[f.rule] = got.get(f.rule, 0) + 1
    assert got == want
    # the JAX passes know none of these spellings: whatever they report
    # here, the port's passes report too
    assert set(keys(unwaived(jax_check(src)))) <= set(
        keys(unwaived(port_check(src))))


# ------------------------------------------------- trees: JAX vs the port


#: the serving modules whose ``# lsk:`` directives the repair put back
_REPAIRED = ("engine.py", "frontend.py", "health.py", "slabpool.py")


def _pre_repair_tree(dst) -> str:
    """The port's package with the repaired modules' ``# lsk:`` directives
    turned back into the plain comments they were before the analyzer
    came to the port."""
    base = str(dst)
    shutil.copytree(os.path.join(REPO, PORT), os.path.join(base, PORT),
                    ignore=shutil.ignore_patterns("__pycache__"))
    holds = re.compile(r"# lsk: holds\[(\w+)\]")
    allow = re.compile(r"# lsk: allow\[[^\]]*\]")
    for fn in _REPAIRED:
        p = os.path.join(base, PORT, "serve", fn)
        src = open(p, encoding="utf-8").read()
        src = allow.sub("#", holds.sub(r"# holds \1", src))
        open(p, "w", encoding="utf-8").write(src)
    return base


@pytest.mark.parametrize("tree", ["jax_package", "port", "port_pre_repair"])
def test_tree_findings_match_jax(tree, tmp_path):
    if tree == "jax_package":
        roots, base = ("mpi_cuda_largescaleknn_tpu", "tools"), REPO
    elif tree == "port":
        roots, base = t_runner.DEFAULT_ROOTS, REPO
    else:
        roots, base = (PORT,), _pre_repair_tree(tmp_path)
    # the JAX runner takes no globs: both passes get the same file list
    paths = t_runner.discover_files(roots, base)
    if tree != "port":
        assert paths == j_runner.discover_files(roots, base)
    got = t_runner.run_files(paths, base)
    want = j_runner.run_files(paths, base)
    assert keys(got.findings) == keys(want.findings)
    assert messages(got.findings) == messages(want.findings)
    assert got.lock_order_edges == want.lock_order_edges
    assert got.files_checked == want.files_checked
    if tree == "port_pre_repair":
        # the findings the repair answered: the helpers run under their
        # lock, the bitwise tie fix and a teardown's swallowed error (49
        # lock-guard findings before the repair: ``_build_index`` read
        # ``engine_name`` twice where it now reads it once)
        assert got.summary()["per_rule"] == {
            "except-swallow": 1, "float-eq": 1, "lock-guard": 48}
    else:
        assert got.ok


# ------------------------------------------------------------ the gate


def test_missing_root_fails_loudly():
    with pytest.raises(FileNotFoundError, match="does not exist"):
        t_runner.discover_files(("no_such_package",))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        t_runner.discover_files(("tools/no_such_*.py",))


def test_default_roots_cover_the_port_and_its_tools():
    files = {os.path.relpath(p, REPO)
             for p in t_runner.discover_files(t_runner.DEFAULT_ROOTS)}
    for rel in ("tools/torch_lskcheck.py", "tools/torch_loadgen.py",
                "tools/torch_recall_harness.py",
                f"{PORT}/analysis/aot.py", f"{PORT}/serve/engine.py"):
        assert rel in files
    assert not any(p.startswith(("tests/", "mpi_cuda_largescaleknn_tpu/"))
                   or p == "chip_smoke.py" or p == "tools/loadgen.py"
                   for p in files)


def test_port_tree_is_clean_and_every_waiver_has_a_reason():
    report = t_runner.run_files(t_runner.discover_files())
    assert report.ok, "\n".join(f.render() for f in report.unwaived)
    waived = [f for f in report.findings if f.waived]
    assert waived
    for f in waived:
        assert f.waiver_reason and f.waiver_reason.strip()


def test_port_lock_order_graph_acyclic_and_not_empty():
    report = t_runner.run_files(t_runner.discover_files())
    assert not [f for f in report.findings if f.rule == "lock-order"]
    assert report.lock_order_edges


def test_serve_shared_state_is_annotated():
    """The counterpart of the JAX package's test of the same name: the
    port's serving modules keep declaring their shared state (an empty
    guard table would make the lock pass vacuous)."""
    want = {
        "serve/admission.py": {"AdmissionController"},
        "serve/batcher.py": {"DynamicBatcher"},
        "serve/engine.py": {"ResidentKnnEngine"},
        "serve/faults.py": {"FaultInjector"},
        "serve/frontend.py": {"PodFanout", "RoutedPodFanout",
                              "HostSliceServer"},
        "serve/health.py": {"HostHealth", "HealthMonitor"},
        "serve/qcache.py": {"QueryCache", "SeedPool"},
        "serve/recall.py": {"RecallPolicy"},
        "serve/replica.py": {"ReplicaSet", "ReplicaManager"},
        "serve/server.py": {"ServingMetrics"},
        "serve/slabpool.py": {"SlabPool", "StreamingKnnEngine"},
        "serve/tenancy.py": {"TenantRegistry", "TenantQuotas"},
        "serve/wire.py": {"WireNegotiator", "WireStats"},
    }
    for rel, expected in want.items():
        src = open(os.path.join(REPO, PORT, rel)).read()
        got = {c.name for c in t_locks.collect_classes(ast.parse(src), rel)
               if c.guarded}
        assert expected <= got, f"{rel}: classes lost guarded_by"
        # every one imports the marker from the analyzer's package
        assert ("from mpi_cuda_largescaleknn_torch.analysis.annotations "
                "import guarded_by") in src
    assert not os.path.exists(os.path.join(REPO, PORT, "utils",
                                           "annotations.py"))


def test_lskcheck_cli_ast_only():
    """``tools/torch_lskcheck.py --no-aot`` in its own process: exit 0,
    the summary line, and no JAX module loaded."""
    code = ("import runpy, sys; sys.argv = ['torch_lskcheck', '--no-aot', "
            "'-q']\n"
            "try:\n    runpy.run_path('tools/torch_lskcheck.py', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "print('jax' in sys.modules, rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "False 0"
    assert lines[-2].startswith("torch_lskcheck: ") and "OK" in lines[-2]


# ------------------------------------------------ the launch-plan contract


@pytest.fixture(scope="module")
def contract():
    from mpi_cuda_largescaleknn_torch.analysis.aot import trace_contract

    return trace_contract(device="cpu")


def _aot():
    from mpi_cuda_largescaleknn_torch.analysis import aot

    return aot


def test_contract_equals_golden(contract):
    aot = _aot()
    findings = aot.diff_contract(contract,
                                 os.path.join(REPO, aot.CONTRACT_RELPATH))
    assert not findings, "\n".join(f.message for f in findings)


def _mutate_config_gone(c):
    c["configs"].append(dict(c["configs"][0], key="tiled|host|f32|d7|x"))
    return "tiled|host|f32|d7|x", "no longer traced"


def _mutate_new_config(c):
    return c["configs"].pop()["key"], "not in the golden"


def _mutate_new_program(c):
    cfg = c["configs"][0]
    cfg["programs"].pop(sorted(cfg["programs"])[0])
    return cfg["key"], "is new"


def _mutate_program_gone(c):
    cfg = c["configs"][0]
    cfg["programs"]["q1024|B9"] = dict(cfg["programs"][
        sorted(cfg["programs"])[0]])
    return cfg["key"], "gone"


def _mutate_signature(c):
    cfg = c["configs"][-1]
    pk = sorted(cfg["programs"])[0]
    cfg["programs"][pk]["out"][0] = cfg["programs"][pk]["out"][0].replace(
        "float32", "bfloat16")
    return cfg["key"], "signature drifted"


def _mutate_geometry(c):
    c["configs"][0]["query_buckets"]["8"] = 99
    return c["configs"][0]["key"], "query_buckets drifted"


@pytest.mark.parametrize("mutate", [
    _mutate_config_gone, _mutate_new_program, _mutate_program_gone,
    _mutate_signature, _mutate_geometry, _mutate_new_config],
    ids=lambda f: f.__name__.removeprefix("_mutate_"))
def test_contract_drift_detected(contract, tmp_path, mutate):
    """A golden that differs from the traced table in one way gives that
    finding: the mutation is applied to the GOLDEN, so a config or program
    the golden lacks is one the trace adds."""
    aot = _aot()
    golden = copy.deepcopy(contract)
    key, text = mutate(golden)
    path = tmp_path / "golden.json"
    aot.write_contract(golden, str(path))
    findings = aot.diff_contract(contract, str(path))
    assert findings and all(f.rule == "aot-contract" for f in findings)
    assert any(key in f.message and text in f.message for f in findings)


def test_missing_golden_is_a_finding(contract, tmp_path):
    findings = _aot().diff_contract(contract, str(tmp_path / "absent.json"))
    assert len(findings) == 1 and "missing" in findings[0].message
    assert "torch_lskcheck.py --write-aot-golden" in findings[0].message


def test_contract_is_deterministic(contract):
    assert json.dumps(contract, sort_keys=True) == json.dumps(
        _aot().trace_contract(device="cpu"), sort_keys=True)


def _shape(sig: str) -> str:
    return sig[sig.index("["):]


def test_contract_geometry_equals_jax_golden(contract):
    """The port's serving geometry is the JAX package's: for the five
    configs JAX pins, the same buckets, tie mode and score mode, the same
    programs, and outputs of the same shapes and (but the per-shard tile
    counts, int64 in the port) the same dtypes."""
    jax_golden = json.load(open(os.path.join(REPO, "docs",
                                             "aot_contract.json")))
    assert contract["fixture"] == jax_golden["fixture"]
    ours = {c["key"]: c for c in contract["configs"]}
    assert len(jax_golden["configs"]) == 5
    for g in jax_golden["configs"]:
        c = ours[g["key"]]
        for fld in ("shape_buckets", "query_buckets", "canonical_ties",
                    "score_mode"):
            assert c[fld] == g[fld], (g["key"], fld)
        assert sorted(c["programs"]) == sorted(g["programs"])
        for pk, prog in g["programs"].items():
            got, want = c["programs"][pk]["out"], prog["out"]
            assert [_shape(s) for s in got] == [_shape(s) for s in want]
            assert got[:-1] == want[:-1]
            # the q and r operands close the list on both sides
            assert c["programs"][pk]["in"][-2:] == prog["in"][-2:]
    served = ours["pallas_tiled|device|f32|d3|emit=final"]
    assert served["canonical_ties"] and served["score_mode"] == "vpu"
    assert served["query_buckets"] == ours[
        "tiled|device|f32|d3|emit=final"]["query_buckets"]


# ------------------------------------------------------------- imports

_NEW_FILES = sorted(
    [os.path.join(PORT, "analysis", f) for f in
     ("__init__.py", "annotations.py", "aot.py", "determinism.py",
      "findings.py", "locks.py", "runner.py", "waivers.py")]
    + [os.path.join(PORT, "obs", "cost.py"), "tools/torch_lskcheck.py",
       "tools/torch_loadgen.py", "tools/torch_recall_harness.py"])


@pytest.mark.parametrize("rel", _NEW_FILES)
def test_new_module_imports_no_jax(rel):
    tree = ast.parse(open(os.path.join(REPO, rel)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib",
                                       "mpi_cuda_largescaleknn_tpu")]
