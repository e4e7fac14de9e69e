"""Pass orchestration: discover files, run AST passes, apply waivers.

The default scope is the package plus its tools (``tools/torch_*.py``,
``tools/probe_*.py``) — everything the parity and threading contracts
cover. Tests are out of scope (they may use any clock/RNG they like), and
so is ``chip_smoke.py`` (a bench driver, not a serving path).
"""

from __future__ import annotations

import ast
import glob
import os

from mpi_cuda_largescaleknn_torch.analysis.determinism import check_determinism
from mpi_cuda_largescaleknn_torch.analysis.findings import Finding, Report
from mpi_cuda_largescaleknn_torch.analysis.locks import (
    check_lock_discipline,
    collect_classes,
    lock_order_findings,
    resolve_inheritance,
)
from mpi_cuda_largescaleknn_torch.analysis.waivers import (
    WaiverTable,
    parse_waivers,
)

#: analyzed roots, relative to the repo root (a root may be a glob)
DEFAULT_ROOTS = ("mpi_cuda_largescaleknn_torch", "tools/torch_*.py",
                 "tools/probe_*.py")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def discover_files(roots=DEFAULT_ROOTS, base: str | None = None) -> list[str]:
    base = base or repo_root()
    out = []
    for root in roots:
        full = os.path.join(base, root)
        if glob.has_magic(root):
            matched = sorted(p for p in glob.glob(full) if p.endswith(".py"))
            if not matched:
                raise FileNotFoundError(
                    f"lskcheck: analyzed root does not exist: {full}")
            out += matched
            continue
        if os.path.isfile(full) and full.endswith(".py"):
            out.append(full)
            continue
        if not os.path.isdir(full):
            # a missing root must fail loudly — os.walk would yield
            # nothing and the blocking gate would pass vacuously green
            raise FileNotFoundError(
                f"lskcheck: analyzed root does not exist: {full}")
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def analyze_source(source: str, path: str) -> tuple[
        list[Finding], list, WaiverTable]:
    """One file's determinism findings + collected classes (for the
    cross-file lock passes) + its waiver table. ``path`` is the label
    used in findings (repo-relative for real files)."""
    waivers = parse_waivers(source, path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return ([Finding("waiver", path, e.lineno or 1,
                         f"file does not parse: {e.msg}")],
                [], waivers)
    findings = list(waivers.errors)
    findings += check_determinism(tree, path)
    classes = collect_classes(tree, path)
    return findings, classes, waivers


def apply_waivers(findings: list[Finding],
                  tables: dict[str, WaiverTable]) -> None:
    for f in findings:
        if f.waived:
            continue
        table = tables.get(f.path)
        if table is None:
            continue
        reason = table.waiver_for(f.rule, f.line)
        if reason is not None:
            f.waived = True
            f.waiver_reason = reason


def run_files(paths: list[str], base: str | None = None) -> Report:
    """AST passes over ``paths``; finding paths are repo-relative."""
    base = base or repo_root()
    report = Report()
    all_classes = []
    tables: dict[str, WaiverTable] = {}
    for path in paths:
        rel = os.path.relpath(path, base)
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        findings, classes, waivers = analyze_source(source, rel)
        report.findings += findings
        all_classes += classes
        tables[rel] = waivers
        report.files_checked += 1
    resolve_inheritance(all_classes)
    report.findings += check_lock_discipline(all_classes, tables)
    order_findings, edges = lock_order_findings(all_classes)
    report.findings += order_findings
    report.lock_order_edges = edges
    apply_waivers(report.findings, tables)
    return report


def run_repo(roots=DEFAULT_ROOTS, base: str | None = None,
             aot: bool = True, aot_update: bool = False) -> Report:
    """The full gate: AST passes over the default scope, then (unless
    ``aot=False``) the launch-plan contract, traced on the CPU, diffed
    against analysis/launch_contract.json. ``aot_update`` rewrites the
    golden instead of diffing."""
    base = base or repo_root()
    report = run_files(discover_files(roots, base), base)
    if aot:
        from mpi_cuda_largescaleknn_torch.analysis import aot as aot_mod

        golden = os.path.join(base, aot_mod.CONTRACT_RELPATH)
        contract = aot_mod.trace_contract(device="cpu")
        report.aot_programs = sum(
            len(cfg["programs"]) for cfg in contract["configs"])
        if aot_update:
            aot_mod.write_contract(contract, golden)
        else:
            report.findings += aot_mod.diff_contract(contract, golden)
    return report
