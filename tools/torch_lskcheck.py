#!/usr/bin/env python
"""torch_lskcheck — the static-analysis gate of the PyTorch port.

Runs three pass families over ``mpi_cuda_largescaleknn_torch/`` and the
port's tools (``tools/torch_*.py``, ``tools/probe_*.py``; the rule
catalog is in ``mpi_cuda_largescaleknn_torch/analysis/__init__.py``):

  lock discipline   guarded_by("_lock") attribute proofs + a lock-
                    acquisition-order graph (deadlock cycles)
  determinism       wall-clock / unseeded RNG / float == on distances /
                    unstable sorts / dict-order folds / swallowed errors,
                    in their numpy, JAX and PyTorch spellings
  launch contract   every fixture engine's shape buckets run once on the
                    CPU, diffed against analysis/launch_contract.json

Exit status is 0 iff there are ZERO unwaived findings and no contract
drift. Suppressions must be auditable: `# lsk: allow[rule] reason`.

Usage:
  python tools/torch_lskcheck.py                      # full gate
  python tools/torch_lskcheck.py --no-aot             # AST passes only
  python tools/torch_lskcheck.py --json ANALYSIS.json # machine-readable
  python tools/torch_lskcheck.py --write-aot-golden   # adopt plan drift
  python tools/torch_lskcheck.py --list-rules
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main(argv: list[str] | None = None) -> int:
    from mpi_cuda_largescaleknn_torch.analysis.aot import CONTRACT_RELPATH
    from mpi_cuda_largescaleknn_torch.analysis.findings import RULES
    from mpi_cuda_largescaleknn_torch.analysis.runner import (
        DEFAULT_ROOTS,
        run_repo,
    )

    ap = argparse.ArgumentParser(
        prog="torch_lskcheck", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="*", default=list(DEFAULT_ROOTS),
                    help="files/directories/globs to analyze "
                         "(repo-relative; default: "
                         f"{' '.join(DEFAULT_ROOTS)})")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report")
    ap.add_argument("--no-aot", action="store_true",
                    help="skip the launch-plan contract (AST passes only; "
                         "no torch import)")
    ap.add_argument("--write-aot-golden", action="store_true",
                    help=f"regenerate {CONTRACT_RELPATH} from the traced "
                         "plans instead of diffing")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only the summary line, no per-finding output")
    args = ap.parse_args(argv)

    if args.no_aot and args.write_aot_golden:
        ap.error("--write-aot-golden requires the contract trace; "
                 "drop --no-aot")

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:16s} {desc}")
        return 0

    # the contract pass builds its fixture engines on the CPU
    # (analysis/aot.py trace_contract(device="cpu"))
    report = run_repo(roots=tuple(args.roots), base=_REPO,
                      aot=not args.no_aot,
                      aot_update=args.write_aot_golden)
    if args.json:
        report.dump_json(args.json)

    if not args.quiet:
        for f in sorted(report.findings,
                        key=lambda f: (f.path, f.line, f.rule)):
            print(f.render())
    s = report.summary()
    waived = s["waived"]
    print(f"torch_lskcheck: {s['files_checked']} files, "
          f"{report.aot_programs} launch plans, "
          f"{s['findings']} finding(s), {waived} waived"
          + (f" — per-rule {s['per_rule']}" if s["per_rule"] else "")
          + (" — OK" if s["ok"] else " — FAIL"))
    if args.write_aot_golden:
        print(f"wrote {CONTRACT_RELPATH}")
    return 0 if s["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
