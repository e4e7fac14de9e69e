"""Finding model + report serialization shared by every analysis pass.

A ``Finding`` is one rule violation at one source location. Passes emit
findings UNfiltered; the runner applies the waiver table afterwards so a
waived finding still appears in the machine-readable report (audit trail)
— it just stops gating the exit code.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

#: rule id -> one-line description; the registry the waiver grammar
#: validates against (an ``allow[...]`` naming an unknown rule is itself
#: a finding — typos must not silently waive nothing).
RULES = {
    "lock-guard": "guarded attribute accessed without holding its "
                  "declared lock",
    "lock-holds": "method declared `# lsk: holds[lock]` called without "
                  "the lock held",
    "lock-order": "lock acquisition-order cycle (potential deadlock "
                  "between threads)",
    "wallclock": "wall-clock time in a deterministic/serving path (use "
                 "time.monotonic/perf_counter or an injectable clock)",
    "rng-unseeded": "unseeded / globally-shared RNG in a deterministic "
                    "path (seed an instance: random.Random(seed) / "
                    "np.random.default_rng(seed) / "
                    "torch.Generator().manual_seed(seed))",
    "float-eq": "float == / != on a distance-like value (ties must go "
                "through the canonical (dist2, id) discipline)",
    "sort-unstable": "potentially unstable sort of distance-like data in "
                     "tie-sensitive code (use kind='stable' / "
                     "is_stable=True / stable=True / a (dist2, id) 2-key "
                     "sort)",
    "dict-order-fold": "fold iterates dict keys/values — arrival-order "
                       "iteration can change fold results; iterate a "
                       "canonically sorted view",
    "except-swallow": "exception silently swallowed (log it and count it "
                      "— extend the *_errors counter pattern)",
    "waiver": "malformed waiver comment (unknown rule or missing reason)",
    "aot-contract": "launch-plan signature drifted from the committed "
                    "analysis/launch_contract.json golden",
}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    waiver_reason: str | None = None

    def to_dict(self) -> dict:
        out = {"rule": self.rule, "path": self.path, "line": self.line,
               "message": self.message, "waived": self.waived}
        if self.waiver_reason:
            out["waiver_reason"] = self.waiver_reason
        return out

    def render(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} {self.message}"


@dataclass
class Report:
    """All findings of one run + enough metadata to gate CI on."""

    findings: list[Finding] = field(default_factory=list)
    files_checked: int = 0
    lock_order_edges: list[str] = field(default_factory=list)
    aot_programs: int = 0

    @property
    def unwaived(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def ok(self) -> bool:
        return not self.unwaived

    def summary(self) -> dict:
        per_rule: dict[str, int] = {}
        for f in self.unwaived:
            per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
        return {
            "ok": self.ok,
            "files_checked": self.files_checked,
            "findings": len(self.unwaived),
            "waived": sum(1 for f in self.findings if f.waived),
            "per_rule": dict(sorted(per_rule.items())),
            "aot_programs": self.aot_programs,
        }

    def to_dict(self) -> dict:
        return {
            "summary": self.summary(),
            "findings": [f.to_dict() for f in
                         sorted(self.findings,
                                key=lambda f: (f.path, f.line, f.rule))],
            "lock_order_edges": sorted(self.lock_order_edges),
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=False)
            fh.write("\n")
