"""The ``# lsk:`` comment grammar: auditable waivers + method contracts.

Grammar (one directive per comment)::

    # lsk: allow[rule] reason text          waive `rule` findings here
    # lsk: allow[rule1,rule2] reason text   waive several rules at once
    # lsk: holds[_lock]                     def-line contract: callers
                                            must hold self._lock
    # lsk: holds[_lock,_cond]               several locks

Placement: trailing on the offending line, or alone on the line
immediately ABOVE it (the next physical line is then covered — the usual
home for waivers on statements that are already at the line-length
limit). A waiver must carry a non-empty reason; ``holds`` takes none (it
is a contract, not a suppression). A directive naming an unknown rule,
or an ``allow`` with no reason, is itself reported under the ``waiver``
rule — typos must not silently waive nothing.

Comments are read with ``tokenize`` so strings containing ``# lsk:`` can
never be mistaken for directives.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field

from mpi_cuda_largescaleknn_torch.analysis.findings import RULES, Finding

_DIRECTIVE_RE = re.compile(
    r"#\s*lsk:\s*(?P<kind>allow|holds)\[(?P<args>[^\]]*)\]\s*(?P<reason>.*)")


@dataclass
class WaiverTable:
    """Per-file directive index.

    ``allows``: line -> {rule: reason}; ``holds``: line -> [lock names]
    (the line of the ``def`` the contract is attached to).
    """

    allows: dict[int, dict[str, str]] = field(default_factory=dict)
    holds: dict[int, list[str]] = field(default_factory=dict)
    errors: list[Finding] = field(default_factory=list)
    #: rules waived per line that a pass actually matched — lets the
    #: runner flag unused waivers later if we ever want to (not a gate).
    used: set = field(default_factory=set)

    def waiver_for(self, rule: str, line: int) -> str | None:
        """Reason string if ``rule`` is waived at ``line``, else None."""
        reasons = self.allows.get(line)
        if reasons is not None and rule in reasons:
            self.used.add((line, rule))
            return reasons[rule]
        return None

    def holds_for(self, def_line: int) -> list[str]:
        return self.holds.get(def_line, [])


def _comment_tokens(source: str):
    """(line, column, comment_text) for every comment; tolerant of the
    odd tokenize error (a file that does not tokenize will fail the AST
    parse anyway and be reported there)."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def parse_waivers(source: str, path: str) -> WaiverTable:
    table = WaiverTable()
    lines = source.splitlines()
    for line, col, text in _comment_tokens(source):
        m = _DIRECTIVE_RE.search(text)
        if m is None:
            if re.search(r"#\s*lsk:", text):
                table.errors.append(Finding(
                    "waiver", path, line,
                    f"unparseable lsk directive {text.strip()!r} — expected "
                    "`# lsk: allow[rule] reason` or `# lsk: holds[lock]`"))
            continue
        kind = m.group("kind")
        args = [a.strip() for a in m.group("args").split(",") if a.strip()]
        reason = m.group("reason").strip()
        # a comment alone on its line covers the NEXT line; a trailing
        # comment covers its own line
        standalone = (line - 1 < len(lines)
                      and lines[line - 1][:col].strip() == "")
        target = line + 1 if standalone else line
        if kind == "holds":
            if not args:
                table.errors.append(Finding(
                    "waiver", path, line,
                    "holds[] names no lock attribute"))
                continue
            table.holds.setdefault(target, []).extend(args)
            continue
        if not args:
            table.errors.append(Finding(
                "waiver", path, line, "allow[] names no rule"))
            continue
        if not reason:
            table.errors.append(Finding(
                "waiver", path, line,
                f"allow[{','.join(args)}] has no reason — every waiver "
                "must say why it is sound"))
            continue
        bad = [a for a in args if a not in RULES]
        if bad:
            table.errors.append(Finding(
                "waiver", path, line,
                f"allow[] names unknown rule(s) {bad} (known: "
                f"{sorted(RULES)})"))
            continue
        dst = table.allows.setdefault(target, {})
        for rule in args:
            dst[rule] = reason
    return table
