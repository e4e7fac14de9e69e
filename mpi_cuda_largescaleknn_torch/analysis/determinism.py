"""Determinism / parity rules over one module's AST.

Everything here defends the stack's bitwise-parity contract (PAPER.md:
exact kNN, one answer whatever the merge mode, host count or engine):
results must be a pure function of (index bytes, query bytes, config),
never of wall-clock, RNG state, arrival order, or sort stability luck.
The rules are the JAX package's (``analysis/determinism.py``), with the
same ids; each also knows PyTorch's spelling of the hazard.

Rules (ids in findings.RULES):

- ``wallclock``       : ``time.time`` / ``time.time_ns`` /
                        ``datetime.now|utcnow|today`` calls. Elapsed-time
                        measurement belongs to ``perf_counter`` /
                        ``monotonic``; schedule state belongs to an
                        injectable clock (serve/health.py pattern) so
                        tests drive it without sleeps.
- ``rng-unseeded``    : module-level ``random.*`` calls (shared global
                        state), no-arg ``random.Random()`` /
                        ``np.random.default_rng()``, the legacy
                        ``np.random.*`` global generator, a
                        ``torch.Generator()`` this module never
                        ``manual_seed``s, and ``torch.rand`` /
                        ``randn`` / ``randint`` / ``randperm`` without
                        ``generator=`` (torch's global generator).
- ``float-eq``        : ``==`` / ``!=`` where an operand is
                        distance-like (name matches ``d2|dist|kth|
                        radius``) or a float literal. Exact bitwise tie
                        detection is sometimes the CONTRACT (the
                        canonical-ties fix) — those sites carry
                        ``# lsk: allow[float-eq]`` waivers, which is the
                        point: every float equality is auditable.
- ``sort-unstable``   : ``np.sort``/``np.argsort`` over distance-like
                        operands without ``kind='stable'``, and
                        ``lax.sort`` over distance-like operands without
                        ``is_stable=True`` unless it is a multi-key
                        ``(dist2, id)`` sort (``num_keys >= 2`` — a total
                        order needs no stability). ``torch.sort`` /
                        ``torch.argsort`` / ``Tensor.sort`` /
                        ``Tensor.argsort`` over distance-like operands
                        without ``stable=True`` (the indices ride along
                        even in a values sort), and ``torch.topk`` /
                        ``Tensor.topk`` over them always: its tie order is
                        undocumented.
- ``dict-order-fold`` : ``for`` over ``.keys()``/``.values()`` inside a
                        fold/merge-named function — host folds must not
                        depend on dict insertion (= arrival) order.
- ``except-swallow``  : handler bodies that are only ``pass`` /
                        ``continue`` for broad exception classes. Errors
                        feed the ``*_errors`` counter pattern instead.
"""

from __future__ import annotations

import ast
import re

from mpi_cuda_largescaleknn_torch.analysis.findings import Finding

_DIST_RE = re.compile(r"(^|_)(d2|dsq|dist\w*|kth\w*|radius\w*)($|_)",
                      re.IGNORECASE)
_FOLD_FN_RE = re.compile(r"(fold|merge|reduce|assemble|combine)",
                         re.IGNORECASE)

#: random-module functions that consume the SHARED global stream
_RANDOM_GLOBAL_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "sample", "shuffle", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "paretovariate",
    "weibullvariate", "lognormvariate", "getrandbits", "seed",
}

#: legacy numpy global-RNG entry points (np.random.<fn>)
_NP_RANDOM_GLOBAL_FNS = {
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "normal", "uniform", "seed", "standard_normal",
    "exponential", "poisson", "beta", "gamma",
}

#: torch samplers that draw from the GLOBAL generator unless given one
_TORCH_RANDOM_FNS = {"rand", "randn", "randint", "randperm"}

#: module names whose ``.sort``/``.argsort`` is a function, not a method
#: of a tensor or an array
_SORT_MODULES = {"np", "numpy", "jnp", "lax", "torch", "jax.numpy",
                 "jax.lax"}


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('' when not a name)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _leaf_name(node: ast.AST) -> str:
    """Last identifier of a Name/Attribute ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_distance_like(node: ast.AST) -> bool:
    name = _leaf_name(node)
    return bool(name and _DIST_RE.search(name))


def _kw(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: ast.expr | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _seeded_generators(tree: ast.AST) -> tuple[set[str], set[int]]:
    """(names, call ids) of the module's seeded ``torch.Generator``s:
    every dotted receiver of a ``.manual_seed(...)`` call, and every
    generator constructor chained straight into one
    (``torch.Generator().manual_seed(seed)``)."""
    names: set[str] = set()
    chained: set[int] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed"):
            recv = node.func.value
            if isinstance(recv, ast.Call):
                chained.add(id(recv))
            elif _dotted(recv):
                names.add(_dotted(recv))
    return names, chained


def _generator_targets(tree: ast.AST) -> dict[int, list[str]]:
    """Call id -> the dotted names an assigned call is bound to (``g =
    torch.Generator(...)``, ``self.g: T = ...``)."""
    out: dict[int, list[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, ast.Call):
            out[id(value)] = [_dotted(t) for t in targets if _dotted(t)]
    return out


class _DeterminismVisitor(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.AST):
        self.path = path
        self.findings: list[Finding] = []
        self._fn_stack: list[str] = []
        self._seeded, self._seeded_calls = _seeded_generators(tree)
        self._gen_targets = _generator_targets(tree)

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, self.path, node.lineno, msg))

    # --------------------------------------------------------------- scopes

    def visit_FunctionDef(self, node):
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # ---------------------------------------------------------------- calls

    def visit_Call(self, node: ast.Call):
        dotted = _dotted(node.func)
        # wallclock ---------------------------------------------------------
        if dotted in ("time.time", "time.time_ns"):
            self._emit("wallclock", node,
                       f"{dotted}() in a deterministic/serving path — use "
                       "time.perf_counter/monotonic for intervals or an "
                       "injectable clock (serve/health.py) for schedules")
        elif dotted.endswith((".now", ".utcnow", ".today")) and \
                ("datetime" in dotted or "date" in dotted.split(".")[0]):
            self._emit("wallclock", node,
                       f"{dotted}() wall-clock read — results must not "
                       "depend on the calendar")
        # rng ---------------------------------------------------------------
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "random"
                and node.func.attr in _RANDOM_GLOBAL_FNS):
            self._emit("rng-unseeded", node,
                       f"random.{node.func.attr}() uses the shared global "
                       "stream — construct random.Random(seed) per owner")
        if dotted == "random.Random" and not node.args and not node.keywords:
            self._emit("rng-unseeded", node,
                       "random.Random() without a seed is "
                       "os-entropy-seeded — pass an explicit seed")
        if dotted.endswith("random.default_rng") and not node.args \
                and not node.keywords:
            self._emit("rng-unseeded", node,
                       "np.random.default_rng() without a seed is "
                       "os-entropy-seeded — pass an explicit seed")
        if (isinstance(node.func, ast.Attribute)
                and _dotted(node.func.value) in ("np.random", "numpy.random")
                and node.func.attr in _NP_RANDOM_GLOBAL_FNS):
            self._emit("rng-unseeded", node,
                       f"np.random.{node.func.attr}() drives the legacy "
                       "GLOBAL numpy generator — use "
                       "np.random.default_rng(seed)")
        if dotted.endswith("torch.Generator") and not (
                id(node) in self._seeded_calls
                or any(t in self._seeded
                       for t in self._gen_targets.get(id(node), ()))):
            self._emit("rng-unseeded", node,
                       "torch.Generator() is never manual_seed()ed — seed "
                       "it explicitly: torch.Generator().manual_seed(seed)")
        if (dotted.startswith("torch.") and dotted.count(".") == 1
                and node.func.attr in _TORCH_RANDOM_FNS
                and _kw(node, "generator") is None):
            self._emit("rng-unseeded", node,
                       f"{dotted}() without generator= draws from torch's "
                       "GLOBAL generator — pass generator="
                       "torch.Generator().manual_seed(seed)")
        # sorts -------------------------------------------------------------
        self._check_sort(node, dotted)
        self.generic_visit(node)

    def _check_sort(self, node: ast.Call, dotted: str) -> None:
        self._check_torch_sort(node, dotted)
        leaf = dotted.rsplit(".", 1)[-1] if dotted else ""
        dist_args = any(_is_distance_like(a) for a in node.args) or any(
            kw.arg is None and _is_distance_like(kw.value)
            for kw in node.keywords)
        # tuple operands: lax.sort takes ((d2, idx), ...)
        for a in node.args:
            if isinstance(a, (ast.Tuple, ast.List)):
                dist_args = dist_args or any(_is_distance_like(e)
                                             for e in a.elts)
        if not dist_args:
            return
        if dotted.endswith(("np.argsort", "numpy.argsort")):
            # plain np.sort of VALUES is order-deterministic whatever the
            # algorithm; only argsort (ids ride along) is tie-sensitive
            kind = _kw(node, "kind")
            if not (isinstance(kind, ast.Constant)
                    and kind.value == "stable"):
                self._emit("sort-unstable", node,
                           f"{leaf}() over distance-like data without "
                           "kind='stable' — equal distances may reorder "
                           "their ids between numpy versions/backends")
        elif dotted.endswith("lax.sort"):
            nk = _kw(node, "num_keys")
            multi_key = (isinstance(nk, ast.Constant)
                         and isinstance(nk.value, int) and nk.value >= 2)
            stable = _kw(node, "is_stable")
            is_stable = (isinstance(stable, ast.Constant)
                         and stable.value is True)
            if not (multi_key or is_stable):
                self._emit("sort-unstable", node,
                           "lax.sort over distance-like data is UNSTABLE "
                           "by default — pass is_stable=True or sort the "
                           "(dist2, id) pair with num_keys=2")

    def _check_torch_sort(self, node: ast.Call, dotted: str) -> None:
        """PyTorch's sorts: ``torch.sort``/``argsort``/``topk`` over
        distance-like arguments, and the same names as methods of a
        distance-like receiver (``d2.sort(dim=1)``)."""
        fn = node.func
        if not (isinstance(fn, ast.Attribute)
                and fn.attr in ("sort", "argsort", "topk")):
            return
        recv = _dotted(fn.value)
        if recv == "torch":
            operands = list(node.args[:1]) + [
                kw.value for kw in node.keywords if kw.arg == "input"]
            what = f"torch.{fn.attr}()"
        elif recv in _SORT_MODULES:
            return
        else:
            operands = [fn.value]
            what = f"Tensor.{fn.attr}()"
        if not any(_is_distance_like(o) for o in operands):
            return
        if fn.attr == "topk":
            self._emit("sort-unstable", node,
                       f"{what} over distance-like data — its tie order is "
                       "undocumented; take a stable sort "
                       "(torch.sort(..., stable=True)) and slice it")
            return
        kind = _kw(node, "kind")
        if not (_is_true(_kw(node, "stable"))
                or (isinstance(kind, ast.Constant)
                    and kind.value == "stable")):
            self._emit("sort-unstable", node,
                       f"{what} over distance-like data without "
                       "stable=True — equal distances may reorder their "
                       "ids between launches/devices")

    # ----------------------------------------------------------------- cmp

    def visit_Compare(self, node: ast.Compare):
        operands = [node.left] + list(node.comparators)
        eq_ops = [op for op in node.ops if isinstance(op, (ast.Eq, ast.NotEq))]
        if eq_ops:
            # comparisons against strings/None are config checks, not
            # numeric equality
            benign = any(isinstance(o, ast.Constant)
                         and (o.value is None or isinstance(o.value, str))
                         for o in operands)
            if not benign:
                if any(_is_distance_like(o) for o in operands):
                    self._emit("float-eq", node,
                               "float equality on a distance-like value — "
                               "bitwise tie checks must be deliberate "
                               "(waive with a reason) and everything else "
                               "should compare through the canonical "
                               "(dist2, id) order")
                elif any(isinstance(o, ast.Constant)
                         and isinstance(o.value, float)
                         for o in operands):
                    self._emit("float-eq", node,
                               "== / != against a float literal — exact "
                               "float equality is rarely what serving "
                               "code means")
        self.generic_visit(node)

    # ---------------------------------------------------------------- loops

    def visit_For(self, node: ast.For):
        in_fold = any(_FOLD_FN_RE.search(fn) for fn in self._fn_stack)
        if in_fold and isinstance(node.iter, ast.Call):
            fn = node.iter.func
            if isinstance(fn, ast.Attribute) and fn.attr in ("keys",
                                                             "values"):
                self._emit("dict-order-fold", node,
                           f"fold iterates .{fn.attr}() — dict order is "
                           "insertion (= arrival) order; fold over "
                           "sorted(...) or an index-ordered list so the "
                           "result cannot depend on who answered first")
        self.generic_visit(node)

    # --------------------------------------------------------------- except

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        if broad and _is_silent_body(node.body):
            what = ("bare except:" if node.type is None
                    else f"except {node.type.id}:")
            self._emit("except-swallow", node,
                       f"{what} swallows the error silently — record it "
                       "(last_error + *_errors counter pattern) "
                       "or narrow the exception type")
        self.generic_visit(node)


def _is_silent_body(body: list[ast.stmt]) -> bool:
    """True when the handler does nothing observable: only pass/continue
    (string-constant expressions count as comments)."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)):
            continue
        return False
    return True


def check_determinism(tree: ast.AST, path: str) -> list[Finding]:
    v = _DeterminismVisitor(path, tree)
    v.visit(tree)
    return v.findings
