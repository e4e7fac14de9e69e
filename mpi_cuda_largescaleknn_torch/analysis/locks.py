"""Lock discipline + acquisition-order analysis.

Two checks over the package AST:

1. **guarded_by discipline** (rule ``lock-guard``): a class declares, via
   the PEP 526 annotation convention of analysis/annotations.py::

       self.batches: guarded_by("_cond") = 0

   and the checker proves every OTHER read/write of ``self.batches``
   inside the class happens under ``with self.<lock>``. ``__init__`` is
   exempt (the instance is not shared yet). Methods carrying
   ``# lsk: holds[_cond]`` are checked as if the lock were held, and
   their same-class call sites must hold it (rule ``lock-holds``).
   The proof is per-class and ``self``-rooted: cross-object accesses
   (``ep.health.state`` from another module) are outside its reach — the
   convention is that every such surface goes through a locked snapshot
   method of the owning class (see analysis/__init__.py).

2. **lock-order graph** (rule ``lock-order``): every ``with self.X``
   acquisition is a node ``Class.X``. An edge A -> B means some code
   path acquires B while holding A — directly (nested ``with``) or one
   call deep (a method invoked under A whose resolved body acquires B;
   resolution is by method NAME across all analyzed classes, the
   deliberately-conservative choice: a false edge can only ADD cycles,
   never hide one). A cycle in the graph is a potential deadlock between
   the batcher workers, ``HealthMonitor.check_once``, and HTTP handler
   threads — exactly the threads that share these locks.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from mpi_cuda_largescaleknn_torch.analysis.findings import Finding
from mpi_cuda_largescaleknn_torch.analysis.waivers import WaiverTable

_LOCK_FACTORIES = ("Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore")
#: nested re-acquisition of a plain Lock is a GUARANTEED self-deadlock;
#: RLock/Condition nest legally (Condition's default inner lock is an
#: RLock), and a counting Semaphore(n>=2) may be acquired twice — the
#: count is invisible statically, so semaphores are not flagged either
_SELF_DEADLOCK_FACTORIES = ("Lock",)


@dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    #: base-class simple names (for guarded/lock inheritance resolution)
    bases: list[str] = field(default_factory=list)
    #: attr name -> declared lock attr name (from guarded_by annotations)
    guarded: dict[str, str] = field(default_factory=dict)
    #: attr names assigned a threading.Lock/Condition/... in any method
    lock_attrs: set[str] = field(default_factory=set)
    #: lock attr name -> factory leaf name ("Lock", "RLock", ...)
    lock_kinds: dict[str, str] = field(default_factory=dict)
    #: method name -> FunctionDef
    methods: dict[str, ast.FunctionDef] = field(default_factory=dict)
    #: method name -> locks (attr names) the method acquires directly
    acquires: dict[str, set[str]] = field(default_factory=dict)
    #: method name -> [(held lock attr names, called method name)]
    calls_under: dict[str, list[tuple[frozenset, str]]] = (
        field(default_factory=dict))
    #: method name -> [(held lock attr names, acquired lock attr name)]
    acq_events: dict[str, list[tuple[frozenset, str]]] = (
        field(default_factory=dict))


def _guard_decl(node: ast.AnnAssign) -> tuple[str, str] | None:
    """(attr, lock) for ``self.attr: guarded_by("lock") = ...``."""
    t = node.target
    if not (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
            and t.value.id == "self"):
        return None
    ann = node.annotation
    if (isinstance(ann, ast.Call)
            and isinstance(ann.func, (ast.Name, ast.Attribute))
            and (_name := (ann.func.id if isinstance(ann.func, ast.Name)
                           else ann.func.attr)) == "guarded_by"
            and ann.args and isinstance(ann.args[0], ast.Constant)
            and isinstance(ann.args[0].value, str)):
        del _name
        return t.attr, ann.args[0].value
    return None


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_factory_assign(node: ast.Assign) -> tuple[str, str] | None:
    """(attr, factory) for ``self.X = threading.Lock()`` assignments."""
    if not (isinstance(node.value, ast.Call)):
        return None
    fn = node.value.func
    leaf = (fn.attr if isinstance(fn, ast.Attribute)
            else fn.id if isinstance(fn, ast.Name) else "")
    if leaf not in _LOCK_FACTORIES:
        return None
    for t in node.targets:
        attr = _self_attr(t)
        if attr:
            return attr, leaf
    return None


def collect_class(node: ast.ClassDef, path: str) -> ClassInfo:
    info = ClassInfo(node.name, path, node)
    for b in node.bases:
        if isinstance(b, ast.Name):
            info.bases.append(b.id)
        elif isinstance(b, ast.Attribute):
            info.bases.append(b.attr)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[item.name] = item
            for sub in ast.walk(item):
                if isinstance(sub, ast.AnnAssign):
                    decl = _guard_decl(sub)
                    if decl:
                        info.guarded[decl[0]] = decl[1]
                elif isinstance(sub, ast.Assign):
                    assign = _lock_factory_assign(sub)
                    if assign:
                        info.lock_attrs.add(assign[0])
                        info.lock_kinds[assign[0]] = assign[1]
    return info


def collect_classes(tree: ast.AST, path: str) -> list[ClassInfo]:
    return [collect_class(node, path) for node in ast.walk(tree)
            if isinstance(node, ast.ClassDef)]


def resolve_inheritance(classes: list[ClassInfo]) -> None:
    """Propagate guarded/lock declarations down name-resolved bases so a
    subclass (e.g. RoutedPodFanout(PodFanout)) is checked against the
    locks its parent constructed. Name-based and iterated to fixpoint;
    external bases (http.server classes etc.) contribute nothing."""
    by_name = {c.name: c for c in classes}
    changed = True
    while changed:
        changed = False
        for cls in classes:
            for base_name in cls.bases:
                base = by_name.get(base_name)
                if base is None:
                    continue
                for attr, lock in base.guarded.items():
                    if attr not in cls.guarded:
                        cls.guarded[attr] = lock
                        changed = True
                new_locks = base.lock_attrs - cls.lock_attrs
                if new_locks:
                    cls.lock_attrs |= new_locks
                    changed = True
                for attr, kind in base.lock_kinds.items():
                    if attr not in cls.lock_kinds:
                        cls.lock_kinds[attr] = kind
                        changed = True


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking the set of self-locks held."""

    def __init__(self, cls: ClassInfo, method: ast.FunctionDef,
                 waivers: WaiverTable, findings: list[Finding],
                 initial_held: frozenset):
        self.cls = cls
        self.method = method
        self.waivers = waivers
        self.findings = findings
        self.held: set[str] = set(initial_held)
        # only REAL acquisitions (with-blocks) count for the order graph;
        # holds[...] contracts mean the caller already owns the lock
        self.acquired: set[str] = set()
        self.calls: list[tuple[frozenset, str]] = []
        self.acq_events: list[tuple[frozenset, str]] = []

    # nested defs get their own checker pass with the same initial held
    # set as the point of DEFINITION would be wrong (closures run later);
    # be conservative: check them as if no lock were held unless the
    # enclosing lock is held for the whole lifetime — undecidable, so we
    # treat nested function bodies as lock-free contexts.
    def visit_FunctionDef(self, node):
        if node is self.method:
            self.generic_visit(node)
            return
        sub = _MethodChecker(self.cls, node, self.waivers, self.findings,
                             frozenset())
        sub.visit_body(node)
        self.acquired |= sub.acquired
        self.calls += sub.calls
        self.acq_events += sub.acq_events

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        # a lambda escapes the region it is defined in (executor
        # callbacks, sort keys) and may run on any thread later — its
        # body gets the same conservative lock-free treatment as nested
        # defs; default values DO evaluate here, in the current context
        for d in list(node.args.defaults) + [
                kd for kd in node.args.kw_defaults if kd is not None]:
            self.visit(d)
        sub = _MethodChecker(self.cls, self.method, self.waivers,
                             self.findings, frozenset())
        sub.visit(node.body)
        self.acquired |= sub.acquired
        self.calls += sub.calls
        self.acq_events += sub.acq_events

    def visit_body(self, node):
        for stmt in node.body:
            self.visit(stmt)

    def visit_With(self, node: ast.With):
        new = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr and (attr in self.cls.lock_attrs
                         or attr in self.cls.guarded.values()):
                if attr in self.held or attr in new:
                    # re-acquisition of an already-held lock: a plain
                    # Lock self-deadlocks right here (the order graph
                    # can't see it — its edge-adders drop src == dst);
                    # reentrant/counting kinds nest legally, and the
                    # attr must NOT go into `new` either way or the
                    # inner exit would release the OUTER hold and every
                    # later guarded access would false-positive
                    kind = self.cls.lock_kinds.get(attr)
                    if kind in _SELF_DEADLOCK_FACTORIES:
                        self._finding(
                            "lock-order", item.context_expr,
                            f"{self.cls.name}.{attr} (threading.{kind}) "
                            f"re-acquired in {self.method.name}() while "
                            "already held — non-reentrant: guaranteed "
                            "self-deadlock")
                else:
                    self.acq_events.append(
                        (frozenset(self.held | set(new)), attr))
                    new.append(attr)
            # visit the context expression itself (it may read attrs)
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.held.update(new)
        self.acquired.update(new)
        for stmt in node.body:
            self.visit(stmt)
        for attr in new:
            self.held.discard(attr)

    visit_AsyncWith = visit_With

    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if attr:
            lock = self.cls.guarded.get(attr)
            if lock is not None and lock not in self.held:
                self._finding(
                    "lock-guard", node,
                    f"{self.cls.name}.{attr} is guarded_by('{lock}') but "
                    f"accessed in {self.method.name}() without holding "
                    f"self.{lock}")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        attr = _self_attr(node.func)
        if attr is not None:
            # same-class call: record for the order graph and enforce any
            # holds[...] contract
            self.calls.append((frozenset(self.held), attr))
            target = self.cls.methods.get(attr)
            if target is not None:
                for lock in self.waivers.holds_for(target.lineno):
                    if lock not in self.held:
                        self._finding(
                            "lock-holds", node,
                            f"{self.cls.name}.{attr}() requires "
                            f"self.{lock} held (lsk: holds) but "
                            f"{self.method.name}() calls it without")
        elif isinstance(node.func, ast.Attribute):
            # cross-object call — resolved by NAME for the order graph
            self.calls.append((frozenset(self.held), node.func.attr))
        self.generic_visit(node)

    def _finding(self, rule: str, node: ast.AST, msg: str) -> None:
        reason = self.waivers.waiver_for(rule, node.lineno)
        self.findings.append(Finding(rule, self.cls.path, node.lineno, msg,
                                     waived=reason is not None,
                                     waiver_reason=reason))


def check_lock_discipline(classes: list[ClassInfo],
                          waivers_by_path: dict[str, WaiverTable]
                          ) -> list[Finding]:
    """Discipline findings over already-collected (and inheritance-
    resolved) classes; fills each class's acquisition facts for the
    order graph as a side effect."""
    findings: list[Finding] = []
    for cls in classes:
        waivers = waivers_by_path[cls.path]
        for name, fn in cls.methods.items():
            if name == "__init__":
                # still record acquisitions for the order graph, but the
                # instance is unshared: no discipline findings
                silent: list[Finding] = []
                checker = _MethodChecker(cls, fn, waivers, silent,
                                         frozenset())
            else:
                held0 = frozenset(
                    lock for lock in waivers.holds_for(fn.lineno))
                checker = _MethodChecker(cls, fn, waivers, findings, held0)
            checker.visit_body(fn)
            cls.acquires[name] = set(checker.acquired)
            cls.calls_under[name] = checker.calls
            cls.acq_events[name] = checker.acq_events
    return findings


# ------------------------------------------------------------- order graph


def build_lock_order(classes: list[ClassInfo]
                     ) -> tuple[set[tuple[str, str]], list[list[str]]]:
    """(edges, cycles) over lock nodes ``Class.attr``.

    A method's transitive acquisition set is computed by fixpoint over
    the name-resolved call graph (bounded by the finite lock set), then
    every (held, call) fact contributes edges held -> acquired(call).
    """
    # method name -> [(class, method)] across every analyzed class
    by_name: dict[str, list[tuple[ClassInfo, str]]] = {}
    for cls in classes:
        for m in cls.methods:
            by_name.setdefault(m, []).append((cls, m))

    # transitive: locks (as Class.attr) a call to `name` may acquire
    def qualify(cls: ClassInfo, locks) -> set[str]:
        return {f"{cls.name}.{lk}" for lk in locks}

    trans: dict[tuple[str, str], set[str]] = {
        (cls.name, m): qualify(cls, cls.acquires.get(m, ()))
        for cls in classes for m in cls.methods}
    changed = True
    while changed:
        changed = False
        for cls in classes:
            for m in cls.methods:
                cur = trans[(cls.name, m)]
                for _held, callee in cls.calls_under.get(m, ()):
                    for tcls, tm in by_name.get(callee, ()):
                        extra = trans[(tcls.name, tm)] - cur
                        if extra:
                            cur |= extra
                            changed = True

    edges: set[tuple[str, str]] = set()
    for cls in classes:
        for m in cls.methods:
            # direct nesting: `with A: ... with B:` inside one body
            for held, lock in cls.acq_events.get(m, ()):
                dst = f"{cls.name}.{lock}"
                for src in qualify(cls, held):
                    if src != dst:
                        edges.add((src, dst))
            # one call deep: a method invoked while holding A whose
            # name-resolved body (transitively) acquires B
            for held, callee in cls.calls_under.get(m, ()):
                if not held:
                    continue
                held_q = qualify(cls, held)
                for tcls, tm in by_name.get(callee, ()):
                    for dst in trans[(tcls.name, tm)]:
                        for src in held_q:
                            if src != dst:
                                edges.add((src, dst))

    cycles = _find_cycles(edges)
    return edges, cycles


def _find_cycles(edges: set[tuple[str, str]]) -> list[list[str]]:
    """Strongly-connected components of size > 1 (plus self-loops),
    reported as sorted node lists — deterministic output for CI diffs."""
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan: (node, iterator) frames
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or (node, node) in edges:
                    out.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sorted(out)


def lock_order_findings(classes: list[ClassInfo]
                        ) -> tuple[list[Finding], list[str]]:
    edges, cycles = build_lock_order(classes)
    path_of = {c.name: c.path for c in classes}
    findings = [
        Finding("lock-order",
                path_of.get(cycle[0].split(".")[0], "<order-graph>"),
                cycle_line(classes, cycle),
                "lock acquisition-order cycle (potential deadlock): "
                + " <-> ".join(cycle))
        for cycle in cycles]
    edge_strs = [f"{a} -> {b}" for a, b in sorted(edges)]
    return findings, edge_strs


def cycle_line(classes: list[ClassInfo], cycle: list[str]) -> int:
    """Anchor a cycle finding at the declaring class's def line."""
    name = cycle[0].split(".")[0]
    for c in classes:
        if c.name == name:
            return c.node.lineno
    return 1
