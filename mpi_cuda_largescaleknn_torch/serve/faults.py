"""Deterministic fault injection for the serving stack.

The copy of the JAX package's ``serve/faults.py``, as far as the
single-host server uses it: ``KnnServer`` builds a ``FaultInjector`` from
the ``KNN_FAULTS`` environment variable when it starts, and its handler
consults it once per ``POST /knn`` (``JsonHttpHandler._apply_fault``), so
a failure drill runs against a served index without killing a process; a
tiered slab pool (serve/slabpool.py) consults it once per slab promotion,
keyed ``PROMOTE /slab/<id>`` or ``PROMOTE /slab/<tenant>/<id>``, where
``latency`` slows the promotion and any other op fails it. A matching rule
makes the handler

- ``latency``  : sleep ``delay_s`` before handling normally (slow host),
- ``error``    : answer ``code`` (default 500) without touching the engine,
- ``drop``     : close the connection without writing a response byte
                 (process-kill stand-in: the client sees a reset/EOF),
- ``close_mid_body``: send 200 headers claiming a body, write a short
                 prefix, close (torn transfer — exercises the client's
                 malformed-payload path).

Determinism: each spec carries its own ``random.Random(seed)`` and fires by
(a) a skip count ``after``, (b) a fire budget ``n`` (-1 = unlimited), and
(c) probability ``p`` drawn from that seeded stream — so for a given
sequence of matching requests the decision sequence is a pure function of
the spec. A routed pod's host servers (serve/frontend.py) consult the same
injector, and their admin endpoint ``POST /faults`` (``{"spec": ...}``,
always exempt from injection) replaces the rules at runtime; ``GET
/faults`` reads them back with their firing counts (``config``).

Spec string grammar (the ``KNN_FAULTS`` value or the admin body)::

    spec      := rule (';' rule)*
    rule      := op [':' kv (',' kv)*]
    op        := 'latency' | 'error' | 'drop' | 'close_mid_body'
    kv        := key '=' value      # path=/knn p=0.5 n=3 after=10
                                    # code=503 delay_s=0.2 seed=7
                                    # method=POST

``path`` is a substring match against the request path ('' matches all);
``method`` restricts a rule to one HTTP verb ('' matches all).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by

FAULT_OPS = ("latency", "error", "drop", "close_mid_body")
FAULTS_ENV = "KNN_FAULTS"


class FaultSpec:
    """One injection rule + its deterministic firing state."""

    def __init__(self, op: str, *, path: str = "", method: str = "",
                 p: float = 1.0, n: int = -1, after: int = 0,
                 code: int = 500, delay_s: float = 0.05, seed: int = 0):
        if op not in FAULT_OPS:
            raise ValueError(f"unknown fault op {op!r} (one of {FAULT_OPS})")
        self.op = op
        self.path = str(path)
        self.method = str(method).upper()
        self.p = float(p)
        self.n = int(n)
        self.after = int(after)
        self.code = int(code)
        self.delay_s = float(delay_s)
        self.seed = int(seed)
        # firing state (under the injector's lock)
        self.seen = 0
        self.fires = 0
        self._rng = random.Random(self.seed)

    def config(self) -> dict:
        return {"op": self.op, "path": self.path, "method": self.method,
                "p": self.p, "n": self.n,
                "after": self.after, "code": self.code,
                "delay_s": self.delay_s, "seed": self.seed,
                "seen": self.seen, "fires": self.fires}


def parse_fault_specs(text: str) -> list[FaultSpec]:
    """Parse the ``op:key=val,...;op2:...`` grammar into specs.

    An empty/whitespace string parses to no specs (= injection off)."""
    specs = []
    for rule in (text or "").split(";"):
        rule = rule.strip()
        if not rule:
            continue
        op, _, kvs = rule.partition(":")
        kwargs: dict = {}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, _, val = kv.partition("=")
            key = key.strip()
            if key in ("path", "method"):
                kwargs[key] = val.strip()
            elif key in ("n", "after", "code", "seed"):
                kwargs[key] = int(val)
            elif key in ("p", "delay_s"):
                kwargs[key] = float(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r}")
        specs.append(FaultSpec(op.strip(), **kwargs))
    return specs


class FaultInjector:
    """Ordered fault rules consulted once per HTTP request (and once per
    slab promotion, as ``PROMOTE /slab/...``: serve/slabpool.py).

    ``decide(path)`` returns the first matching spec that fires (or None);
    thread-safe, and deterministic for a given request order.
    ``set_specs`` replaces the whole rule set atomically (the admin
    endpoint's contract: a POST replaces, an empty POST clears)."""

    def __init__(self, specs: list[FaultSpec] | None = None):
        self._lock = threading.Lock()
        # the spec list and each spec's firing state (seen/fires/_rng) are
        # mutated under this lock: set_specs() and decide() are the only
        # mutators, config() the only reader of the counters
        self._specs: guarded_by("_lock") = list(specs or [])

    @classmethod
    def from_env(cls, env_var: str = FAULTS_ENV) -> "FaultInjector":
        return cls(parse_fault_specs(os.environ.get(env_var, "")))

    def set_specs(self, specs: str | list[FaultSpec]) -> None:
        if isinstance(specs, str):
            specs = parse_fault_specs(specs)
        with self._lock:
            self._specs = list(specs)

    def clear(self) -> None:
        self.set_specs([])

    def active(self) -> bool:
        with self._lock:
            return bool(self._specs)

    def decide(self, path: str, method: str = "") -> FaultSpec | None:
        """First matching spec that fires for this request, else None.
        ``method`` (the HTTP verb; '' in a spec matches all) is part of
        the match, BEFORE the skip/budget counters — a method-filtered
        rule only counts the requests it could fire on."""
        with self._lock:
            for spec in self._specs:
                if spec.path and spec.path not in path:
                    continue
                if spec.method and spec.method != method.upper():
                    continue
                spec.seen += 1
                if spec.seen <= spec.after:
                    continue
                if spec.n >= 0 and spec.fires >= spec.n:
                    continue
                if spec.p < 1.0 and spec._rng.random() >= spec.p:
                    continue
                spec.fires += 1
                return spec
        return None

    def config(self) -> list[dict]:
        with self._lock:
            return [s.config() for s in self._specs]


def apply_http_fault(handler, spec: FaultSpec | None) -> bool:
    """Apply a fired spec to a BaseHTTPRequestHandler-style handler.

    Returns True when the fault CONSUMED the request (the handler must not
    write its normal response); ``latency`` only delays and returns False.
    """
    if spec is None:
        return False
    if spec.op == "latency":
        time.sleep(spec.delay_s)
        return False
    if spec.op == "error":
        body = json.dumps({"error": "injected-fault",
                           "fault": spec.op}).encode()
        handler.send_response(spec.code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        # the request body was never read: close so the unread bytes can't
        # poison a kept-alive connection's next request
        handler.send_header("Connection", "close")
        handler.close_connection = True
        handler.end_headers()
        handler.wfile.write(body)
        return True
    if spec.op == "drop":
        # no response bytes at all; closing the socket gives the client a
        # clean connection-level failure (the kill stand-in)
        handler.close_connection = True
        return True
    if spec.op == "close_mid_body":
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", "4096")
        handler.end_headers()
        handler.wfile.write(b"\x00" * 64)  # 64 of the promised 4096
        handler.close_connection = True
        return True
    raise AssertionError(f"unhandled fault op {spec.op!r}")
