"""Certified query cache: exact-hit reuse, in-flight dedup, radius seeds.

Real user traffic is massively repetitive, and a served kNN answer over an
immutable index is a *certificate*: the same query bytes must produce the
same answer bytes, and a near-duplicate query's answer is bounded by the
triangle inequality. This module turns those two facts into three reuse
tiers, all exactness-preserving, threaded through the batcher
(serve/batcher.py ``submit``):

1. **Exact-hit LRU** — keyed by (tenant, index generation, plan token,
   query row bytes). A repeat query is served verbatim from the cached
   row: byte-identical response, zero device work. Sound because the
   index is immutable per generation (``invalidate()`` bumps the
   generation and drops everything when an index ever swaps).
2. **In-flight dedup** — the first submitter of a row becomes its OWNER
   (the row runs on the device once); identical rows arriving before the
   owner publishes JOIN the in-flight entry and receive the same bytes.
   A thundering herd of one query costs one row of compute. If the owner
   fails, joiners are told (``error``) and retry as their own owners —
   a failure never strands a waiter.
3. **Triangle-inequality radius seeding** — for a query q near a cached
   q0 whose kth distance d_k(q0) is known, every true neighbor of q lies
   within r = d_k(q0) + ||q - q0||, so the engine may START its heap at
   r instead of ``max_radius`` and prune tiles sooner
   (``ResidentKnnEngine.dispatch(seed_radius=...)``). The answer is
   provably unchanged — IF the seed never understates the bound.

Seed soundness (the part the tests pin bit-for-bit): the heap adopts
candidates by strict-< against the init slots, and under the canonical
(dist2, id) tie order an init slot ``(seed**2, -1)`` WINS ties against
real candidates. So the f32 seed must satisfy ``f32(seed)**2`` strictly
greater than every true-top-k candidate's device-computed f32 dist2 —
a plain ``nextafter`` in the radius domain is NOT enough (``a**2`` and
``nextafter(a)**2`` can round to the same f32). ``seed_for`` therefore
computes the bound in f64, applies a dimension-scaled multiplicative
slack covering the f32 distance kernel's rounding (mirroring the routed
certification slack), casts to f32, rounds up one more ulp, and floors
the result so ``seed**2`` cannot underflow to 0.0 (which would exclude
distance-0 candidates). Extra slack only admits more candidates — always
safe; only an understated bound could change answers.

Seeds are only drawn from FULL exact rows (all k ids real, finite kth
distance): fullness guarantees at least k true candidates strictly
inside the seed, so every init slot is displaced and the seeded result
is bitwise identical to the unseeded one — including under a finite
engine ``max_radius`` (a clamped seed degenerates to the unseeded init).
Approximate-plan requests are never seeded (their visit schedules
interact with the init radius) and never feed the seed pool; they still
get tiers 1 and 2 under their plan's ``batch_key()`` token.

Shared state discipline: batcher submitter threads and handler threads
race on every structure here, so the LRU, the in-flight registry, the
seed pools and all counters live under one leaf lock (lskcheck's
guarded_by pass proves it; the lock is never held across device work or
another lock).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by

#: smallest admissible seed radius: its f32 square (~1e-36) is still a
#: normal-ish positive float, so distance-0 candidates (d2 == 0.0) stay
#: strictly inside the seed and are admitted by the strict-< heap
_SEED_FLOOR = np.float32(1e-18)


class _InFlightRow:
    """One row currently on the device on behalf of its first submitter.

    Joiners park on ``event``; the owner fills ``result`` (the row's
    answer tuple) or ``error`` before setting it. Immutable-after-set, so
    readers need no lock once the event fires."""

    __slots__ = ("event", "result", "error", "joiners")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.joiners = 0


class SeedPool:
    """Ring of recent (query row, certified kth distance) pairs for ONE
    index (one tenant). Fixed capacity, overwrite-oldest; the vectorized
    nearest-source lookup runs on snapshot copies outside the cache lock.
    Only ever fed full exact rows, so every stored dk is a true kth
    distance certificate."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._q: guarded_by("_lock") = None  # f32[capacity, dim], lazy
        self._dk: guarded_by("_lock") = None  # f32[capacity]
        self._count: guarded_by("_lock") = 0
        self._pos: guarded_by("_lock") = 0

    def add(self, qrow: np.ndarray, dk: float) -> None:
        with self._lock:
            if self._q is None:
                self._q = np.empty((self.capacity, len(qrow)), np.float32)
                self._dk = np.empty(self.capacity, np.float32)
            if self._q.shape[1] != len(qrow):
                return  # dim mismatch: never seed across index shapes
            self._q[self._pos] = qrow
            self._dk[self._pos] = np.float32(dk)
            self._pos = (self._pos + 1) % self.capacity
            self._count = min(self._count + 1, self.capacity)

    def snapshot(self):
        """(q f32[m, dim], dk f32[m]) copies — or None when empty."""
        with self._lock:
            if self._count == 0:
                return None
            m = self._count
            return self._q[:m].copy(), self._dk[:m].copy()


def certified_seeds(qrows: np.ndarray, src_q: np.ndarray,
                    src_dk: np.ndarray) -> np.ndarray:
    """Per-row certified init radii for ``qrows`` from cached sources.

    For each query row the bound is ``min_j (dk[j] + ||q - q_j||)``,
    computed in f64, inflated by a dim-scaled slack covering the engine's
    f32 distance rounding, cast to f32 and rounded UP one ulp, floored at
    ``_SEED_FLOOR`` — so the f32 seed's square strictly exceeds every
    true-top-k candidate's device-computed dist2 (the strict-< parity
    requirement in the module docstring). Pure function of its inputs;
    the caller decides which rows actually use their seed."""
    q64 = qrows.astype(np.float64)
    s64 = src_q.astype(np.float64)
    # [n, m] exact-in-f64 pairwise distances (f32 inputs are exact f64)
    d = np.sqrt(((q64[:, None, :] - s64[None, :, :]) ** 2).sum(axis=2))
    bound = np.min(src_dk.astype(np.float64)[None, :] + d, axis=1)
    dim = qrows.shape[1]
    slack = max(16.0 * (dim + 2) * 2.0 ** -24, 1e-5)
    seed = np.nextafter((bound * (1.0 + slack)).astype(np.float32),
                        np.float32(np.inf))
    return np.maximum(seed, _SEED_FLOOR)


class QueryCache:
    """The three-tier reuse layer the batcher threads every request
    through. One instance per server; multi-tenant servers share it (the
    tenant name is part of every key and each tenant has its own seed
    pool — results and seeds NEVER cross indexes).

    ``capacity_rows`` bounds the exact-hit LRU in rows; ``seed_rows``
    bounds each tenant's seed ring. ``fingerprint`` is the serving
    index's identity string (informational — the generation counter is
    what actually fences reuse across index swaps via ``invalidate``).
    """

    def __init__(self, *, capacity_rows: int = 4096, seed_rows: int = 512,
                 fingerprint: str = ""):
        if capacity_rows < 1:
            raise ValueError("capacity_rows must be >= 1")
        self.capacity_rows = int(capacity_rows)
        self.seed_rows = int(seed_rows)
        self.fingerprint = str(fingerprint)
        self._lock = threading.Lock()
        #: key -> row result tuple (arity-generic: (dist, ids[, exact]))
        self._lru: guarded_by("_lock") = OrderedDict()
        #: key -> _InFlightRow owned by some submitter
        self._inflight: guarded_by("_lock") = {}
        #: tenant -> SeedPool (SeedPool has its own leaf lock)
        self._seed_pools: guarded_by("_lock") = {}
        #: index generation: part of every key; invalidate() bumps it
        self._gen: guarded_by("_lock") = 0
        self.hits: guarded_by("_lock") = 0
        self.misses: guarded_by("_lock") = 0
        self.seeds: guarded_by("_lock") = 0
        self.dedup_rows: guarded_by("_lock") = 0
        self.evictions: guarded_by("_lock") = 0
        self.inserts: guarded_by("_lock") = 0
        self.inflight_aborts: guarded_by("_lock") = 0
        #: per-tenant counter twins for the four /metrics series
        self._tenant_counts: guarded_by("_lock") = {}

    # ---------------------------------------------------------------- keys

    def _tcounts(self, tenant):  # lsk: holds[_lock]
        c = self._tenant_counts.get(tenant)
        if c is None:
            c = {"hits": 0, "seeds": 0, "dedup_rows": 0, "evictions": 0}
            self._tenant_counts[tenant] = c
        return c

    def invalidate(self) -> None:
        """Fence a new index generation: drop every cached row and seed.
        In-flight entries keyed under the old generation still complete
        for their joiners; their publication lands in dead keys."""
        with self._lock:
            self._gen += 1
            self._lru.clear()
            self._seed_pools = {}

    # --------------------------------------------------------------- begin

    def begin(self, queries: np.ndarray, plan_token, tenant):
        """Classify every row of a request under one lock acquisition.

        Returns a per-row action list: ``("hit", row_tuple)`` — serve the
        cached bytes; ``("local", j)`` — duplicate of row j of THIS
        request, copy its answer; ``("join", entry)`` — duplicate of a
        row another request has in flight, wait on the entry;
        ``("own", key)`` — this request computes the row and MUST later
        ``publish`` or ``abort`` the key."""
        actions = []
        seen = {}
        with self._lock:
            gen = self._gen
            tc = self._tcounts(tenant)
            for i in range(len(queries)):
                key = (tenant, gen, plan_token, queries[i].tobytes())
                j = seen.get(key)
                if j is not None:
                    self.dedup_rows += 1
                    tc["dedup_rows"] += 1
                    actions.append(("local", j))
                    continue
                seen[key] = i
                row = self._lru.get(key)
                if row is not None:
                    self._lru.move_to_end(key)
                    self.hits += 1
                    tc["hits"] += 1
                    actions.append(("hit", row))
                    continue
                entry = self._inflight.get(key)
                if entry is not None:
                    entry.joiners += 1
                    self.dedup_rows += 1
                    tc["dedup_rows"] += 1
                    actions.append(("join", entry))
                    continue
                self.misses += 1
                self._inflight[key] = _InFlightRow()
                actions.append(("own", key))
        return actions

    # --------------------------------------------------------------- seeds

    def seed_for(self, qrows: np.ndarray, tenant) -> np.ndarray | None:
        """Certified per-row init radii for an EXACT-tier sub-batch, or
        None when the tenant's seed pool is empty. Rows with no useful
        bound come back +inf (the engine treats them as unseeded)."""
        if len(qrows) == 0:
            return None
        with self._lock:
            pool = self._seed_pools.get(tenant)
        snap = pool.snapshot() if pool is not None else None
        if snap is None:
            return None
        seeds = certified_seeds(qrows, *snap)
        finite = int(np.sum(np.isfinite(seeds)))
        if finite == 0:
            return None
        with self._lock:
            self.seeds += finite
            self._tcounts(tenant)["seeds"] += finite
        return seeds

    # ------------------------------------------------------------- publish

    def publish(self, keys: list, outs: tuple, queries: np.ndarray,
                plan_token, tenant) -> None:
        """Deliver a completed sub-batch: wake joiners, insert rows into
        the LRU, and feed full exact rows to the tenant's seed pool.

        ``keys`` are the ``("own", key)`` keys in sub-batch row order;
        ``outs`` is the engine result tuple — ``(dists, ids)`` or
        ``(dists, ids, exact)`` (a routed pod's degraded serving). A row
        with ``exact == False`` wakes its joiners (they asked for THESE
        bytes) but is never inserted: a degraded partial answer must not
        outlive the outage that produced it."""
        rows = []
        for j, key in enumerate(keys):
            # copy per-cell: an LRU row must not pin the batch arrays
            rows.append((key, tuple(np.copy(a[j]) for a in outs)))
        exact_plan = plan_token is None
        with self._lock:
            tc = self._tcounts(tenant)
            pool = None
            if exact_plan:
                pool = self._seed_pools.get(tenant)
                if pool is None and self.seed_rows > 0:
                    pool = SeedPool(self.seed_rows)
                    self._seed_pools[tenant] = pool
            for j, (key, row) in enumerate(rows):
                entry = self._inflight.pop(key, None)
                if entry is not None:
                    entry.result = row
                    entry.event.set()
                if len(row) > 2 and not bool(row[2]):
                    continue
                self._lru[key] = row
                self._lru.move_to_end(key)
                self.inserts += 1
                while len(self._lru) > self.capacity_rows:
                    self._lru.popitem(last=False)
                    self.evictions += 1
                    tc["evictions"] += 1
                if (pool is not None and np.isfinite(row[0])
                        and np.all(np.asarray(row[1]) >= 0)):
                    pool.add(queries[j], float(row[0]))

    def abort(self, keys: list, error: Exception | None = None) -> None:
        """Release owned keys after a failed sub-batch: joiners wake with
        the error and retry as their own owners (serve/batcher.py)."""
        err = error if error is not None else RuntimeError(
            "in-flight owner failed")
        with self._lock:
            for key in keys:
                entry = self._inflight.pop(key, None)
                if entry is not None:
                    self.inflight_aborts += 1
                    entry.error = err
                    entry.event.set()

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity_rows": self.capacity_rows,
                "seed_rows": self.seed_rows,
                "fingerprint": self.fingerprint,
                "generation": self._gen,
                "size_rows": len(self._lru),
                "inflight_rows": len(self._inflight),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (round(self.hits / (self.hits + self.misses), 4)
                             if (self.hits + self.misses) else None),
                "seeds": self.seeds,
                "dedup_rows": self.dedup_rows,
                "evictions": self.evictions,
                "inserts": self.inserts,
                "inflight_aborts": self.inflight_aborts,
                "tenants": {t: dict(c)
                            for t, c in self._tenant_counts.items()
                            if t is not None},
            }
