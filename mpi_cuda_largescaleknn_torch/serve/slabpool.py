"""The tiered slab index: an index larger than the card's share of memory,
served from a device working set of slab engines over a host-RAM pool over
the cold file.

The port of the JAX package's ``serve/slabpool.py``. A resident engine caps
the index at device memory; this module tiers it in three levels:

- **device** — a working set of slab engines (one ``ResidentKnnEngine``
  per resident slab, ``emit="candidates"`` with global neighbor ids),
  bounded in BYTES by ``device_slab_budget`` against each engine's
  ``device_bytes`` (everything it holds on the card, the kernels' prepared
  point side included), evicted least recently used, never while pinned;
- **host RAM** — a bounded pool of slab rows (numpy), the promotion
  source, capped by bytes (``host_pool_bytes``) or slabs
  (``host_pool_slabs``);
- **cold** — the source ``.float3`` / ``.npy`` file itself (``SlabSource``:
  the ``load_slab_rows`` split of serve/engine.py, mmap for ``.npy``).

``StreamingKnnEngine`` is the engine the serving stack drives (the same
``dispatch`` / ``complete`` split and ``stats()`` as the resident engine):
each batch is routed by a per-slab bounds table to its nearest slab plus
every slab whose box contains it, the slabs' candidate rows are folded
with the canonical (dist2, id) merge (serve/frontend.py
``fold_candidates``: commutative, so the order slabs complete in never
changes bits), and uncertified (query, slab) pairs escalate in waves until
``lb * (1 - routing_cert_slack) <= kth²`` holds for no skipped slab. A
needed slab that misses both warm tiers STALLS the batch (counted in
``stream_stall_seconds``); it is never skipped or approximated, so the
answers are bit-identical to a fully resident engine at every budget. A
request that opts into the recall tier's ``stream_skip_cold`` plan
(serve/recall.py) inverts that one trade: a cold slab whose bound could
still beat the k-th distance is skipped for recall instead of stalled on
(``stream_skipped_promotions``), unless the pool is already stalling above
``skip_cold_stall_limit`` (the drift guard).

Overlap: ``dispatch`` PINS the batch's slab set (a pinned slab cannot be
evicted while its batch is in flight), a promotion thread builds
prefetched slabs while others serve, and the batcher announces the next
batch's rows after each dispatch (``prefetch_hint``), so promotions ride
under the batch in flight. On the card a slab engine builds on its own
stream and is handed out only after that stream has finished its build.

Launch plans across the churn: every slab engine is padded to ONE shape
class (``pad_shard_rows``) and shares one ``LaunchPlanCache``, so an
evicted and re-promoted slab builds no plan: ``compile_count`` stays flat.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time

import numpy as np

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.obs.timers import PhaseTimers
from mpi_cuda_largescaleknn_torch.serve.faults import FaultInjector

_RECORD_BYTES = 12  # one float3 (io/reader.py)


class SlabSource:
    """The cold tier: materialize slab ``s`` of ``S`` on demand.

    A file's rows come from ``serve/engine.py load_slab_rows``: the
    reference's integer split ``[N*s/S, N*(s+1)/S)`` through
    ``read_file_portion`` for ``.float3``, an mmap slice for ``.npy``; an
    in-memory array's from a plain slice (a routed streaming host hands
    its loaded slab here); with ``url=`` a row sub-range pulled over HTTP
    from a host serving the full index (``GET
    /slab_rows?wire=d16&begin=&end=``, serve/replica.py
    ``pull_slab_rows``: the d16 delta codec, verified lossless by its
    crc32 fingerprint after decode; a host without the codec answers the
    single-shot f32 body). Reads are stateless; the pool's locking lives
    above this."""

    def __init__(self, *, path: str | None = None, points=None,
                 url: str | None = None, num_slabs: int,
                 wire: str = "d16", timeout_s: float = 120.0,
                 throttle_bps: float | None = None):
        from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds

        if sum(x is not None for x in (path, points, url)) != 1:
            raise ValueError("need exactly one of path=, points= or url=")
        if num_slabs < 1:
            raise ValueError(f"num_slabs must be >= 1, got {num_slabs}")
        self.path = path
        self.num_slabs = int(num_slabs)
        self._points = None
        self._url = None
        if url is not None:
            import json as _json
            import urllib.request as _rq

            self._url = url.rstrip("/")
            self._wire = wire
            self._timeout_s = float(timeout_s)
            self._throttle_bps = throttle_bps
            with _rq.urlopen(self._url + "/stats",
                             timeout=self._timeout_s) as r:
                est = _json.loads(r.read()).get("engine") or {}
            self.n_total = int(est.get("n_points", -1))
            self.dim = int(est.get("dim", 0))
            off = int(est.get("row_offset", -1))
            if self.n_total < 0 or self.dim < 1 or off != 0:
                raise ValueError(
                    f"{url}: not a full-index source host (n_points="
                    f"{self.n_total} dim={self.dim} row_offset={off})")
        elif points is not None:
            self._points = np.asarray(points, np.float32)
            if self._points.ndim != 2 or self._points.shape[1] < 1:
                raise ValueError(f"points must be [N, D], got "
                                 f"{self._points.shape}")
            self.n_total = len(self._points)
            self.dim = int(self._points.shape[1])
        elif path.endswith(".npy"):
            shape = np.load(path, mmap_mode="r").shape
            if len(shape) != 2 or shape[1] < 1:
                raise ValueError(f"{path}: expected an [N, D] array, got "
                                 f"shape {list(shape)}")
            self.n_total, self.dim = int(shape[0]), int(shape[1])
        else:
            self.n_total = os.path.getsize(path) // _RECORD_BYTES
            self.dim = 3
        #: slab s owns global rows [bounds[s][0], bounds[s][1])
        self.bounds = slab_bounds(self.n_total, self.num_slabs)

    def read(self, slab: int) -> np.ndarray:
        """Materialize slab ``slab``'s rows (f32[n, dim])."""
        from mpi_cuda_largescaleknn_torch.serve.engine import load_slab_rows

        b, e = self.bounds[slab]
        if self._url is not None:
            from mpi_cuda_largescaleknn_torch.serve.replica import (
                pull_slab_rows,
            )

            rows, off = pull_slab_rows(
                self._url, timeout_s=self._timeout_s, wire=self._wire,
                begin=b, end=e, throttle_bps=self._throttle_bps)
            if off != b or len(rows) != e - b:
                raise ValueError(
                    f"{self._url}: slab {slab} range drifted: got "
                    f"[{off}, {off + len(rows)}) want [{b}, {e})")
            return rows
        if self._points is not None:
            return np.asarray(self._points[b:e], np.float32)
        # an .npy slab copies exactly its pages into RAM: the cold tier
        # never loads the whole file
        rows, begin, _n = load_slab_rows(self.path, slab, self.num_slabs)
        if begin != b:
            raise RuntimeError(f"slab split drifted: {begin} != {b}")
        return rows

    def scan_aabbs(self, sink=None) -> list[dict]:
        """One bounding box and count per slab ({"lo", "hi", "count"},
        ``lo/hi = None`` for an empty slab, which routing never reaches).
        Reads one slab at a time; ``sink(slab, rows)`` (if given) receives
        each slab's rows as they pass, so the streaming engine seeds its
        pool's host tier with them."""
        from mpi_cuda_largescaleknn_torch.models.sharding import slab_aabbs

        out = []
        for s in range(self.num_slabs):
            rows = self.read(s)
            out.extend(slab_aabbs(rows, [(0, len(rows))]))
            if sink is not None:
                sink(s, rows)
        return out


class _DeviceSlab:
    """One device-resident slab: its engine, its byte footprint, and its
    LRU tick (a logical counter, not wall-clock)."""

    __slots__ = ("engine", "bytes", "tick")

    def __init__(self, engine, nbytes: int, tick: int):
        self.engine = engine
        self.bytes = int(nbytes)
        self.tick = int(tick)


class SlabPool:
    """Tiered slab store: device engines over a host-RAM row pool over the
    cold source, with LRU-with-pin eviction and a promotion thread.

    ``engine_factory(slab_id, rows, row_begin) -> engine`` builds the
    device tier's entries (the streaming engine supplies the real
    ``ResidentKnnEngine`` factory; unit tests inject fakes). The factory
    runs OUTSIDE the pool lock: a build takes real time and must never
    block a /stats scrape or a concurrent pin.

    ``ensure`` blocks until the slab is resident: a miss is a counted
    STALL (``stream_stall_seconds``), never a skipped slab. Pinned slabs
    (``pin`` / ``unpin``: a dispatch pins its batch's slab set while the
    batch is in flight) are never evicted; when one batch's pinned set
    exceeds the budget the pool overcommits (counted) rather than
    deadlock: the budget bounds the steady state.

    Pool keys are plain slab ints (one index: one source, one factory) or
    ``(tenant, slab)`` tuples routed through a per-tenant registry
    (``register``). All tenants share ONE device byte budget and ONE host
    tier; per-tenant counters ride beside the pool-wide ones. A pool never
    mixes both key kinds.
    """

    def __init__(self, source: SlabSource | None = None,
                 engine_factory=None, *,
                 device_budget_bytes: int = 0, host_pool_slabs: int = 0,
                 host_pool_bytes: int = 0,
                 faults: FaultInjector | None = None,
                 clock=time.perf_counter):
        self._clock = clock
        self._sleep = time.sleep  # injectable: fault tests never sleep
        self._faults = faults
        self._cv = threading.Condition()
        # every field below is shared between caller threads (pin/ensure/
        # stats) and the promotion thread: all access under _cv
        #: tenant -> (SlabSource, engine_factory); one index registers
        #: under tenant None and keys the pool by bare slab ints
        self._routes: guarded_by("_cv") = {}
        if source is not None:
            self._routes[None] = (source, engine_factory)
        #: tenant -> counter dict (tuple-keyed pools only)
        self._tenants: guarded_by("_cv") = {}
        self._budget: guarded_by("_cv") = int(device_budget_bytes)
        self._host_cap: guarded_by("_cv") = int(host_pool_slabs)
        self._host_bytes_cap: guarded_by("_cv") = int(host_pool_bytes)
        self._host_bytes: guarded_by("_cv") = 0
        self._device: guarded_by("_cv") = {}
        self._device_bytes: guarded_by("_cv") = 0
        #: the most device bytes the pool has held at once
        self._device_bytes_peak: guarded_by("_cv") = 0
        #: host-RAM row pool, oldest first (move-to-end on a hit = LRU)
        self._host: guarded_by("_cv") = {}
        self._pins: guarded_by("_cv") = {}
        self._promoting: guarded_by("_cv") = set()
        self._queued: guarded_by("_cv") = set()
        self._tick: guarded_by("_cv") = 0
        self._closed: guarded_by("_cv") = False
        self.promotions: guarded_by("_cv") = 0
        self.promotion_errors: guarded_by("_cv") = 0
        self.last_error: guarded_by("_cv") = None
        self.evictions: guarded_by("_cv") = 0
        self.host_evictions: guarded_by("_cv") = 0
        self.device_hits: guarded_by("_cv") = 0
        self.host_hits: guarded_by("_cv") = 0
        self.cold_reads: guarded_by("_cv") = 0
        self.overcommits: guarded_by("_cv") = 0
        self.prefetch_enqueued: guarded_by("_cv") = 0
        self.prefetch_errors: guarded_by("_cv") = 0
        self.stream_stalls: guarded_by("_cv") = 0
        self.stream_stall_seconds: guarded_by("_cv") = 0.0
        self._pq: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._prefetch_loop,
                                        daemon=True, name="knn-slab-promote")
        self._thread.start()

    # ------------------------------------------------------- keys & routes

    @staticmethod
    def _as_key(s):
        """A caller's slab reference as a pool key: a bare int for a
        one-index pool, a (tenant, slab) tuple for a multi-tenant one."""
        return (s[0], int(s[1])) if isinstance(s, tuple) else int(s)

    def register(self, tenant, source: SlabSource, engine_factory) -> None:
        """Add (or replace) a tenant's cold source and engine factory,
        before that tenant's keys circulate."""
        with self._cv:
            self._routes[tenant] = (source, engine_factory)

    def _route(self, key):  # lsk: holds[_cv]
        """(tenant, local slab, source, factory) of a pool key."""
        if isinstance(key, tuple):
            tenant, slab = key
        else:
            tenant, slab = None, int(key)
        src, fac = self._routes[tenant]
        return tenant, slab, src, fac

    def _tacct(self, key):  # lsk: holds[_cv]
        """The per-tenant counter dict of a tuple key (made on first use);
        None for int keys."""
        if not isinstance(key, tuple):
            return None
        acct = self._tenants.get(key[0])
        if acct is None:
            acct = self._tenants[key[0]] = {
                "promotions": 0, "evictions": 0, "device_hits": 0,
                "host_hits": 0, "cold_reads": 0, "prefetch_enqueued": 0,
                "stream_stalls": 0, "stream_stall_seconds": 0.0}
        return acct

    # ----------------------------------------------------------- accounting

    def _next_tick(self) -> int:  # lsk: holds[_cv]
        self._tick += 1
        return self._tick

    def _note_stall(self, seconds: float, key=None):  # lsk: holds[_cv]
        self.stream_stalls += 1
        self.stream_stall_seconds += max(0.0, float(seconds))
        acct = self._tacct(key)
        if acct is not None:
            acct["stream_stalls"] += 1
            acct["stream_stall_seconds"] += max(0.0, float(seconds))

    def stall_totals(self, tenant=None) -> tuple:
        """(stalls, cumulative stall seconds), the drift guard's sample;
        ``tenant`` narrows it to one tenant's share."""
        with self._cv:
            if tenant is None:
                return self.stream_stalls, self.stream_stall_seconds
            acct = self._tenants.get(tenant)
            if acct is None:
                return 0, 0.0
            return acct["stream_stalls"], acct["stream_stall_seconds"]

    def _host_put(self, key, rows) -> None:  # lsk: holds[_cv]
        """Insert or refresh a slab's rows in the host tier; trim the
        oldest past the slab cap and the byte cap (the newest insert always
        stays). A device-resident slab keeps its own reference to its rows
        (``engine.host_points``), so trimming here never loses data: at
        worst the cold tier supplies them again."""
        old = self._host.pop(key, None)
        if old is not None:
            self._host_bytes -= int(getattr(old, "nbytes", 0))
        self._host[key] = rows
        self._host_bytes += int(getattr(rows, "nbytes", 0))
        while ((self._host_cap > 0 and len(self._host) > self._host_cap)
               or (self._host_bytes_cap > 0
                   and self._host_bytes > self._host_bytes_cap
                   and len(self._host) > 1)):
            victim = next(iter(self._host))
            self._host_bytes -= int(
                getattr(self._host[victim], "nbytes", 0))
            del self._host[victim]
            self.host_evictions += 1

    def _evict_to_fit(self, new_bytes: int) -> None:  # lsk: holds[_cv]
        """Evict the least recently used unpinned device slabs until
        ``new_bytes`` more fit the budget (0 = unbounded); an evicted
        engine's rows demote to the host tier. With nothing evictable the
        pool overcommits: a pinned set wider than the budget must
        complete, not deadlock."""
        if self._budget <= 0:
            return
        while self._device_bytes + new_bytes > self._budget and self._device:
            victims = [(ent.tick, s) for s, ent in self._device.items()
                       if self._pins.get(s, 0) == 0]
            if not victims:
                # counted once a promotion that lands over budget (unpin
                # and set-budget re-checks do not count again)
                if new_bytes > 0:
                    self.overcommits += 1
                return
            _tick, s = min(victims)
            ent = self._device.pop(s)
            self._device_bytes -= ent.bytes
            self.evictions += 1
            acct = self._tacct(s)
            if acct is not None:
                acct["evictions"] += 1
            rows = getattr(ent.engine, "host_points", None)
            if rows is not None:
                self._host_put(s, rows)

    # ------------------------------------------------------------- pin/ensure

    def pin(self, slabs) -> None:
        """Pin each slab against eviction (reference-counted), resident or
        not yet: a pinned cold slab cannot be evicted between its
        promotion and its use."""
        with self._cv:
            for s in set(slabs):
                self._pins[s] = self._pins.get(s, 0) + 1

    def unpin(self, slabs) -> None:
        with self._cv:
            for s in set(slabs):
                c = self._pins.get(s, 0) - 1
                if c <= 0:
                    self._pins.pop(s, None)
                else:
                    self._pins[s] = c
            # a batch whose pinned set overcommitted the budget shrinks
            # back the moment its pins release
            self._evict_to_fit(0)
            self._cv.notify_all()

    def ensure(self, slab, count_stall: bool = True):
        """The slab's resident engine, promoted first if needed. A
        promotion the caller had to WAIT for (a cold or host miss, or an
        in-flight promotion it parked behind) is a counted stall unless
        ``count_stall=False`` (warmup and prefetch: data motion the
        stream never waited on)."""
        slab = self._as_key(slab)
        t0 = None
        while True:
            with self._cv:
                ent = self._device.get(slab)
                if ent is not None:
                    ent.tick = self._next_tick()
                    if t0 is None:
                        self.device_hits += 1
                        acct = self._tacct(slab)
                        if acct is not None:
                            acct["device_hits"] += 1
                    elif count_stall:
                        self._note_stall(self._clock() - t0, slab)
                    return ent.engine
                if slab in self._promoting:
                    # another thread (usually the promotion thread) is
                    # building it: park until it lands
                    if t0 is None:
                        t0 = self._clock()
                    self._cv.wait(0.05)
                    continue
                self._promoting.add(slab)
                if t0 is None:
                    t0 = self._clock()
            break
        try:
            eng = self._build(slab)
        except BaseException as e:
            with self._cv:
                self._promoting.discard(slab)
                self.promotion_errors += 1
                self.last_error = f"slab {slab}: {type(e).__name__}: {e}"
                self._cv.notify_all()
            raise
        with self._cv:
            self._evict_to_fit(eng.device_bytes)
            self._device[slab] = _DeviceSlab(eng, eng.device_bytes,
                                             self._next_tick())
            self._device_bytes += int(eng.device_bytes)
            self._device_bytes_peak = max(self._device_bytes_peak,
                                          self._device_bytes)
            self._promoting.discard(slab)
            self.promotions += 1
            acct = self._tacct(slab)
            if acct is not None:
                acct["promotions"] += 1
            if count_stall:
                self._note_stall(self._clock() - t0, slab)
            self._cv.notify_all()
        return eng

    def _build(self, key):
        """Materialize the rows (host tier first, the cold source on a
        miss) and build the slab's engine, with NO pool lock held across
        the read or the build."""
        with self._cv:
            _tenant, slab, src, fac = self._route(key)
            b, _e = src.bounds[slab]
            rows = self._host.get(key)
            if rows is not None:
                self._host.pop(key)
                self._host[key] = rows  # move-to-end = LRU refresh
                self.host_hits += 1
                acct = self._tacct(key)
                if acct is not None:
                    acct["host_hits"] += 1
        if rows is None:
            rows = src.read(slab)
            with self._cv:
                self.cold_reads += 1
                acct = self._tacct(key)
                if acct is not None:
                    acct["cold_reads"] += 1
                self._host_put(key, rows)
        self._maybe_fault(key)
        return fac(slab, rows, b)

    def _maybe_fault(self, key) -> None:
        """Deterministic promotion faults (serve/faults.py): ``latency``
        slows the promotion (the slow-promotion stall drill), any other op
        fails it; keyed ``PROMOTE /slab/<id>`` or ``PROMOTE
        /slab/<tenant>/<id>``."""
        if self._faults is None or not self._faults.active():
            return
        path = (f"/slab/{key[0]}/{key[1]}" if isinstance(key, tuple)
                else f"/slab/{key}")
        spec = self._faults.decide(path, "PROMOTE")
        if spec is None:
            return
        if spec.op == "latency":
            self._sleep(spec.delay_s)
        else:
            raise RuntimeError(f"injected promotion fault: {spec.op}")

    # -------------------------------------------------------------- prefetch

    def prefetch(self, slabs) -> None:
        """Queue promotions for the promotion thread (skipping resident,
        building and queued slabs). A prefetched slab later ``ensure``d
        is a device hit: no stall."""
        todo = []
        with self._cv:
            if self._closed:
                return
            for s in slabs:
                s = self._as_key(s)
                ent = self._device.get(s)
                if ent is not None:
                    # a hint declares the WHOLE set hot: refresh resident
                    # members so promoting the missing ones cannot evict a
                    # sibling of the same set
                    ent.tick = self._next_tick()
                    continue
                if s in self._promoting or s in self._queued:
                    continue
                self._queued.add(s)
                todo.append(s)
                acct = self._tacct(s)
                if acct is not None:
                    acct["prefetch_enqueued"] += 1
            self.prefetch_enqueued += len(todo)
        for s in todo:
            self._pq.put(s)

    def _prefetch_loop(self) -> None:
        while True:
            s = self._pq.get()
            if s is None:
                return
            try:
                self.ensure(s, count_stall=False)
            except Exception:  # noqa: BLE001 - recorded by ensure
                # ensure recorded the cause in promotion_errors/last_error;
                # the thread survives, or every later miss would stall
                with self._cv:
                    self.prefetch_errors += 1
            finally:
                # dequeue only after the promotion ended: discarding
                # earlier would let wait_idle see both sets empty mid-build
                with self._cv:
                    self._queued.discard(s)
                    self._cv.notify_all()

    def seed_host(self, slab, rows) -> None:
        """Put rows in the host tier without touching the hit counters
        (the startup scan already read them)."""
        with self._cv:
            self._host_put(self._as_key(slab), rows)

    def warm_fill(self, slabs, est_bytes: int) -> list:
        """Promote slabs in order until the next would exceed the budget
        (``est_bytes``: one slab's footprint; every slab of a pool shares
        a shape class). Warmup: no stalls counted."""
        done = []
        for s in slabs:
            s = self._as_key(s)
            with self._cv:
                if s in self._device:
                    continue
                if (self._budget > 0
                        and self._device_bytes + est_bytes > self._budget):
                    break
            self.ensure(s, count_stall=False)
            done.append(s)
        return done

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until no promotion is queued or building."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._queued or self._promoting:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 0.05))
            return True

    # ----------------------------------------------------------------- admin

    def set_device_budget(self, nbytes: int) -> None:
        """Retune the device budget; shrinking evicts at once."""
        with self._cv:
            self._budget = int(nbytes)
            self._evict_to_fit(0)

    def resident_engines(self) -> list:
        with self._cv:
            return [ent.engine for ent in self._device.values()]

    def resident_items(self) -> list:
        """[(key, engine)] of every device-resident slab."""
        with self._cv:
            return [(k, ent.engine) for k, ent in self._device.items()]

    def resident_slabs(self) -> list:
        with self._cv:
            return sorted(self._device)

    def close(self) -> None:
        with self._cv:
            self._closed = True
        self._pq.put(None)
        self._thread.join(timeout=10)

    def stats(self) -> dict:
        with self._cv:
            out = {
                "num_slabs": sum(src.num_slabs
                                 for src, _fac in self._routes.values()),
                "device_resident": len(self._device),
                "host_resident": len(self._host),
                "device_bytes_used": self._device_bytes,
                "device_bytes_peak": self._device_bytes_peak,
                "device_budget_bytes": self._budget,
                "host_pool_slabs": self._host_cap,
                "host_pool_bytes": self._host_bytes_cap,
                "host_bytes_used": self._host_bytes,
                "resident_slabs": sorted(self._device),
                "pinned_slabs": sorted(self._pins),
                "promotions": self.promotions,
                "promotion_errors": self.promotion_errors,
                "last_error": self.last_error,
                "evictions": self.evictions,
                "host_evictions": self.host_evictions,
                "device_hits": self.device_hits,
                "host_hits": self.host_hits,
                "cold_reads": self.cold_reads,
                "overcommits": self.overcommits,
                "prefetch_enqueued": self.prefetch_enqueued,
                "prefetch_errors": self.prefetch_errors,
                "stream_stalls": self.stream_stalls,
                "stream_stall_seconds": round(self.stream_stall_seconds, 6),
            }
            if self._tenants:
                per = {}
                for t, acct in self._tenants.items():
                    d = dict(acct)
                    d["stream_stall_seconds"] = round(
                        d["stream_stall_seconds"], 6)
                    d["device_resident"] = sum(
                        1 for k in self._device
                        if isinstance(k, tuple) and k[0] == t)
                    d["host_resident"] = sum(
                        1 for k in self._host
                        if isinstance(k, tuple) and k[0] == t)
                    d["pinned"] = sum(
                        1 for k in self._pins
                        if isinstance(k, tuple) and k[0] == t)
                    per[t] = d
                out["tenants"] = per
            return out


class _StreamHandle:
    """A dispatched streaming batch: the queries (for escalation
    sub-batches and a degradation replay), the bounds table's lower
    bounds, the visited matrix, the slabs' in-flight sub-batches, the
    pinned slab set ``complete`` releases, and the recall plan (None =
    exact)."""

    __slots__ = ("queries", "n", "engine_name", "t0", "lb", "visited",
                 "subs", "pinned", "plan", "skip_cold", "seeds")

    def __init__(self, queries, n, engine_name, t0, plan=None, seeds=None):
        self.queries = queries
        self.n = n
        self.engine_name = engine_name
        self.t0 = t0
        self.lb = None
        self.visited = None
        self.subs = []
        self.pinned = set()
        self.plan = plan
        #: certified per-row init radii (serve/qcache.py; None =
        #: unseeded): the fold and every escalation sub-batch start from
        #: the same certified bound
        self.seeds = seeds
        #: dispatch's ADMITTED skip-cold decision (the drift guard may
        #: refuse the plan's ask); the fold follows the same decision
        self.skip_cold = False


class StreamingKnnEngine:
    """Engine over a ``SlabPool``: an index bigger than the device budget,
    bit-identical to a fully resident engine.

    The same ``dispatch`` / ``complete`` / ``query`` contract as
    ``ResidentKnnEngine`` (the batcher, the admission wrapper and the HTTP
    server drive it unchanged); ``emit="candidates"`` serves
    ``complete_candidates`` instead. The batcher's dispatch and completion
    workers may overlap one batch's escalation with the next batch's first
    wave: the pool lock and each slab engine's own lock serialize what
    must serialize. ``device=None`` is the card; ``device="cpu"`` runs the
    kernels' plain versions.
    """

    def __init__(self, path: str | None = None, *, points=None,
                 num_slabs: int = 0, k: int, device_slab_budget: int = 0,
                 host_pool_slabs: int = 0, host_pool_bytes: int = 0,
                 prefetch_depth: int = 1, num_shards: int = 1,
                 engine: str = "auto", bucket_size: int = 0,
                 max_radius: float = math.inf, max_batch: int = 1024,
                 min_batch: int = 8, merge: str = "auto",
                 query_buckets: int = 0, score_dtype: str = "f32",
                 id_offset: int = 0, emit: str = "final",
                 faults: FaultInjector | None = None,
                 source_url: str | None = None,
                 source_wire: str = "d16",
                 source_throttle_bps: float | None = None,
                 skip_cold_stall_limit: float = 0.25,
                 source: SlabSource | None = None,
                 pool: SlabPool | None = None,
                 tenant: str | None = None,
                 shared_plan_cache=None, pad_shard_rows: int = 0,
                 timers: PhaseTimers | None = None,
                 device=None, clock=time.perf_counter):
        from mpi_cuda_largescaleknn_torch.core.config import resolve_device
        from mpi_cuda_largescaleknn_torch.parallel.ring import resolve_engine
        from mpi_cuda_largescaleknn_torch.serve.engine import LaunchPlanCache
        from mpi_cuda_largescaleknn_torch.serve.frontend import (
            routing_cert_slack,
        )

        if emit not in ("final", "candidates"):
            raise ValueError(f"emit must be 'final' or 'candidates', "
                             f"got {emit!r}")
        if pool is not None and tenant is None:
            raise ValueError("a shared pool= needs a tenant= namespace "
                             "for this engine's (tenant, slab) keys")
        self.device = resolve_device(device)
        if source is not None:
            self._source = source
        else:
            self._source = SlabSource(path=path, points=points,
                                      url=source_url, num_slabs=num_slabs,
                                      wire=source_wire,
                                      throttle_bps=source_throttle_bps)
        self.num_slabs = self._source.num_slabs
        self.n_points = self._source.n_total
        self.dim = self._source.dim
        if self.n_points < 1:
            raise ValueError("streaming engine needs a non-empty index")
        self.k = int(k)
        self.id_offset = int(id_offset)
        self.emit = emit
        self.max_radius = float(max_radius)
        self.prefetch_depth = int(prefetch_depth)
        self.device_slab_budget = int(device_slab_budget)
        self.host_pool_slabs = int(host_pool_slabs)
        self.host_pool_bytes = int(host_pool_bytes)
        self.tenant = tenant
        self._clock = clock
        #: never holds host rows itself (the pool's tiers do)
        self.host_points = None
        #: shared accounting: every slab engine counts into these timers,
        #: so eviction never zeroes the /stats surface; a multi-tenant
        #: engine hands one timers and one plan cache to every tenant, so
        #: the tenant count never becomes the plan count
        self.timers = timers if timers is not None else PhaseTimers()
        self._plan_cache = (shared_plan_cache if shared_plan_cache
                            is not None else LaunchPlanCache())
        self.cert_slack = routing_cert_slack(self.dim)
        self._meta_lock = threading.Lock()
        self._engine_name: guarded_by("_meta_lock") = resolve_engine(engine)
        self._degraded_reason: guarded_by("_meta_lock") = None
        #: drift guard of the recall tier: recent (clock, cumulative stall
        #: seconds) samples; when the pool is ALREADY stalling above
        #: ``skip_cold_stall_limit`` (stalled share of wall time over the
        #: window) a ``stream_skip_cold`` plan is refused for the batch
        self.skip_cold_stall_limit = float(skip_cold_stall_limit)
        self._stall_ring: guarded_by("_meta_lock") = []
        self.skip_cold_refusals: guarded_by("_meta_lock") = 0
        self.num_shards = int(num_shards)
        max_slab = max(e - b for b, e in self._source.bounds)
        #: one shape class across the POOL: each slab engine's shards are
        #: padded to the largest slab's rows a shard (or a caller's class:
        #: the multi-tenant engine passes the max over every tenant)
        self._pad_shard = max(int(pad_shard_rows),
                              -(-max_slab // self.num_shards))
        self._engine_kw = dict(
            num_shards=self.num_shards, bucket_size=bucket_size,
            max_radius=max_radius, max_batch=max_batch,
            min_batch=min_batch, merge=merge, query_buckets=query_buckets,
            score_dtype=score_dtype, device=self.device)
        if pool is not None:
            self._pool = pool
            self._owns_pool = False
            self._pool.register(tenant, self._source, self._make_engine)
        else:
            # a standalone tenant-keyed engine registers its source under
            # its tenant only (every pool key is then (tenant, slab))
            self._pool = SlabPool(
                None if tenant is not None else self._source,
                self._make_engine,
                device_budget_bytes=device_slab_budget,
                host_pool_slabs=host_pool_slabs,
                host_pool_bytes=host_pool_bytes, faults=faults,
                clock=clock)
            self._owns_pool = True
            if tenant is not None:
                self._pool.register(tenant, self._source,
                                    self._make_engine)
        #: per-slab routing boxes: f64 lo/hi per non-empty slab, +inf lower
        #: bound for empty ones. The scan's rows seed the host tier
        aabbs = self._source.scan_aabbs(
            sink=lambda s, rows: self._pool.seed_host(self._pkey(s), rows))
        self.slab_aabbs = aabbs
        self._nonempty = np.array([a["count"] > 0 for a in aabbs], bool)
        self._slab_lo = np.array([a["lo"] if a["lo"] is not None
                                  else [np.inf] * self.dim for a in aabbs],
                                 np.float64).reshape(-1, self.dim)
        self._slab_hi = np.array([a["hi"] if a["hi"] is not None
                                  else [-np.inf] * self.dim for a in aabbs],
                                 np.float64).reshape(-1, self.dim)
        # promote the first non-empty slab and adopt its resolved config:
        # every sibling is built from the same knobs and shape class
        first = int(np.argmax(self._nonempty))
        t = self._pool.ensure(self._pkey(first), count_stall=False)
        self._template_slab = first
        self.max_batch = t.max_batch
        self.shape_buckets = list(t.shape_buckets)
        self.query_buckets = dict(t.query_buckets)
        self.query_buckets_setting = t.query_buckets_setting
        self.merge_mode = t.merge_mode
        self.score_dtype = t.score_dtype
        self.score_mode = t.score_mode
        self.sort_queries = t.sort_queries
        self.bucket_size = t.bucket_size
        self.slab_device_bytes = int(t.device_bytes)
        self.canonical_ties = t.canonical_ties
        self.process_index = 0
        self.process_count = 1

    # ---------------------------------------------------------- pool keying

    def _pkey(self, slab: int):
        """This engine's pool key of a local slab: a bare int in an owned
        one-index pool, (tenant, slab) in a shared pool."""
        return (self.tenant, int(slab)) if self.tenant is not None \
            else int(slab)

    def _pkeys(self, slabs) -> list:
        return [self._pkey(s) for s in slabs]

    def _resident_local(self) -> set:
        """This engine's device-resident LOCAL slab ids."""
        if self.tenant is None:
            return set(self._pool.resident_slabs())
        return {k[1] for k in self._pool.resident_slabs()
                if isinstance(k, tuple) and k[0] == self.tenant}

    def _my_engines(self) -> list:
        if self.tenant is None:
            return self._pool.resident_engines()
        return [e for k, e in self._pool.resident_items()
                if isinstance(k, tuple) and k[0] == self.tenant]

    # ------------------------------------------------------------ engine mgmt

    def _make_engine(self, slab: int, rows: np.ndarray, row_begin: int):
        """The pool's engine factory: one canonical-tie candidates engine
        a slab, global ids from the slab's first row, the shared timers
        and plan cache, the common shape class."""
        from mpi_cuda_largescaleknn_torch.serve.engine import (
            ResidentKnnEngine,
        )

        with self._meta_lock:
            engine_name = self._engine_name
        return ResidentKnnEngine(
            rows, self.k, engine=engine_name,
            id_offset=self.id_offset + int(row_begin), emit="candidates",
            timers=self.timers, plan_cache=self._plan_cache,
            pad_shard_rows=self._pad_shard, **self._engine_kw)

    @property
    def slab_pool(self) -> SlabPool:
        return self._pool

    @property
    def engine_name(self) -> str:
        with self._meta_lock:
            return self._engine_name

    @property
    def degraded_reason(self) -> str | None:
        with self._meta_lock:
            return self._degraded_reason

    def can_degrade(self) -> bool:
        """As the resident engine: only ``pallas_tiled`` on the CPU. On
        the card a failed promotion or launch raises and fails its
        request."""
        with self._meta_lock:
            return (self._engine_name == "pallas_tiled"
                    and self.device.type == "cpu")

    def degrade(self, reason: str) -> None:
        """Swap every resident slab engine (and every later promotion) to
        the twin ``tiled``, pool wide; raises on the card."""
        with self._meta_lock:
            if self._engine_name != "pallas_tiled" \
                    or self.device.type != "cpu":
                raise RuntimeError(
                    f"engine '{self._engine_name}' has no fallback on "
                    f"{self.device}")
            self._engine_name = "tiled"
            self._degraded_reason = reason
        for eng in self._my_engines():
            if eng.can_degrade():
                eng.degrade(reason)

    def set_launch_workers(self, n: int) -> None:
        """Nothing to resize: each slab engine's launch queue is its own
        CUDA stream (``ResidentKnnEngine.set_launch_workers``)."""

    def warmup(self) -> dict:
        """Build every shape bucket's plan ONCE (into the shared cache:
        every slab engine reuses them), then fill the rest of the device
        budget with slabs in row order. Returns the template's warmup dict
        plus the slabs warmed."""
        t = self._pool.ensure(self._pkey(self._template_slab),
                              count_stall=False)
        info = t.warmup()
        filled = self._pool.warm_fill(
            self._pkeys(s for s in range(self.num_slabs)
                        if self._nonempty[s] and s != self._template_slab),
            self.slab_device_bytes)
        info["warm_slabs"] = sorted(
            [self._template_slab]
            + [k[1] if isinstance(k, tuple) else k for k in filled])
        return info

    # ----------------------------------------------------------------- routing

    def _lower_bounds(self, q: np.ndarray) -> np.ndarray:
        """f64[n, S] squared lower-bound distance per (query, slab); +inf
        for empty slabs."""
        from mpi_cuda_largescaleknn_torch.utils.math import (
            aabb_lower_bound_dist2,
        )

        out = np.full((len(q), self.num_slabs), np.inf)
        ne = self._nonempty
        if ne.any() and len(q):
            out[:, ne] = aabb_lower_bound_dist2(
                q, self._slab_lo[ne], self._slab_hi[ne])
        return out

    def _wave1_want(self, q: np.ndarray):
        """The first wave's routing, shared by dispatch and the prefetcher
        so a hint never warms another slab set than the dispatch pins:
        each query wants its nearest-bounds slab PLUS every slab whose box
        contains it (a zero lower bound can never certify away). Returns
        (lb f64[n, S], want bool[n, S])."""
        lb = self._lower_bounds(q)
        first = np.argmin(lb, axis=1)
        reach = np.isfinite(lb[np.arange(len(q)), first])
        want = lb <= 0.0
        rows_r = np.nonzero(reach)[0]
        want[rows_r, first[rows_r]] = True
        return lb, want

    def prefetch_hint(self, queries) -> None:
        """Announce a LATER batch's rows: queue promotions of its first
        wave's slabs, so that batch finds them warm (the batcher calls
        this with the queued rows right after each dispatch)."""
        q = np.asarray(queries, np.float32).reshape(-1, self.dim)
        if len(q) == 0:
            return
        _lb, want = self._wave1_want(q)
        self.timers.count("prefetch_hints", 1)
        self._pool.prefetch(
            self._pkeys(np.nonzero(want.any(axis=0))[0].tolist()))

    # --------------------------------------------------------------- query API

    #: samples kept by the drift guard
    skip_cold_window = 64

    def _skip_cold_admit(self) -> bool:
        """Drift-aware admission of ``stream_skip_cold``: refuse the recall
        plan when the pool's stalled share of wall time over the sampled
        window is already above ``skip_cold_stall_limit`` (a pool that
        busy promoting is in traffic drift, where skipping loses recall
        without saving the churn). Counted in ``skip_cold_refusals``."""
        now = self._clock()
        _stalls, stall_s = self._pool.stall_totals(self.tenant)
        with self._meta_lock:
            ring = self._stall_ring
            ring.append((now, stall_s))
            if len(ring) > self.skip_cold_window:
                del ring[0]
            t0, s0 = ring[0]
            span = now - t0
            if len(ring) < 2 or span <= 0.0:
                return True  # no signal yet: admit
            if (stall_s - s0) / span > self.skip_cold_stall_limit:
                self.skip_cold_refusals += 1
                return False
            return True

    def _dispatch_sub(self, eng, q, rows, plan, seeds):
        """One slab's sub-batch of rows ``rows``: seeded, under a recall
        plan, or plain."""
        if seeds is not None:
            # a slab-local init slot (seed², -1) only displaces candidates
            # with d2 >= seed², strictly beyond the certified global k-th:
            # the fold pushes every such slot out
            return eng.dispatch(q[rows], seed_radius=seeds[rows])
        if plan is None:
            return eng.dispatch(q[rows])
        return eng.dispatch(q[rows], plan=plan)

    def dispatch(self, queries: np.ndarray, plan=None,
                 seed_radius=None) -> _StreamHandle:
        """The first wave of a streamed batch: route rows to their
        nearest-bounds slab plus every slab whose box holds them, PIN that
        slab set, promote any member not resident (a counted stall), and
        dispatch the slabs' sub-batches. Also queues the ``prefetch_depth``
        nearest slabs no row visits, the likely escalation targets.

        ``plan`` (serve/recall.py, None = exact) rides into each slab
        engine's dispatch; ``stream_skip_cold`` defers every cold slab of
        the wave but each row's nearest (always ensured, so every row gets
        k real candidates): deferred slabs warm in the background and meet
        the folded k-th distance in the escalation loop, where a slab
        still cold is skipped for recall instead of stalled on."""
        queries = np.ascontiguousarray(
            np.asarray(queries, np.float32).reshape(-1, self.dim))
        n = len(queries)
        # certified radius seeds (serve/qcache.py): exact tier only
        seeds = None
        if seed_radius is not None and plan is None:
            seeds = np.asarray(seed_radius, np.float32).reshape(-1)
            if len(seeds) != n:
                raise ValueError(
                    f"seed_radius has {len(seeds)} rows for {n} queries")
            if not np.any(np.isfinite(seeds)):
                seeds = None
        handle = _StreamHandle(queries, n, self.engine_name, self._clock(),
                               plan=plan, seeds=seeds)
        if n == 0:
            return handle
        lb, want = self._wave1_want(queries)
        visited = np.zeros((n, self.num_slabs), bool)
        handle.skip_cold = (plan is not None and plan.stream_skip_cold
                            and self._skip_cold_admit())
        if handle.skip_cold:
            resident = self._resident_local()
            first = np.argmin(lb, axis=1)
            must = set(int(s) for i, s in enumerate(first)
                       if np.isfinite(lb[i, s]))
            deferred = [s for s in np.nonzero(want.any(axis=0))[0].tolist()
                        if s not in resident and s not in must]
            if deferred:
                want[:, deferred] = False
                self._pool.prefetch(self._pkeys(deferred))
        wave = [(s, np.nonzero(want[:, s])[0])
                for s in range(self.num_slabs) if want[:, s].any()]
        sids = [s for s, _rows in wave]
        self._pool.pin(self._pkeys(sids))
        handle.pinned.update(sids)
        # hand the whole wave to the promotion thread first: a cold wave
        # of several slabs then builds one here while the next builds
        # there
        self._pool.prefetch(self._pkeys(sids))
        try:
            for s, rows in wave:
                eng = self._pool.ensure(self._pkey(s))
                sub = self._dispatch_sub(eng, queries, rows, plan, seeds)
                handle.subs.append((s, rows, eng, sub))
                visited[rows, s] = True
        except BaseException:
            # a failed promotion or dispatch must not leak this batch's
            # pins: leaked pins would make the slabs unevictable
            self._pool.unpin(self._pkeys(handle.pinned))
            handle.pinned = set()
            raise
        handle.lb, handle.visited = lb, visited
        if self.prefetch_depth > 0:
            # escalation insurance: the unvisited slabs nearest ANY row
            rest = np.where(want.any(axis=0), np.inf, lb.min(axis=0))
            order = np.argsort(rest, kind="stable")
            depth = [int(s) for s in order[:self.prefetch_depth]
                     if np.isfinite(rest[s])]
            if depth:
                self._pool.prefetch(self._pkeys(depth))
        return handle

    def _complete_fold(self, handle: _StreamHandle):
        """Fold the wave's candidate rows; escalate uncertified (query,
        slab) pairs until certification closes (a miss stalls, it never
        drops a slab). Returns the folded (d2[n, k], idx[n, k])."""
        from mpi_cuda_largescaleknn_torch.serve.frontend import (
            fold_candidates,
        )

        n, k = handle.n, self.k
        cur_d2 = np.full((n, k), np.inf, np.float32)
        cur_idx = np.full((n, k), -1, np.int32)
        seeds = handle.seeds
        if seeds is not None:
            # certified seeds bound the fold's running k-th from the first
            # wave on: r2 starts at seed² (> the true k-th², strictly), so
            # escalation promotes fewer slabs and the answer is the same
            cur_d2[:] = (seeds * seeds)[:, None]
        q, lb, visited = handle.queries, handle.lb, handle.visited
        plan = handle.plan
        # recall plan: shave the escalation margin, and never stall an
        # escalation wave on a cold slab under skip-cold
        slack = float(plan.route_slack) if plan is not None else 0.0
        skip_cold = handle.skip_cold
        lb_safe = lb * (1.0 - self.cert_slack)
        reachable = np.isfinite(lb_safe)
        subs = handle.subs
        try:
            wave = 1
            while True:
                for s, rows, eng, sub in subs:
                    d2p, idxp = eng.complete_candidates(sub)
                    fold_candidates(cur_d2, cur_idx, rows, d2p, idxp, k)
                r2 = cur_d2[:, k - 1].astype(np.float64)
                need = (~visited) & reachable & (
                    lb_safe <= r2[:, None] * (1.0 - slack))
                if not need.any():
                    break
                sids = [s for s in range(self.num_slabs) if need[:, s].any()]
                if skip_cold:
                    resident = self._resident_local()
                    cold = [s for s in sids if s not in resident]
                    if cold:
                        # the recall trade: these bounds COULD beat the
                        # k-th distance but the slab is not resident; give
                        # the pairs up, count them, warm the slabs for the
                        # next batch
                        self.timers.count("stream_skipped_promotions",
                                          len(cold))
                        for s in cold:
                            visited[need[:, s], s] = True
                        self._pool.prefetch(self._pkeys(cold))
                        sids = [s for s in sids if s in resident]
                        if not sids:
                            subs = []
                            continue
                if wave == 1:
                    self.timers.count("stream_escalations",
                                      int(need.any(axis=1).sum()))
                self.timers.count("stream_escalation_waves", 1)
                wave += 1
                new = [s for s in sids if s not in handle.pinned]
                if new:
                    self._pool.pin(self._pkeys(new))
                    handle.pinned.update(new)
                    self._pool.prefetch(self._pkeys(new))
                subs = []
                for s in sids:
                    rows = np.nonzero(need[:, s])[0]
                    eng = self._pool.ensure(self._pkey(s))
                    subs.append((s, rows, eng, self._dispatch_sub(
                        eng, q, rows, plan, seeds)))
                    visited[rows, s] = True
        finally:
            self._pool.unpin(self._pkeys(handle.pinned))
            handle.pinned = set()
        self.timers.hist("stream_batch_seconds").record(
            self._clock() - handle.t0)
        self.timers.count("stream_batches", 1)
        return cur_d2, cur_idx

    def complete(self, handle: _StreamHandle):
        """(dists f32[n], idx i32[n, k]), bit-identical to a fully
        resident engine of the same knobs (the canonical fold over
        canonical-tie slab rows)."""
        if handle.n == 0:
            return (np.zeros(0, np.float32),
                    np.zeros((0, self.k), np.int32))
        if self.emit == "candidates":
            raise RuntimeError(
                "emit='candidates' streaming engines return full candidate"
                " rows — use complete_candidates")
        d2, idx = self._complete_fold(handle)
        return np.sqrt(d2[:, self.k - 1]), idx

    def complete_candidates(self, handle: _StreamHandle):
        """The folded full candidate rows (dist2[n, k], idx[n, k]) over
        this engine's slabs."""
        if handle.n == 0:
            return (np.full((0, self.k), np.inf, np.float32),
                    np.full((0, self.k), -1, np.int32))
        if self.emit != "candidates":
            raise RuntimeError(
                "engine was built with emit='final' — construct with "
                "emit='candidates' for the candidate-row contract")
        return self._complete_fold(handle)

    def query(self, queries: np.ndarray, plan=None, seed_radius=None):
        return self.complete(self.dispatch(queries, plan=plan,
                                           seed_radius=seed_radius))

    def refetch_exact(self, queries):
        """A routed pod's exact re-fetch: the candidate rows, byte-equal to
        any earlier batch holding these rows (the streaming fold is
        deterministic for each query row: a commutative fold closed by
        certification), so re-asking costs a promotion at worst, never
        bits."""
        return self.complete_candidates(self.dispatch(queries))

    def close(self) -> None:
        if self._owns_pool:
            self._pool.close()

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict:
        pool = self._pool.stats()
        cache = self._plan_cache.stats()
        if self.tenant is None:
            my_resident = pool["device_resident"]
        else:
            mine = pool.get("tenants", {}).get(self.tenant, {})
            my_resident = int(mine.get("device_resident", 0))
        with self._meta_lock:
            engine_name = self._engine_name
            degraded_reason = self._degraded_reason
            skip_cold_refusals = self.skip_cold_refusals
        return {
            "engine": engine_name,
            "merge": self.merge_mode,
            "score_dtype": self.score_dtype,
            "score_mode": self.score_mode,
            "dim": self.dim,
            "degraded_reason": degraded_reason,
            "n_points": self.n_points,
            "k": self.k,
            "num_shards": self.num_shards,
            "multihost": False,
            "process_index": self.process_index,
            "process_count": self.process_count,
            "my_positions": list(range(self.num_shards)),
            "row_offset": self.id_offset,
            "emit": self.emit,
            "canonical_ties": self.canonical_ties,
            "max_radius": (None if math.isinf(self.max_radius)
                           else self.max_radius),
            # one box a SLAB (the streaming engine's routing granularity)
            "shard_bounds": self.slab_aabbs,
            "device_bytes": self.slab_device_bytes * my_resident,
            "max_batch": self.max_batch,
            "bucket_size": self.bucket_size,
            "shape_buckets": list(self.shape_buckets),
            # pool-wide: the shared plan cache's build count is the number
            # that stays flat across slab churn
            "compiled_shapes": cache["shapes"],
            "compile_count": cache["compiles"],
            "executable_cache": cache,
            "query_buckets": {str(qv): b for qv, b in
                              sorted(self.query_buckets.items())},
            "sort_queries": self.sort_queries,
            "tiles_executed": self.timers.counter("tiles_executed"),
            "tiles_skipped": self.timers.counter("tiles_skipped"),
            "tiles_executed_mxu": self.timers.counter("tiles_executed_mxu"),
            "tiles_skipped_mxu": self.timers.counter("tiles_skipped_mxu"),
            "tiles_executed_vpu": self.timers.counter("tiles_executed_vpu"),
            "tiles_skipped_vpu": self.timers.counter("tiles_skipped_vpu"),
            "fetch_bytes": self.timers.counter("fetch_bytes"),
            "result_rows": self.timers.counter("result_rows"),
            # the tiers: residency, budget, hits and misses, promotions
            # and evictions, stalls
            "slab_pool": dict(
                pool,
                slab_device_bytes=self.slab_device_bytes,
                prefetch_depth=self.prefetch_depth,
                prefetch_hints=self.timers.counter("prefetch_hints"),
                **({} if self.tenant is None
                   else {"tenant": self.tenant})),
            "streaming": {
                "num_slabs": self.num_slabs,
                "batches": self.timers.counter("stream_batches"),
                "escalations": self.timers.counter("stream_escalations"),
                "escalation_waves":
                    self.timers.counter("stream_escalation_waves"),
                "skipped_promotions":
                    self.timers.counter("stream_skipped_promotions"),
                "skip_cold_refusals": skip_cold_refusals,
                "skip_cold_stall_limit": self.skip_cold_stall_limit,
            },
            "timers": self.timers.report(),
        }
