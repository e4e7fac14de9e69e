"""Dynamic micro-batching: coalesce a request stream into engine batches.

The copy of the JAX package's ``serve/batcher.py``. TPU-KNN's throughput
argument (arXiv:2206.14286) cuts against serving one query at a time: the
engine's fixed-shape launch plans want the widest batch the
latency budget allows. This batcher sits between N concurrent callers and
the single-threaded engine: requests queue; the worker flushes when the
queued rows reach ``max_batch`` OR the oldest request has waited
``max_delay_s`` — the classic throughput/latency dial. A flush concatenates
whole requests (never splitting one across engine calls keeps demux
trivial), pads to the smallest covering shape bucket inside the engine, and
demuxes per-request slices back to each caller. The engine may Morton-sort
the flushed batch internally for query locality (serve/engine.py), but it
un-permutes at ``complete`` — so the offset demux here stays position-based
and order-oblivious, and coalescing MORE concurrent requests per flush
actively helps: the sort regroups rows from different callers into
spatially tight query buckets the traversal prunes harder.

Pipelining (``pipeline_depth > 1``): when ``query_fn`` exposes the engine's
``dispatch``/``complete`` split, flushes run on a DISPATCH worker that
launches batch t+1's device traversal while a COMPLETION worker blocks on
batch t's fetch, merges, and demuxes — device compute overlaps host
staging/merge instead of serializing behind it. A semaphore bounds the
batches in flight between dispatch and demux at ``pipeline_depth``; the
time the dispatch worker spends blocked on that bound is the pipeline's
stall metric (recorded in the shared obs/timers.py histogram geometry).
Completion order is FIFO in batch order, so per-request demux slices can
never cross batches. ``pipeline_depth=1`` (the default) keeps the original
single-worker serialized path bit-for-bit.

Deadlines: a request whose deadline passed while queued is completed with
``DeadlineExceeded`` instead of burning engine time on an answer nobody is
waiting for.

Tiered and multi-index engines (serve/slabpool.py, serve/tenancy.py): a
request's ``tenant`` joins the coalescing key, so one engine batch never
mixes two indexes, and after each dispatch the queued rows are announced
to the engine's ``prefetch_hint`` (grouped by tenant), so the slab pool
promotes the next batch's slabs under the batch in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.obs.timers import LatencyHistogram
from mpi_cuda_largescaleknn_torch.serve.admission import DeadlineExceeded


@dataclass
class _Request:
    queries: np.ndarray
    deadline: float | None
    enqueued: float
    #: recall-SLO execution plan (serve/recall.py RecallPlan; None = exact).
    #: Requests only coalesce with plan-compatible neighbors — see
    #: ``_plan_key`` / ``_take_batch``.
    plan: object | None = None
    #: tenant namespace (serve/tenancy.py; None = single-index serving).
    #: Joins the coalescing key — one engine batch never mixes indexes.
    tenant: str | None = None
    #: certified per-row init radii (serve/qcache.py seed_for; None =
    #: unseeded). f32[rows]; +inf rows are unseeded. Exact-tier only.
    seeds: np.ndarray | None = None
    done: threading.Event = field(default_factory=threading.Event)
    result: tuple | None = None
    error: Exception | None = None

    @property
    def rows(self) -> int:
        return len(self.queries)


def _plan_key(req: _Request):
    """The coalescing key: requests whose plans execute identical bits ON
    THE SAME INDEX may share an engine batch. The plan part is None (exact,
    its own key) or the plan's ``batch_key()``, which deliberately EXCLUDES
    ``recall_target`` — two requests on the same plan at different targets
    coalesce. The tenant part keeps multi-index traffic in per-tenant
    sub-batches (None for single-index serving, so legacy keys are
    unchanged tuples-of-None)."""
    return (req.tenant,
            None if req.plan is None else req.plan.batch_key())


class DynamicBatcher:
    """Worker thread(s) draining a request queue through ``query_fn``.

    ``query_fn(queries f32[n,3]) -> (dists f32[n], neighbors i32[n,k])`` —
    typically ``admission.GracefulQueryFn`` wrapping a ResidentKnnEngine.
    With ``pipeline_depth > 1`` the wrapper's ``dispatch``/``complete``
    split is used instead (falling back to the serialized path when the
    callable lacks it — e.g. test doubles that are plain functions).
    """

    def __init__(self, query_fn, *, max_batch: int,
                 max_delay_s: float = 0.002, timers=None,
                 pipeline_depth: int = 1, min_batch: int | None = None,
                 dim: int | None = None, qcache=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._query_fn = query_fn
        #: serve/qcache.py QueryCache (None = reuse layer off): submit()
        #: resolves every row through it — exact hits are served from the
        #: LRU with zero device work, duplicate rows join the in-flight
        #: owner, and exact-tier misses dispatch with certified radius
        #: seeds. When set, query_fn must accept ``seed_radius=``.
        self.qcache = qcache
        #: point dimensionality for normalizing flat submit() inputs;
        #: taken from the query_fn's engine/fanout when not given (3 as
        #: the last-resort legacy default)
        self.dim = int(dim) if dim else int(getattr(
            getattr(query_fn, "engine", None), "dim", 0)
            or getattr(query_fn, "dim", 0) or 3)
        self.max_batch = int(max_batch)
        #: stall-aware flush floor: while the device pipeline is BUSY (but
        #: not full), a deadline flush is worth dispatching only for at
        #: least this many rows — narrower slivers keep coalescing until
        #: the pipe drains. The default (= max_batch) reproduces the old
        #: batch-while-busy policy exactly (deadline flushes only on an
        #: idle pipe); the server passes the engine's narrowest shape
        #: bucket, which is what the padded program pays for anyway.
        self.min_batch = int(min_batch) if min_batch else self.max_batch
        self.max_delay_s = float(max_delay_s)
        self._timers = timers
        self.pipeline_depth = int(pipeline_depth)
        self.pipelined = (self.pipeline_depth > 1
                          and hasattr(query_fn, "dispatch")
                          and hasattr(query_fn, "complete"))
        #: streaming engines (serve/slabpool.py) expose ``prefetch_hint``:
        #: after each dispatch the worker announces the still-QUEUED rows
        #: — the next batch's content — so the engine's slab pool promotes
        #: that batch's routed slab set under the in-flight batch's
        #: compute (the graceful wrapper is looked through: hints go to
        #: the engine, not the degradation shim)
        self._prefetch_fn = (
            getattr(query_fn, "prefetch_hint", None)
            or getattr(getattr(query_fn, "engine", None),
                       "prefetch_hint", None))
        self._cond = threading.Condition()
        # queue + counters shared between submitter threads and the
        # dispatch/completion workers: every access is under _cond
        # (proven by lskcheck's guarded_by pass)
        self._queue: guarded_by("_cond") = deque()
        self._queued_rows: guarded_by("_cond") = 0
        self._shutdown: guarded_by("_cond") = False
        self.batches: guarded_by("_cond") = 0
        self.rows_served: guarded_by("_cond") = 0
        self.rows_expired: guarded_by("_cond") = 0
        self.flush_full: guarded_by("_cond") = 0
        self.flush_deadline: guarded_by("_cond") = 0
        # recall-SLO tier accounting: batches/rows that executed under an
        # approximate plan (subset of batches/rows_served)
        self.batches_approx: guarded_by("_cond") = 0
        self.rows_served_approx: guarded_by("_cond") = 0
        # pipeline occupancy/stall accounting (under _cond); the stall
        # histogram shares the loadgen/server bucket geometry so the three
        # render identical /metrics buckets
        self._inflight_batches: guarded_by("_cond") = 0
        self._inflight_rows: guarded_by("_cond") = 0
        self.dispatch_stalls: guarded_by("_cond") = 0
        self.dispatch_stall_seconds: guarded_by("_cond") = 0.0
        self.prefetch_hint_errors: guarded_by("_cond") = 0
        self.stall_hist = (timers.hist("pipeline_stall_seconds")
                           if timers is not None else LatencyHistogram())
        # time spent blocked inside query_fn.complete (a streaming
        # engine's escalation waves included)
        self.complete_hist = (timers.hist("batch_complete_seconds")
                              if timers is not None else LatencyHistogram())
        self._workers: list[threading.Thread] = []
        if self.pipelined:
            self._inflight: queue.Queue = queue.Queue()
            self._slots = threading.Semaphore(self.pipeline_depth)
            self._workers = [
                threading.Thread(target=self._run_dispatch, daemon=True,
                                 name="knn-batcher-dispatch"),
                threading.Thread(target=self._run_complete, daemon=True,
                                 name="knn-batcher-complete"),
            ]
        else:
            self._workers = [threading.Thread(target=self._run, daemon=True,
                                              name="knn-batcher")]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------ submit

    def submit(self, queries: np.ndarray, timeout_s: float | None = None,
               plan=None, tenant: str | None = None):
        """Block until the batch containing ``queries`` executes; returns
        ``(dists, neighbors)`` or raises the request's error. ``plan``
        (serve/recall.py RecallPlan, None = exact) rides the request and
        restricts coalescing to plan-compatible neighbors — mixed-SLO
        traffic splits into per-plan sub-batches instead of forcing the
        strictest plan on everyone. ``tenant`` (serve/tenancy.py, None =
        single-index) does the same per index: a flush never mixes two
        tenants' rows in one engine batch.

        With a query cache attached (``qcache``), every row first resolves
        through the reuse tiers: an exact HIT is answered from the LRU
        (byte-identical, zero device work), a duplicate of an in-flight
        row JOINs its owner's entry, and the remaining rows dispatch as
        this request's own sub-batch — seeded with certified init radii
        on the exact tier. An all-hit request never touches the queue."""
        # normalize to [n, dim] rows (flat inputs carry n*dim floats — the
        # legacy direct-caller contract, now D-generic via self.dim)
        queries = np.asarray(queries, np.float32).reshape(-1, self.dim)
        qc = self.qcache
        if qc is None or len(queries) == 0:
            return self._submit_rows(queries, timeout_s, plan, tenant, None)
        n = len(queries)
        plan_token = None if plan is None else plan.batch_key()
        actions = qc.begin(queries, plan_token, tenant)
        own_idx = [i for i, a in enumerate(actions) if a[0] == "own"]
        owned_keys = [actions[i][1] for i in own_idx]
        rows: list = [None] * n
        try:
            if own_idx:
                sub_q = queries[own_idx] if len(own_idx) < n else queries
                seeds = qc.seed_for(sub_q, tenant) if plan is None else None
                outs = self._submit_rows(sub_q, timeout_s, plan, tenant,
                                         seeds)
                # publish BEFORE waiting on other owners' entries: owners
                # that publish before they park can never deadlock
                qc.publish(owned_keys, outs, sub_q, plan_token, tenant)
                if len(own_idx) == n:
                    return outs  # pure miss: no reassembly needed
                for j, i in enumerate(own_idx):
                    rows[i] = tuple(a[j] for a in outs)
        except Exception as e:  # noqa: BLE001 - joiners must not hang
            qc.abort(owned_keys, e)
            raise
        grace = None if timeout_s is None else timeout_s + 30.0
        retry = []
        for i, a in enumerate(actions):
            if a[0] == "hit":
                rows[i] = a[1]
            elif a[0] == "join":
                if not a[1].event.wait(grace):
                    raise DeadlineExceeded(
                        "deduplicated row stuck behind its in-flight owner")
                if a[1].error is not None:
                    # owner failed: retry the row as our own sub-batch,
                    # bypassing the cache (the aborted entries are gone,
                    # and a re-join could chain onto another failing owner)
                    retry.append(i)
                else:
                    rows[i] = a[1].result
        if retry:
            outs = self._submit_rows(queries[retry], timeout_s, plan,
                                     tenant, None)
            for j, i in enumerate(retry):
                rows[i] = tuple(a[j] for a in outs)
        for i, a in enumerate(actions):
            if a[0] == "local":
                rows[i] = rows[a[1]]
        return tuple(np.stack([r[c] for r in rows])
                     for c in range(len(rows[0])))

    def _submit_rows(self, queries: np.ndarray,
                     timeout_s: float | None, plan, tenant,
                     seeds: np.ndarray | None):
        """Enqueue one device sub-batch and block for its result — the
        pre-cache submit path, verbatim."""
        now = time.monotonic()
        req = _Request(queries=queries, enqueued=now,
                       deadline=(now + timeout_s) if timeout_s else None,
                       plan=plan, tenant=tenant, seeds=seeds)
        with self._cond:
            if self._shutdown:
                raise RuntimeError("batcher is shut down")
            self._queue.append(req)
            self._queued_rows += req.rows
            self._cond.notify_all()
        # grace beyond the deadline: the worker completes expired requests
        # with DeadlineExceeded itself; the extra wait covers an in-flight
        # engine call that started before the deadline passed
        wait = None if timeout_s is None else timeout_s + 30.0
        if not req.done.wait(wait):
            raise DeadlineExceeded("request stuck in batcher")
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------------ worker

    def _take_batch(self) -> list[_Request] | None:
        """Wait for a flushable batch; None on shutdown.

        Batch-while-busy, stall-aware: a full queue (``max_batch`` rows)
        always flushes. The ``max_delay_s`` deadline flush fires when the
        pipe is idle, or — pipelined, with a free slot already reserved by
        the dispatch worker — when at least ``min_batch`` rows are queued:
        a sliver narrower than the engine's narrowest shape bucket cannot
        start any sooner than the in-flight work it would queue behind, so
        it keeps accumulating until the device frees up (the completion
        worker notifies). The dispatch worker acquires its pipeline slot
        BEFORE calling this, so while the pipe is FULL nothing is popped at
        all and late arrivals coalesce into the stalled batch instead of
        queueing behind it.
        """
        with self._cond:
            while True:
                if self._shutdown and not self._queue:
                    return None
                if self._queue:
                    oldest = self._queue[0]
                    flush_at = oldest.enqueued + self.max_delay_s
                    now = time.monotonic()
                    busy_ok = (self._inflight_batches == 0
                               or (self.pipelined
                                   and self._queued_rows >= self.min_batch))
                    if (self._queued_rows >= self.max_batch
                            or (now >= flush_at and busy_ok)
                            or self._shutdown):
                        break
                    self._cond.wait((flush_at - now) if busy_ok else None)
                else:
                    self._cond.wait()
            # pop whole requests while they fit; a single over-wide request
            # (> max_batch rows) was rejected upstream by admission sizing,
            # but guard anyway by always taking at least one. Plan-keyed
            # sub-batching: only coalesce while the next request shares the
            # head's plan batch_key — and never skip over a queued request
            # (strict FIFO: a mixed-SLO queue flushes as consecutive
            # per-plan runs, so no plan can starve another)
            batch = [self._queue.popleft()]
            rows = batch[0].rows
            pkey = _plan_key(batch[0])
            while (self._queue
                   and rows + self._queue[0].rows <= self.max_batch
                   and _plan_key(self._queue[0]) == pkey):
                r = self._queue.popleft()
                batch.append(r)
                rows += r.rows
            self._queued_rows -= rows
            self.batches += 1
            if batch[0].plan is not None:
                self.batches_approx += 1
            if rows >= self.max_batch:
                self.flush_full += 1
            else:
                self.flush_deadline += 1
            return batch

    def _split_expired(self, batch: list[_Request]) -> list[_Request]:
        """Fail deadline-expired requests now; return the live remainder."""
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                with self._cond:
                    self.rows_expired += r.rows
                r.error = DeadlineExceeded(
                    f"deadline passed after {now - r.enqueued:.3f}s in queue")
                r.done.set()
            else:
                live.append(r)
        return live

    @staticmethod
    def _deliver(live: list[_Request], outs: tuple) -> None:
        """Offset-demux every array of the result tuple per request:
        ``(dists, neighbors)`` for engines, ``(dists, neighbors, exact)``
        for a routed pod's fan-out (the per-row exactness mask under
        degraded serving)."""
        off = 0
        for r in live:
            r.result = tuple(a[off:off + r.rows] for a in outs)
            off += r.rows
            r.done.set()

    @staticmethod
    def _fail(live: list[_Request], err: Exception) -> None:
        for r in live:
            r.error = err
            r.done.set()

    @staticmethod
    def _merged_seeds(live: list[_Request]) -> np.ndarray | None:
        """Concatenated per-row init radii for a flush, or None when no
        request in it carries seeds (the common case — and the ONLY case
        for legacy/test-double query_fns, which are never handed a
        ``seed_radius`` kwarg they don't know). Unseeded requests pad
        with +inf rows — the engine treats +inf as its static radius."""
        if all(r.seeds is None for r in live):
            return None
        parts = [r.seeds if r.seeds is not None
                 else np.full(r.rows, np.inf, np.float32) for r in live]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    # -------------------------------------------------- serialized (depth 1)

    def _run(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            live = self._split_expired(batch)
            if not live:
                continue
            try:
                t0 = time.perf_counter()
                merged = (live[0].queries if len(live) == 1 else
                          np.concatenate([r.queries for r in live]))
                # exact single-index requests call the legacy single-arg
                # form so plain test doubles (and the pre-tier wire) stay
                # compatible; tenant/plan kwargs only appear when set
                plan, tenant = live[0].plan, live[0].tenant
                kw = {}
                seeds = self._merged_seeds(live)
                if seeds is not None:
                    kw["seed_radius"] = seeds
                if tenant is not None:
                    outs = self._query_fn(merged, plan=plan, tenant=tenant,
                                          **kw)
                elif plan is None:
                    outs = self._query_fn(merged, **kw)
                else:
                    outs = self._query_fn(merged, plan=plan, **kw)
                if self._timers is not None:
                    self._timers.hist("batch_exec_seconds").record(
                        time.perf_counter() - t0)
                self._deliver(live, outs)
                with self._cond:
                    self.rows_served += len(merged)
                    if plan is not None:
                        self.rows_served_approx += len(merged)
            except Exception as e:  # noqa: BLE001 - delivered per request
                self._fail(live, e)

    # -------------------------------------------------- pipelined (depth > 1)

    def _wait_for_work(self) -> bool:
        """Park until at least one request is queued; False on shutdown
        with an empty queue."""
        with self._cond:
            while not self._queue:
                if self._shutdown:
                    return False
                self._cond.wait()
            return True

    def _run_dispatch(self):
        """Flush loop: launch device work, hand futures to the completer.

        Stall-aware ordering: the pipeline slot is reserved BEFORE a batch
        is popped. When ``pipeline_depth`` batches are already between
        dispatch and demux the worker blocks here (recording stall time)
        with the requests still IN the queue — so they keep coalescing
        toward a full batch, and deadline-expired ones are failed at pop
        time instead of going stale behind the semaphore. The old policy
        popped first and stalled holding a batch whose width was frozen.
        The bound itself is unchanged — it is what keeps a
        fast producer from piling unmerged device results without limit.
        """
        while True:
            if not self._wait_for_work():
                # FIFO sentinel: the completer drains everything already
                # dispatched, then exits — a clean pipeline drain
                self._inflight.put(None)
                return
            if not self._slots.acquire(blocking=False):
                t0 = time.perf_counter()
                self._slots.acquire()
                stall = time.perf_counter() - t0
                self.stall_hist.record(stall)
                with self._cond:
                    self.dispatch_stalls += 1
                    self.dispatch_stall_seconds += stall
            batch = self._take_batch()
            if batch is None:
                self._slots.release()
                self._inflight.put(None)
                return
            live = self._split_expired(batch)
            if not live:
                self._slots.release()
                continue
            merged = (live[0].queries if len(live) == 1 else
                      np.concatenate([r.queries for r in live]))
            with self._cond:
                self._inflight_batches += 1
                self._inflight_rows += len(merged)
                inflight = self._inflight_batches
            if self._timers is not None:
                self._timers.gauge("pipeline_inflight_batches", inflight)
            try:
                t0 = time.perf_counter()
                plan, tenant = live[0].plan, live[0].tenant
                kw = {}
                seeds = self._merged_seeds(live)
                if seeds is not None:
                    kw["seed_radius"] = seeds
                if tenant is not None:
                    handle = self._query_fn.dispatch(merged, plan=plan,
                                                     tenant=tenant, **kw)
                elif plan is None:
                    handle = self._query_fn.dispatch(merged, **kw)
                else:
                    handle = self._query_fn.dispatch(merged, plan=plan, **kw)
            except Exception as e:  # noqa: BLE001 - delivered per request
                self._fail(live, e)
                with self._cond:
                    self._inflight_batches -= 1
                    self._inflight_rows -= len(merged)
                    inflight = self._inflight_batches
                    self._cond.notify_all()
                if self._timers is not None:
                    self._timers.gauge("pipeline_inflight_batches", inflight)
                self._slots.release()
                continue
            self._inflight.put((live, len(merged), handle, t0))
            self._announce_prefetch()

    def _announce_prefetch(self):
        """Announce the queued rows — the NEXT batch's likely content —
        to a streaming engine's prefetcher right after a dispatch, so
        slab promotions overlap the batch just launched
        (serve/slabpool.py). Advisory only: a hint failure is counted,
        never allowed to fail the dispatched batch."""
        if self._prefetch_fn is None:
            return
        with self._cond:
            if not self._queue:
                return
            # group by tenant: each index's prefetcher should only see its
            # own rows (single-index queues collapse to one None group)
            groups, rows = {}, 0
            for r in self._queue:
                if rows + r.rows > self.max_batch:
                    break
                groups.setdefault(r.tenant, []).append(r.queries)
                rows += r.rows
        for tenant, pending in groups.items():
            try:
                merged = (pending[0] if len(pending) == 1
                          else np.concatenate(pending))
                if tenant is None:
                    self._prefetch_fn(merged)
                else:
                    self._prefetch_fn(merged, tenant=tenant)
            except Exception:  # noqa: BLE001 - advisory; counted below
                with self._cond:
                    self.prefetch_hint_errors += 1

    def _run_complete(self):
        """Completion loop: block on the oldest in-flight batch, demux.

        FIFO order means a batch's demux can start the moment ITS device
        work lands, while later batches are still traversing — and request
        ordering within a batch is preserved by the offset demux.
        """
        while True:
            item = self._inflight.get()
            if item is None:
                return
            live, rows, handle, t0 = item
            try:
                tc = time.perf_counter()
                outs = self._query_fn.complete(handle)
                self.complete_hist.record(time.perf_counter() - tc)
                if self._timers is not None:
                    self._timers.hist("batch_exec_seconds").record(
                        time.perf_counter() - t0)
                self._deliver(live, outs)
                with self._cond:
                    self.rows_served += rows
                    if live[0].plan is not None:
                        self.rows_served_approx += rows
            except Exception as e:  # noqa: BLE001 - delivered per request
                self._fail(live, e)
            finally:
                with self._cond:
                    self._inflight_batches -= 1
                    self._inflight_rows -= rows
                    inflight = self._inflight_batches
                    # wake a dispatch worker parked on batch-while-busy: the
                    # device freed a slot, so a deadline flush is allowed now
                    self._cond.notify_all()
                if self._timers is not None:
                    self._timers.gauge("pipeline_inflight_batches", inflight)
                self._slots.release()

    # ------------------------------------------------------------------- admin

    def queue_depth_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def inflight_rows(self) -> int:
        """Rows dispatched on the device but not yet demuxed (0 when
        serialized — the single worker holds no futures between flushes)."""
        with self._cond:
            return self._inflight_rows

    def inflight_batches(self) -> int:
        with self._cond:
            return self._inflight_batches

    def stats(self) -> dict:
        with self._cond:
            return {
                "batches": self.batches,
                "rows_served": self.rows_served,
                "rows_expired": self.rows_expired,
                "flush_full": self.flush_full,
                "flush_deadline": self.flush_deadline,
                "batches_approx": self.batches_approx,
                "rows_served_approx": self.rows_served_approx,
                "queue_rows": self._queued_rows,
                "mean_batch_rows": round(
                    self.rows_served / self.batches, 2) if self.batches else 0,
                "pipeline_depth": self.pipeline_depth,
                "pipelined": self.pipelined,
                "min_batch": self.min_batch,
                "inflight_batches": self._inflight_batches,
                "inflight_rows": self._inflight_rows,
                "dispatch_stalls": self.dispatch_stalls,
                "dispatch_stall_seconds": round(
                    self.dispatch_stall_seconds, 6),
                "prefetch_hint_errors": self.prefetch_hint_errors,
                "complete_seconds_total": round(
                    self.complete_hist.sum_seconds, 6),
            }

    def shutdown(self, wait: bool = True):
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        if wait:
            for w in self._workers:
                w.join(timeout=10)
