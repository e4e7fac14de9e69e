"""Admission control: bounded queue, backpressure, graceful degradation.

A serving process that queues without bound converts overload into
unbounded latency for everyone (and eventually OOM). This layer rejects at
the door instead: ``AdmissionController`` tracks in-flight rows against a
hard cap and raises ``OverloadError`` — the HTTP layer maps it to a
429-style response with Retry-After, so clients shed load and the resident
engine keeps serving at its max throughput.

``GracefulQueryFn`` wraps the engine with its one runtime fallback, the
JAX package's counted ``degrade()``: where the engine can degrade
(``pallas_tiled`` on the CPU), a failure of the traversal's plain version
swaps the engine to its twin ``tiled`` (identical distances) and the
failure is recorded in stats. On the card the engine cannot degrade: a
kernel that fails to build or launch raises, and its requests fail with
it. The copy of the JAX package's ``serve/admission.py``.
"""

from __future__ import annotations

import threading

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by


class OverloadError(RuntimeError):
    """Server at capacity — client should retry after ``retry_after_s``."""

    def __init__(self, msg: str, retry_after_s: float = 0.05):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or while) it executed."""


class AdmissionController:
    """Row-granular bounded admission.

    Rows, not requests: one 1024-row request costs the engine what 1024
    singletons do, so the cap must count what the engine pays for.

    The cap covers QUEUED + IN-FLIGHT rows by construction: ``admit``
    reserves before a request enters the batcher queue and ``release``
    fires only after its response demuxes, so rows dispatched on the device
    under a deep pipeline stay counted the whole way. Sizing note for
    pipelined serving: the device pipeline can hold up to
    ``pipeline_depth * max_batch`` rows beyond the waiting queue, so
    ``max_queue_rows`` below ``(pipeline_depth + 1) * max_batch`` caps
    pipeline occupancy before the admission cap ever matters.
    ``pipeline_rows_fn`` (wired by the server to the batcher) splits the
    aggregate into its dispatched-on-device component for stats/metrics.
    """

    def __init__(self, max_queue_rows: int = 4096,
                 default_timeout_s: float = 5.0):
        self.max_queue_rows = int(max_queue_rows)
        self.default_timeout_s = float(default_timeout_s)
        self._lock = threading.Lock()
        # shared across every handler thread: lskcheck proves each access
        # happens under the declared lock (docs/ANALYSIS.md)
        self._inflight_rows: guarded_by("_lock") = 0
        self.admitted: guarded_by("_lock") = 0
        self.rejected: guarded_by("_lock") = 0
        #: optional () -> int: rows currently dispatched on the device
        #: (batcher.inflight_rows); reported in stats, not used for capping
        self.pipeline_rows_fn = None

    def admit(self, n_rows: int) -> None:
        """Reserve ``n_rows`` of queue budget or raise ``OverloadError``.
        Callers MUST pair with ``release`` (use ``admitted_rows``)."""
        with self._lock:
            if self._inflight_rows + n_rows > self.max_queue_rows:
                self.rejected += 1
                raise OverloadError(
                    f"queue full ({self._inflight_rows}/"
                    f"{self.max_queue_rows} rows in flight)")
            self._inflight_rows += n_rows
            self.admitted += 1

    def release(self, n_rows: int) -> None:
        with self._lock:
            self._inflight_rows -= n_rows

    def admitted_rows(self, n_rows: int):
        """Context manager form of admit/release."""
        return _Admitted(self, n_rows)

    def inflight_rows(self) -> int:
        with self._lock:
            return self._inflight_rows

    def stats(self) -> dict:
        with self._lock:
            out = {"inflight_rows": self._inflight_rows,
                   "max_queue_rows": self.max_queue_rows,
                   "admitted": self.admitted,
                   "rejected": self.rejected}
        if self.pipeline_rows_fn is not None:
            out["pipeline_inflight_rows"] = int(self.pipeline_rows_fn())
        return out


class _Admitted:
    def __init__(self, ctrl: AdmissionController, n_rows: int):
        self._ctrl = ctrl
        self._n = n_rows

    def __enter__(self):
        self._ctrl.admit(self._n)
        return self

    def __exit__(self, *exc):
        self._ctrl.release(self._n)
        return False


class GracefulQueryFn:
    """Engine call with one-shot degradation to the twin ``tiled``.

    On the first non-overload exception from a degradable engine
    (``pallas_tiled`` on the CPU), swap to ``tiled`` and retry the same
    batch once. An engine that cannot degrade (any engine on the card)
    re-raises: the batch fails and nothing is replayed.
    The twin builds its launch plan per shape bucket on first use after
    degradation (counted in ``compile_count``); results are identical
    by the twin-engine contract, so callers never observe the swap except
    through stats.

    The ``dispatch``/``complete`` pair mirrors the engine's pipelined
    split. Async dispatch moves failure to where the result is FETCHED, so
    a mid-stream kernel failure surfaces in ``complete`` for a batch whose
    dispatch already succeeded — the in-flight handle retains its host
    queries and is replayed synchronously on the (now degraded) engine. A
    stale handle that was dispatched on the old engine but fails after a
    concurrent batch already triggered the degradation is replayed without
    counting a second degradation; every queued batch therefore drains to a
    correct answer, never an error, as long as the twin works.
    """

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self.failures: guarded_by("_lock") = 0

    def _degrade_or_raise(self, e: Exception, handle=None) -> None:
        """Record a failure; degrade if possible, else re-raise ``e``.

        Returns (instead of raising) when a replay can succeed: either this
        failure triggered the degradation, or the engine was ALREADY
        degraded after ``handle`` was dispatched (its recorded engine name
        differs from the current one).
        """
        with self._lock:
            self.failures += 1
            if self.engine.can_degrade():
                self.engine.degrade(f"{type(e).__name__}: {e}")
            elif (handle is None or getattr(handle, "engine_name", None)
                    == self.engine.engine_name):
                raise e

    def _query(self, queries, plan, tenant=None, seed_radius=None):
        # exact single-index requests use the legacy single-arg form so
        # engines (and test doubles) without a plan/tenant kwarg keep
        # working — the batcher's compatibility rule, applied to the
        # degradation shim too. Certified radius seeds (serve/qcache.py)
        # ride the same conditional-kwarg rule: only engines actually
        # handed seeds need to understand ``seed_radius``.
        kw = {} if seed_radius is None else {"seed_radius": seed_radius}
        if tenant is not None:
            return self.engine.query(queries, plan=plan, tenant=tenant, **kw)
        return (self.engine.query(queries, **kw) if plan is None
                else self.engine.query(queries, plan=plan, **kw))

    def __call__(self, queries, plan=None, tenant=None, seed_radius=None):
        try:
            return self._query(queries, plan, tenant, seed_radius)
        except Exception as e:  # noqa: BLE001 - re-raised unless degradable
            self._degrade_or_raise(e)
            # the degraded replay runs UNSEEDED: seeds never change the
            # answer, so dropping them is sound — and it keeps the replay
            # maximally conservative while the engine is already hurt
            return self._query(queries, plan, tenant)

    def _dispatch(self, queries, plan, tenant=None, seed_radius=None):
        kw = {} if seed_radius is None else {"seed_radius": seed_radius}
        if tenant is not None:
            return self.engine.dispatch(queries, plan=plan, tenant=tenant,
                                        **kw)
        return (self.engine.dispatch(queries, **kw) if plan is None
                else self.engine.dispatch(queries, plan=plan, **kw))

    def dispatch(self, queries, plan=None, tenant=None, seed_radius=None):
        try:
            return self._dispatch(queries, plan, tenant, seed_radius)
        except Exception as e:  # noqa: BLE001 - re-raised unless degradable
            self._degrade_or_raise(e)
            return self._dispatch(queries, plan, tenant)

    def complete(self, handle):
        try:
            return self.engine.complete(handle)
        except Exception as e:  # noqa: BLE001 - re-raised unless degradable
            self._degrade_or_raise(e, handle)
            # replay the retained host queries synchronously on the current
            # (degraded) engine — exact by the twin-engine contract, under
            # the SAME recall plan (and tenant namespace) the handle was
            # dispatched with
            return self._query(handle.queries,
                               getattr(handle, "plan", None),
                               getattr(handle, "tenant", None))
