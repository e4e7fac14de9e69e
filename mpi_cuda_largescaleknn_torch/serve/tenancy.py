"""Multi-index tenancy: one slab pool, many indexes.

The port of the JAX package's ``serve/tenancy.py``. Many users means many
DATASETS, not one. This module generalizes the serving stack from "slabs
of one index" to "(tenant, slab) pages of many indexes" behind one shared
byte budget:

- ``TenantRegistry`` maps tenant id -> that tenant's engine view; the
  HTTP surface resolves ``/v1/<tenant>/knn`` through it (unknown tenant
  = 404, never a silent fallthrough to someone else's index).
- ``MultiTenantEngine`` builds one ``SlabPool`` (serve/slabpool.py) and
  registers every tenant's ``SlabSource`` + engine factory into it, so
  all tenants compete for ONE device byte budget and ONE host tier: hot
  tenants naturally occupy the device tier, cold tenants fall to
  host-RAM/mmap and ride the same promotion and cold-read path.
  Per-tenant pin/prefetch/stall accounting rides the pool's tuple keys.
- Shared launch plans: every tenant's slab engines pad to ONE shape
  class (the max per-shard slab rows across ALL tenants) and share one
  ``LaunchPlanCache``, so the tenant count never becomes the plan count
  (``compile_count``).
- ``TenantQuotas`` slices the row-budget admission controller per
  tenant (the PANDA-style isolation of concurrent query streams,
  arXiv:1607.08220): one hot tenant cannot starve the rest; an
  over-quota request gets the same 429 + Retry-After contract as global
  overload.

Exactness contract per tenant: each tenant's answers are bit-identical
to a single-tenant ``StreamingKnnEngine`` over the same points at every
budget — the shared pool changes WHEN a slab is resident, never what its
engine computes, and the per-tenant fold is the same commutative
candidate merge. A cold tenant STALLS (counted per tenant), it is never
served from another tenant's rows.
"""

from __future__ import annotations

import threading
import time

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.obs.timers import PhaseTimers
from mpi_cuda_largescaleknn_torch.serve.admission import (
    AdmissionController,
    OverloadError,
)
from mpi_cuda_largescaleknn_torch.serve.slabpool import (
    SlabPool,
    SlabSource,
    StreamingKnnEngine,
)

#: the tenant legacy single-index URLs (``POST /knn``) resolve to when a
#: multi-tenant server has no explicit default
DEFAULT_TENANT = "default"


class UnknownTenantError(KeyError):
    """No such tenant — the HTTP layer maps this to 404."""


class TenantSpec:
    """One tenant's index source + slab layout (immutable config)."""

    __slots__ = ("name", "path", "points", "url", "num_slabs")

    def __init__(self, name: str, *, path: str | None = None,
                 points=None, url: str | None = None, num_slabs: int = 1):
        if not name or "/" in name:
            raise ValueError(f"bad tenant name {name!r} (non-empty, "
                             f"no '/' — it rides in URLs)")
        self.name = name
        self.path = path
        self.points = points
        self.url = url
        self.num_slabs = int(num_slabs)


class TenantRegistry:
    """tenant id -> engine view, the HTTP surface's routing table.

    Registration happens at startup (before serving), lookups on every
    request; the lock keeps the pair safe under live registration."""

    def __init__(self):
        self._lock = threading.Lock()
        # tenant name -> engine view; shared between the registration
        # path and every handler thread's resolve()
        self._engines: guarded_by("_lock") = {}

    def add(self, name: str, engine) -> None:
        with self._lock:
            self._engines[name] = engine

    def get(self, name: str):
        """The tenant's engine view; raises ``UnknownTenantError``."""
        with self._lock:
            if name in self._engines:
                return self._engines[name]
        raise UnknownTenantError(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._engines)

    def __contains__(self, name) -> bool:
        with self._lock:
            return name in self._engines

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)


class TenantQuotas:
    """Per-tenant row-budget slices over one ``AdmissionController``
    (the hook: ``KnnServer`` admits through ``admitted_rows`` when its
    engine carries tenants).

    The global controller still caps TOTAL queued+in-flight rows (it is
    always consulted second); this layer additionally caps each tenant's
    share so one hot tenant cannot occupy the whole queue. ``quota_rows
    <= 0`` means unsliced — that tenant only sees the global cap. An
    over-quota request raises ``OverloadError`` with the same
    Retry-After contract as global overload (HTTP 429)."""

    def __init__(self, controller: AdmissionController, *,
                 default_quota_rows: int = 0, quotas: dict | None = None,
                 retry_after_s: float = 0.05):
        self.controller = controller
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        # per-tenant reservation state, shared across handler threads:
        # quota table, in-flight rows, and rejection counters
        self._quota: guarded_by("_lock") = dict(quotas or {})
        self._default_quota: guarded_by("_lock") = int(default_quota_rows)
        self._inflight: guarded_by("_lock") = {}
        self._rejected: guarded_by("_lock") = {}

    def set_quota(self, tenant: str, rows: int) -> None:
        with self._lock:
            self._quota[tenant] = int(rows)

    def quota(self, tenant: str) -> int:
        with self._lock:
            return int(self._quota.get(tenant, self._default_quota))

    def admit(self, tenant: str, n_rows: int) -> None:
        """Reserve ``n_rows`` against the tenant's slice, then against
        the global cap (rolled back if the global cap rejects). Callers
        MUST pair with ``release`` (use ``admitted_rows``)."""
        with self._lock:
            q = int(self._quota.get(tenant, self._default_quota))
            used = self._inflight.get(tenant, 0)
            if q > 0 and used + n_rows > q:
                self._rejected[tenant] = self._rejected.get(tenant, 0) + 1
                raise OverloadError(
                    f"tenant '{tenant}' over quota ({used}/{q} rows "
                    f"in flight)", retry_after_s=self.retry_after_s)
            self._inflight[tenant] = used + n_rows
        try:
            self.controller.admit(n_rows)
        except BaseException:
            with self._lock:
                self._inflight[tenant] -= n_rows
            raise

    def release(self, tenant: str, n_rows: int) -> None:
        self.controller.release(n_rows)
        with self._lock:
            self._inflight[tenant] = self._inflight.get(tenant, 0) - n_rows

    def admitted_rows(self, tenant: str, n_rows: int):
        """Context manager form of admit/release."""
        return _TenantAdmitted(self, tenant, n_rows)

    def stats(self) -> dict:
        with self._lock:
            tenants = sorted(set(self._quota) | set(self._inflight)
                             | set(self._rejected))
            return {
                "default_quota_rows": self._default_quota,
                "tenants": {
                    t: {"quota_rows": int(self._quota.get(
                            t, self._default_quota)),
                        "inflight_rows": self._inflight.get(t, 0),
                        "rejected": self._rejected.get(t, 0)}
                    for t in tenants},
            }


class _TenantAdmitted:
    def __init__(self, quotas: TenantQuotas, tenant: str, n_rows: int):
        self._q = quotas
        self._tenant = tenant
        self._n = n_rows

    def __enter__(self):
        self._q.admit(self._tenant, self._n)
        return self

    def __exit__(self, *exc):
        self._q.release(self._tenant, self._n)
        return False


class _TenantHandle:
    """A dispatched multi-tenant batch: the tenant namespace plus the
    underlying streaming handle. Forwards the attributes the pipeline's
    degradation replay reads (``queries``/``engine_name``/``plan``) —
    the inner handle is ``__slots__``-bound, so the tenant tag lives
    here instead."""

    __slots__ = ("tenant", "inner")

    def __init__(self, tenant: str, inner):
        self.tenant = tenant
        self.inner = inner

    @property
    def queries(self):
        return self.inner.queries

    @property
    def engine_name(self):
        return self.inner.engine_name

    @property
    def plan(self):
        return self.inner.plan

    @property
    def n(self):
        return self.inner.n


class MultiTenantEngine:
    """Engine over N tenants sharing one ``SlabPool`` and plan cache.

    Speaks the same ``dispatch``/``complete``/``query`` contract as the
    single-index engines with an added ``tenant=`` kwarg (None resolves
    to ``default_tenant`` — the legacy ``/knn`` route). The batcher,
    graceful wrapper, and HTTP server drive it like any other engine;
    per-tenant views are full ``StreamingKnnEngine`` instances sharing
    the pool, timers, and plan cache, so every single-tenant
    behavior (routing, escalation, recall plans, degradation) holds
    per tenant unchanged."""

    def __init__(self, specs, *, k: int, num_shards: int = 1,
                 device_slab_budget: int = 0, host_pool_slabs: int = 0,
                 host_pool_bytes: int = 0, prefetch_depth: int = 1,
                 faults=None, default_tenant: str | None = None,
                 skip_cold_stall_limit: float = 0.25, device=None,
                 clock=time.perf_counter, **engine_kw):
        from mpi_cuda_largescaleknn_torch.core.config import resolve_device
        from mpi_cuda_largescaleknn_torch.serve.engine import LaunchPlanCache

        specs = list(specs)
        if not specs:
            raise ValueError("need at least one TenantSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        self.device = resolve_device(device)
        self.num_shards = num_shards = int(num_shards)
        # cold sources first: the shared shape class must cover every
        # tenant's largest slab BEFORE any engine builds a plan, or
        # tenants would land in different plan-cache classes
        sources = {
            s.name: SlabSource(path=s.path, points=s.points, url=s.url,
                               num_slabs=s.num_slabs)
            for s in specs}
        pad = max(-(-max(e - b for b, e in src.bounds) // num_shards)
                  for src in sources.values())
        self.slab_pool = SlabPool(
            device_budget_bytes=device_slab_budget,
            host_pool_slabs=host_pool_slabs,
            host_pool_bytes=host_pool_bytes, faults=faults, clock=clock)
        self._plan_cache = LaunchPlanCache()
        self.timers = PhaseTimers()
        self.tenants = TenantRegistry()
        self._names = list(names)
        self.default_tenant = (default_tenant if default_tenant is not None
                               else names[0])
        if self.default_tenant not in names:
            raise ValueError(f"default tenant {self.default_tenant!r} "
                             f"not in {names}")
        for s in specs:
            view = StreamingKnnEngine(
                source=sources[s.name], k=k, num_shards=num_shards,
                prefetch_depth=prefetch_depth, pool=self.slab_pool,
                tenant=s.name, shared_plan_cache=self._plan_cache,
                pad_shard_rows=pad, timers=self.timers,
                skip_cold_stall_limit=skip_cold_stall_limit,
                device=self.device, clock=clock, **engine_kw)
            self.tenants.add(s.name, view)
        self.n_points = sum(self.tenants.get(n).n_points for n in names)
        self.device_slab_budget = int(device_slab_budget)

    # ------------------------------------------------------------- resolution

    def resolve(self, tenant: str | None):
        """(name, engine view) for a request's tenant (None = default);
        raises ``UnknownTenantError`` for strangers."""
        name = tenant if tenant is not None else self.default_tenant
        return name, self.tenants.get(name)

    def _default_engine(self):
        return self.tenants.get(self.default_tenant)

    def __getattr__(self, name):
        # the long tail of read-only engine surface (dim, k, max_batch,
        # shape_buckets, score_dtype, ...) — every tenant view shares the
        # same knobs, so the default tenant's answer is the pool's
        if name.startswith("_") or name == "tenants":
            raise AttributeError(name)
        return getattr(self._default_engine(), name)

    # -------------------------------------------------------------- query API

    def dispatch(self, queries, plan=None, tenant: str | None = None,
                 seed_radius=None):
        name, eng = self.resolve(tenant)
        kw = {} if seed_radius is None else {"seed_radius": seed_radius}
        return _TenantHandle(name, eng.dispatch(queries, plan=plan, **kw))

    def complete(self, handle: _TenantHandle):
        return self.tenants.get(handle.tenant).complete(handle.inner)

    def query(self, queries, plan=None, tenant: str | None = None,
              seed_radius=None):
        return self.complete(self.dispatch(queries, plan=plan,
                                           tenant=tenant,
                                           seed_radius=seed_radius))

    def prefetch_hint(self, queries, tenant: str | None = None) -> None:
        _name, eng = self.resolve(tenant)
        eng.prefetch_hint(queries)

    # ------------------------------------------------------------ engine mgmt

    def warmup(self) -> dict:
        """Build every shape bucket's plan once through the DEFAULT tenant
        (into the shared cache), then warm the other tenants: their slab
        engines reuse the same plans, so warmup is one plan pass plus data
        motion (the compile-count-flat contract)."""
        info = {"tenants": {}}
        order = [self.default_tenant] + [n for n in self._names
                                         if n != self.default_tenant]
        for name in order:
            info["tenants"][name] = self.tenants.get(name).warmup()
        info["compile_count"] = self._plan_cache.stats()["compiles"]
        return info

    def can_degrade(self) -> bool:
        return self._default_engine().can_degrade()

    def degrade(self, reason: str) -> None:
        for name in self._names:
            eng = self.tenants.get(name)
            if eng.can_degrade():
                eng.degrade(reason)

    def set_launch_workers(self, n: int) -> None:
        for name in self._names:
            self.tenants.get(name).set_launch_workers(n)

    def close(self) -> None:
        # tenant views share the pool (none owns it) — close it once here
        self.slab_pool.close()

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict:
        """The default tenant's full stats dict (the /stats "engine"
        block keeps its single-tenant shape) with pool-wide n_points and
        a per-tenant namespace — per-tenant residency/stall shares from
        the pool plus each view's index geometry."""
        out = self._default_engine().stats()
        out["n_points"] = self.n_points
        out["default_tenant"] = self.default_tenant
        pool_tenants = out.get("slab_pool", {}).get("tenants", {})
        per = {}
        for name in self._names:
            eng = self.tenants.get(name)
            per[name] = dict(
                pool_tenants.get(name, {}),
                n_points=eng.n_points, num_slabs=eng.num_slabs,
                k=eng.k, dim=eng.dim)
        out["tenants"] = per
        return out
