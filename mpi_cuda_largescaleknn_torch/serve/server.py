"""Stdlib-HTTP serving front end: /knn, /healthz, /stats, /metrics.

The copy of the JAX package's ``serve/server.py``. No web framework:
``http.server.ThreadingHTTPServer`` with one handler thread per connection.
Handler threads only parse, admit, and block on the batcher's demux event;
they never touch the card. All engine dispatch happens on the batcher's
dispatch worker (plus one completion worker for the fetch and merge when
``pipeline_depth > 1``), so launches stay single-threaded no matter how
many clients connect.

Request formats on POST /knn:
- JSON  (default): ``{"queries": [[x,y,z], ...], "neighbors": true?,
  "timeout_ms": 250?}`` -> ``{"dists": [...], "neighbors": [[...], ...]?}``
- binary (Content-Type: application/octet-stream): little-endian f32
  x,y,z triples; response is raw f32 distances. Options ride the query
  string (``/knn?neighbors=1&timeout_ms=250`` — neighbors only in JSON).

Multi-index tenancy (serve/tenancy.py): when the engine carries a tenant
registry, ``POST /v1/<tenant>/knn`` (or a ``"tenant"`` JSON field /
``X-Knn-Tenant`` header for the binary codec) routes to that tenant's
index; legacy ``/knn`` resolves to the default tenant, unknown tenants
404, and per-tenant admission quotas 429 with Retry-After. Single-index
servers are byte-identical to the pre-tenancy wire.

Error mapping: queue full -> 429 + Retry-After (admission backpressure),
deadline -> 504, batch wider than max_batch -> 413, bad input -> 400.
/metrics is Prometheus text fed by obs/timers.py's LatencyHistogram.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.obs.timers import LatencyHistogram
from mpi_cuda_largescaleknn_torch.serve.admission import (
    AdmissionController,
    DeadlineExceeded,
    GracefulQueryFn,
    OverloadError,
)
from mpi_cuda_largescaleknn_torch.serve.batcher import DynamicBatcher
from mpi_cuda_largescaleknn_torch.serve.engine import UnservableShapeError
from mpi_cuda_largescaleknn_torch.serve.faults import (
    FaultInjector,
    apply_http_fault,
)
from mpi_cuda_largescaleknn_torch.serve.qcache import QueryCache
from mpi_cuda_largescaleknn_torch.serve.recall import RecallPolicy
from mpi_cuda_largescaleknn_torch.serve.tenancy import TenantQuotas


def parse_knn_body(path: str, headers, rfile, dim: int = 3):
    """Parse one POST /knn request.

    ``dim`` is the serving index's point dimensionality (the engine's
    ``dim`` attribute — the stack is D-generic; 3 is just the default).
    -> (queries f32[n,dim], want_neighbors, timeout_s, recall, tenant,
    binary).

    ``recall`` is the request's recall-SLO target (serve/recall.py): the
    JSON body's ``"recall": 0.95`` key, or ``recall=0.95`` on the query
    string (the binary codec's only option channel). ``None`` — the
    default — means exact; values outside (0, 1] are a 400.

    ``tenant`` is the request's index namespace (serve/tenancy.py): the
    JSON body's ``"tenant"`` key, or the ``X-Knn-Tenant`` header — the
    binary codec's channel. A tenant in the URL (``/v1/<t>/knn``) is
    resolved by the caller and takes precedence over both. ``None`` on a
    multi-tenant server means the default tenant; on a single-index
    server the field is ignored (the pre-tenancy wire is unchanged)."""
    qs = parse_qs(urlparse(path).query)
    length = int(headers.get("Content-Length", 0))
    raw = rfile.read(length)
    ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
    timeout_ms = float(qs.get("timeout_ms", [0])[0] or 0)
    neighbors = qs.get("neighbors", ["0"])[0] not in ("0", "", "false")
    recall_qs = qs.get("recall", [None])[0]
    recall = float(recall_qs) if recall_qs not in (None, "") else None
    tenant = headers.get("X-Knn-Tenant") or None
    if ctype == "application/octet-stream":
        if len(raw) % (4 * dim):
            raise ValueError(
                f"binary body must be n*{4 * dim} bytes (f32 x{dim})")
        q = np.frombuffer(raw, "<f4").reshape(-1, dim)
        return (q, neighbors, timeout_ms / 1e3, _check_recall(recall),
                tenant, True)
    obj = json.loads(raw.decode() or "{}")
    q = np.asarray(obj.get("queries", []), np.float32)
    if q.size == 0:
        q = q.reshape(0, dim)
    if q.ndim != 2 or q.shape[1] != dim:
        raise ValueError(f"queries must be [n, {dim}], got {list(q.shape)}")
    if not np.all(np.isfinite(q)):
        raise ValueError("queries must be finite")
    timeout_ms = float(obj.get("timeout_ms", timeout_ms) or 0)
    if obj.get("recall") is not None:
        recall = float(obj["recall"])
    if obj.get("tenant"):
        tenant = str(obj["tenant"])
    return (q, bool(obj.get("neighbors", neighbors)), timeout_ms / 1e3,
            _check_recall(recall), tenant, False)


def _check_recall(recall: float | None) -> float | None:
    if recall is not None and not 0.0 < recall <= 1.0:
        raise ValueError(f"recall target must be in (0, 1], got {recall}")
    return recall


def slab_pool_prometheus_lines(engine_stats: dict) -> list[str]:
    """Prometheus lines for the tiered slab index (serve/slabpool.py),
    empty when the engine is fully resident."""
    pool = engine_stats.get("slab_pool")
    if not pool:
        return []
    return [
        "# TYPE knn_slab_pool_resident gauge",
        f'knn_slab_pool_resident{{tier="device"}} '
        f'{pool["device_resident"]}',
        f'knn_slab_pool_resident{{tier="host"}} {pool["host_resident"]}',
        "# TYPE knn_slab_pool_device_bytes gauge",
        f'knn_slab_pool_device_bytes {pool["device_bytes_used"]}',
        "# TYPE knn_slab_pool_device_budget_bytes gauge",
        f'knn_slab_pool_device_budget_bytes '
        f'{pool["device_budget_bytes"]}',
        "# TYPE knn_slab_promotions_total counter",
        f'knn_slab_promotions_total {pool["promotions"]}',
        "# TYPE knn_slab_evictions_total counter",
        f'knn_slab_evictions_total {pool["evictions"]}',
        "# TYPE knn_stream_stalls_total counter",
        f'knn_stream_stalls_total {pool["stream_stalls"]}',
        "# TYPE knn_stream_stall_seconds_total counter",
        f'knn_stream_stall_seconds_total {pool["stream_stall_seconds"]}',
        "# TYPE knn_slab_pool_hits_total counter",
        f'knn_slab_pool_hits_total{{tier="device"}} {pool["device_hits"]}',
        f'knn_slab_pool_hits_total{{tier="host"}} {pool["host_hits"]}',
        "# TYPE knn_slab_pool_cold_reads_total counter",
        f'knn_slab_pool_cold_reads_total {pool["cold_reads"]}',
        "# TYPE knn_slab_prefetch_enqueued_total counter",
        f'knn_slab_prefetch_enqueued_total {pool["prefetch_enqueued"]}',
    ] + _streaming_prometheus_lines(engine_stats)


def _tenant_prometheus_lines(srv, engine_stats: dict) -> list[str]:
    """Per-tenant slab-pool occupancy/stall shares and admission-quota
    state for /metrics (``knn_*{tenant=...}``) — empty on single-index
    servers, so their text output is byte-identical to pre-tenancy."""
    if getattr(srv, "tenants", None) is None:
        return []
    lines = []
    pool_t = engine_stats.get("slab_pool", {}).get("tenants") or {}
    if pool_t:
        lines += ["# TYPE knn_slab_pool_tenant_resident gauge"]
        for t in sorted(pool_t):
            for tier, key in (("device", "device_resident"),
                              ("host", "host_resident")):
                lines += [f'knn_slab_pool_tenant_resident{{tenant="{t}",'
                          f'tier="{tier}"}} {pool_t[t].get(key, 0)}']
        for metric, key in (
                ("knn_slab_tenant_promotions_total", "promotions"),
                ("knn_slab_tenant_evictions_total", "evictions"),
                ("knn_slab_tenant_cold_reads_total", "cold_reads"),
                ("knn_stream_tenant_stalls_total", "stream_stalls"),
                ("knn_stream_tenant_stall_seconds_total",
                 "stream_stall_seconds")):
            lines += [f"# TYPE {metric} counter"] + [
                f'{metric}{{tenant="{t}"}} {pool_t[t].get(key, 0)}'
                for t in sorted(pool_t)]
    if srv.quotas is not None:
        qs = srv.quotas.stats()
        qt = qs["tenants"]
        if qt:
            for metric, key, kind in (
                    ("knn_tenant_quota_rows", "quota_rows", "gauge"),
                    ("knn_tenant_inflight_rows", "inflight_rows", "gauge"),
                    ("knn_tenant_quota_rejected_total", "rejected",
                     "counter")):
                lines += [f"# TYPE {metric} {kind}"] + [
                    f'{metric}{{tenant="{t}"}} {qt[t][key]}'
                    for t in sorted(qt)]
    return lines


def qcache_prometheus_lines(qcache) -> list[str]:
    """Prometheus lines for the certified query cache (serve/qcache.py):
    the four reuse counters (+ size/insert gauges), each with a
    ``{tenant=}`` twin per tenant on multi-tenant servers. Empty when the
    cache is off — cache-off servers' /metrics text is unchanged."""
    if qcache is None:
        return []
    qs = qcache.stats()
    tenants = qs["tenants"]
    lines = []
    for metric, key in (("knn_qcache_hits_total", "hits"),
                        ("knn_qcache_seeds_total", "seeds"),
                        ("knn_qcache_dedup_rows_total", "dedup_rows"),
                        ("knn_qcache_evictions_total", "evictions")):
        lines += [f"# TYPE {metric} counter", f"{metric} {qs[key]}"]
        lines += [f'{metric}{{tenant="{t}"}} {tenants[t][key]}'
                  for t in sorted(tenants)]
    for metric, key in (("knn_qcache_misses_total", "misses"),
                        ("knn_qcache_inserts_total", "inserts"),
                        ("knn_qcache_inflight_aborts_total",
                         "inflight_aborts")):
        lines += [f"# TYPE {metric} counter", f"{metric} {qs[key]}"]
    for metric, key in (("knn_qcache_size_rows", "size_rows"),
                        ("knn_qcache_capacity_rows", "capacity_rows"),
                        ("knn_qcache_inflight_rows", "inflight_rows")):
        lines += [f"# TYPE {metric} gauge", f"{metric} {qs[key]}"]
    return lines


def _streaming_prometheus_lines(engine_stats: dict) -> list[str]:
    streaming = engine_stats.get("streaming")
    if not streaming:
        return []
    return [
        # recall-SLO tier (serve/recall.py stream_skip_cold): cold-slab
        # promotions given up for recall instead of stalled on — the
        # "stalls into recall" trade as a number
        "# TYPE knn_stream_skipped_promotions_total counter",
        f"knn_stream_skipped_promotions_total "
        f"{streaming['skipped_promotions']}",
        # drift guard: skip-cold plans refused because the pool
        # was already stalling above the admission limit
        "# TYPE knn_stream_skip_cold_refusals_total counter",
        f"knn_stream_skip_cold_refusals_total "
        f"{streaming.get('skip_cold_refusals', 0)}",
    ]


#: knn_recall_estimated histogram upper edges (plan-level calibrated
#: recall per approximate request); +Inf bucket rides implicitly
RECALL_HIST_EDGES = (0.5, 0.8, 0.9, 0.95, 0.99, 1.0)


def recall_response_fields(plan, recall):
    """The response surface of one request's recall resolution:
    ``(json_fields, binary_headers)``. Exact requests (no target at all)
    get neither — the pre-tier wire stays byte-identical. A target served
    EXACTLY (recall=1.0, or a target no calibrated plan meets) is answered
    ``exact: true`` with a 1.0 estimate — serving exact always meets any
    target."""
    if plan is None:
        if recall is None:
            return {}, []
        return ({"exact": True, "recall_target": float(recall),
                 "recall_estimated": 1.0},
                [("X-Knn-Exact", "1"),
                 ("X-Knn-Recall-Target", f"{recall:g}"),
                 ("X-Knn-Recall-Estimated", "1")])
    return ({"exact": False, "recall_target": float(plan.recall_target),
             "recall_estimated": float(plan.recall_estimated),
             "recall_plan": plan.name},
            [("X-Knn-Exact", "0"),
             ("X-Knn-Recall-Target", f"{plan.recall_target:g}"),
             ("X-Knn-Recall-Estimated", f"{plan.recall_estimated:g}"),
             ("X-Knn-Recall-Plan", plan.name)])


class ServingMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        # increments come from every handler thread; readers (the /stats
        # and /metrics renderers) take dict(...) copies — a point-in-time
        # copy of int counters is the intended snapshot semantics
        self.counters: guarded_by("_lock") = {
            "knn_requests_total": 0, "knn_rows_total": 0,
            "knn_overload_total": 0, "knn_deadline_total": 0,
            "knn_badrequest_total": 0, "knn_error_total": 0}
        self.latency = LatencyHistogram()
        # recall-SLO tier accounting: requests per tier plus a fixed-edge
        # histogram of the approximate responses' calibrated
        # recall_estimated (plan-level — every row of an approx request
        # shares its plan's claim)
        self.recall_tiers: guarded_by("_lock") = {"exact": 0, "approx": 0}
        self.recall_hist: guarded_by("_lock") = (
            [0] * (len(RECALL_HIST_EDGES) + 1))
        self.recall_hist_sum: guarded_by("_lock") = 0.0
        # multi-index tenancy: the same counter families keyed per tenant
        # ({tenant: {name: count}}) plus a per-tenant latency histogram —
        # empty (and never rendered) on single-index servers
        self.tenant_counters: guarded_by("_lock") = {}
        self.tenant_latency: guarded_by("_lock") = {}

    def snapshot(self) -> dict:
        """Locked point-in-time copy — what cross-object readers use
        (the guarded_by proof is self-rooted; see docs/ANALYSIS.md)."""
        with self._lock:
            return dict(self.counters)

    def inc(self, name: str, by: int = 1, tenant: str | None = None):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by
            if tenant is not None:
                tc = self.tenant_counters.setdefault(tenant, {})
                tc[name] = tc.get(name, 0) + by

    def record_latency(self, seconds: float, tenant: str | None = None):
        """Global request-latency observation, plus the tenant's own
        histogram when the request was tenant-scoped."""
        self.latency.record(seconds)
        if tenant is None:
            return
        with self._lock:
            hist = self.tenant_latency.get(tenant)
            if hist is None:
                hist = self.tenant_latency[tenant] = LatencyHistogram()
        hist.record(seconds)

    def tenant_snapshot(self) -> dict:
        """{tenant: {counter: value}} point-in-time copy."""
        with self._lock:
            return {t: dict(c) for t, c in self.tenant_counters.items()}

    def tenant_latency_report(self, tenant: str) -> dict | None:
        with self._lock:
            hist = self.tenant_latency.get(tenant)
        return None if hist is None else hist.report()

    def note_recall(self, plan) -> None:
        """Record one request's recall tier (``plan`` is None for exact,
        a serve/recall.py RecallPlan otherwise)."""
        with self._lock:
            if plan is None:
                self.recall_tiers["exact"] += 1
                return
            self.recall_tiers["approx"] += 1
            r = float(plan.recall_estimated)
            self.recall_hist_sum += r
            for i, edge in enumerate(RECALL_HIST_EDGES):
                if r <= edge:
                    self.recall_hist[i] += 1
                    break
            else:
                self.recall_hist[-1] += 1

    def recall_snapshot(self) -> dict:
        with self._lock:
            return {
                "tiers": dict(self.recall_tiers),
                "estimated_hist": {
                    "edges": list(RECALL_HIST_EDGES),
                    "counts": list(self.recall_hist),
                    "sum": round(self.recall_hist_sum, 6),
                    "count": self.recall_tiers["approx"]},
            }

    def recall_prometheus_lines(self) -> list[str]:
        snap = self.recall_snapshot()
        lines = ["# TYPE knn_recall_requests_total counter"] + [
            f'knn_recall_requests_total{{tier="{t}"}} {v}'
            for t, v in sorted(snap["tiers"].items())]
        h = snap["estimated_hist"]
        lines += ["# TYPE knn_recall_estimated histogram"]
        cum = 0
        for edge, c in zip(h["edges"], h["counts"]):
            cum += c
            lines += [f'knn_recall_estimated_bucket{{le="{edge}"}} {cum}']
        lines += [f'knn_recall_estimated_bucket{{le="+Inf"}} {h["count"]}',
                  f"knn_recall_estimated_sum {h['sum']}",
                  f"knn_recall_estimated_count {h['count']}"]
        return lines


class KnnServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, engine, *, max_delay_s=0.002,
                 max_queue_rows=4096, default_timeout_s=5.0, query_fn=None,
                 verbose=False, pipeline_depth=2, faults=None,
                 recall_policy=None, tenant_quota_rows=0,
                 qcache_rows=4096, qcache_seed_rows=512):
        self.engine = engine
        #: multi-index tenancy (serve/tenancy.py): a MultiTenantEngine
        #: exposes a TenantRegistry — its presence switches on the
        #: /v1/<tenant>/knn surface, per-tenant metrics, and quotas.
        #: Single-index engines leave all three None/off, keeping the
        #: wire byte-identical to pre-tenancy servers.
        self.tenants = getattr(engine, "tenants", None)
        self.quotas = None
        #: recall-SLO tier (serve/recall.py): maps a request's
        #: ``"recall": 0.95`` target to a calibrated cheaper plan. The
        #: built-in table serves by default, K-CONDITIONED on the
        #: engine's heap depth (deep k needs gentler knobs); operators
        #: swap in a harness-calibrated one via --recall-policy
        #: (cli/serve_main.py)
        self.recall_policy = (
            RecallPolicy.for_k(getattr(engine, "k", None))
            if recall_policy is None else recall_policy)
        #: deterministic fault injection (serve/faults.py; KNN_FAULTS env)
        self.faults = faults if faults is not None else FaultInjector.from_env()
        self.admission = AdmissionController(
            max_queue_rows=max_queue_rows,
            default_timeout_s=default_timeout_s)
        if self.tenants is not None:
            # per-tenant row-budget slices of the same controller; 0 =
            # tenants unsliced (global cap only) until set_quota is called
            self.quotas = TenantQuotas(
                self.admission, default_quota_rows=tenant_quota_rows)
        self.graceful = (GracefulQueryFn(engine) if query_fn is None
                         else query_fn)
        #: certified query cache (serve/qcache.py): exact-hit reuse,
        #: in-flight dedup, triangle-inequality radius seeds.
        #: ``qcache_rows=0`` turns the whole layer off; a CUSTOM query_fn
        #: keeps the hit/dedup tiers but disables seeding (seed vectors
        #: are the only tier that changes the query_fn call signature)
        self.qcache = None
        if qcache_rows:
            self.qcache = QueryCache(
                capacity_rows=qcache_rows,
                seed_rows=(qcache_seed_rows if query_fn is None else 0),
                fingerprint=(f"{engine.engine_name}:n={engine.n_points}"
                             f":k={engine.k}:dim={engine.dim}"))
        # depth 2 by default: batch t+1's device traversal overlaps batch
        # t's host merge/demux (results identical to depth 1 — the pipeline
        # reorders nothing, it only overlaps). See docs/SERVING.md.
        self.batcher = DynamicBatcher(self.graceful,
                                      max_batch=engine.max_batch,
                                      max_delay_s=max_delay_s,
                                      timers=engine.timers,
                                      pipeline_depth=pipeline_depth,
                                      # stall-aware flush floor: slivers
                                      # below the narrowest shape bucket
                                      # keep coalescing while the pipe is
                                      # busy (serve/batcher.py)
                                      min_batch=engine.shape_buckets[0],
                                      qcache=self.qcache)
        self.admission.pipeline_rows_fn = self.batcher.inflight_rows
        if self.batcher.pipelined and hasattr(engine, "set_launch_workers"):
            # let the engine keep as many programs in flight as the
            # pipeline can hand it (its async-program-queue stand-in)
            engine.set_launch_workers(pipeline_depth)
        self.metrics = ServingMetrics()
        self.ready = False
        self.verbose = verbose
        self._loop_entered = False
        super().__init__(addr, _Handler)

    def serve_forever(self, poll_interval=0.5):
        self._loop_entered = True
        super().serve_forever(poll_interval)

    def close(self):
        self.batcher.shutdown()
        # BaseServer.shutdown() waits on an event only serve_forever() sets —
        # calling it when the loop was never entered (warmup failed, Ctrl-C
        # during warmup) would hang forever instead of exiting
        if self._loop_entered:
            self.shutdown()
        self.server_close()


class JsonHttpHandler(BaseHTTPRequestHandler):
    """Handler plumbing (keep-alive, quiet logging, body helpers, fault
    injection) of every serving endpoint: this server, the pod front end
    and the routed host servers (serve/frontend.py)."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str, extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj, extra=()):
        self._send(code, json.dumps(obj).encode(), "application/json", extra)

    # chunked-response writer: ``_send`` always sets Content-Length, which
    # materializes the whole body up front, the transient copy a routed
    # host's /slab_rows avoids. These three stream an HTTP/1.1 chunked
    # body instead (http.client reassembles it on the pull side).
    def _start_chunked(self, code: int, ctype: str, extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()

    def _write_chunk(self, data: bytes):
        if data:
            self.wfile.write(b"%x\r\n" % len(data))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

    def _end_chunked(self):
        self.wfile.write(b"0\r\n\r\n")

    def _apply_fault(self, path: str) -> bool:
        """Consult the server's FaultInjector (if any) for this request;
        True when an injected fault consumed it (serve/faults.py)."""
        inj = getattr(self.server, "faults", None)
        if inj is None or not inj.active():
            return False
        return apply_http_fault(
            self, inj.decide(path, getattr(self, "command", "") or ""))


class _Handler(JsonHttpHandler):

    # ------------------------------------------------------------------ GET
    def do_GET(self):
        srv: KnnServer = self.server
        path = urlparse(self.path).path
        if path == "/healthz":
            if srv.ready:
                self._send_json(200, {"status": "ok",
                                      "engine": srv.engine.engine_name})
            else:
                self._send_json(503, {"status": "warming"})
        elif path == "/stats":
            out = {
                "engine": srv.engine.stats(),
                "batcher": srv.batcher.stats(),
                "admission": srv.admission.stats(),
                "server": dict(srv.metrics.snapshot(),
                               request_latency=srv.metrics.latency.report()),
                "recall": dict(srv.metrics.recall_snapshot(),
                               policy=srv.recall_policy.stats()),
            }
            if srv.qcache is not None:
                out["qcache"] = srv.qcache.stats()
            if srv.tenants is not None:
                out["tenants"] = self._tenant_stats(srv)
            self._send_json(200, out)
        elif path == "/metrics":
            self._send(200, self._prometheus(srv).encode(),
                       "text/plain; version=0.0.4")
        elif (srv.tenants is not None and path.startswith("/v1/")
                and path.endswith("/stats")
                and len(path.split("/")) == 4):
            name = path.split("/")[2]
            if name not in srv.tenants:
                self._send_json(404, {"error": f"no such tenant {name!r}",
                                      "tenants": srv.tenants.names()})
                return
            self._send_json(200, dict(self._tenant_stats(srv)[name],
                                      tenant=name))
        else:
            self._send_json(404, {"error": f"no such path {path}"})

    @staticmethod
    def _tenant_stats(srv: KnnServer) -> dict:
        """The per-tenant /stats namespace: each tenant's server-side
        counters + latency, quota state, and engine view (index geometry
        plus its pool residency/stall share)."""
        counters = srv.metrics.tenant_snapshot()
        quota = srv.quotas.stats()["tenants"] if srv.quotas is not None else {}
        engine_tenants = srv.engine.stats().get("tenants", {})
        out = {}
        for name in srv.tenants.names():
            out[name] = {
                "server": dict(
                    counters.get(name, {}),
                    request_latency=srv.metrics.tenant_latency_report(name)),
                "quota": quota.get(name, {
                    "quota_rows": srv.quotas.quota(name)
                    if srv.quotas is not None else 0,
                    "inflight_rows": 0, "rejected": 0}),
                "engine": engine_tenants.get(name, {}),
            }
        return out

    @staticmethod
    def _prometheus(srv: KnnServer) -> str:
        e, b, a = srv.engine.stats(), srv.batcher.stats(), srv.admission.stats()
        lines = []
        # per-tenant twins of each counter family ride as {tenant=}
        # labels right under the unlabeled (aggregate) series; empty on
        # single-index servers, so their text output is unchanged
        tsnap = srv.metrics.tenant_snapshot()
        for name, val in srv.metrics.snapshot().items():
            lines += [f"# TYPE {name} counter", f"{name} {val}"]
            lines += [f'{name}{{tenant="{t}"}} {tsnap[t][name]}'
                      for t in sorted(tsnap) if name in tsnap[t]]
        # engine-side cumulative counters: bytes fetched across the host
        # link and result rows completed — the device-vs-host merge
        # placement shows up as fetch_bytes/result_rows shrinking ~R x
        # tile-skip accounting (tile-row units, serve/engine.py): executed
        # vs skipped is the radius prune's win as a number — the locality
        # bench's gate, and the dashboard signal that query traffic has
        # gone spatially incoherent (skipped falling toward zero)
        for name, val in (("knn_fetch_bytes_total", e["fetch_bytes"]),
                          ("knn_result_rows_total", e["result_rows"]),
                          ("knn_tiles_executed_total", e["tiles_executed"]),
                          ("knn_tiles_skipped_total", e["tiles_skipped"]),
                          # cumulative seconds the dispatch worker spent
                          # blocked on the pipeline-depth bound (a proper
                          # counter — the gauge twins below predate it and
                          # stay for dashboard compat)
                          ("knn_dispatch_stall_seconds_total",
                           b["dispatch_stall_seconds"]),
                          ("knn_dispatch_stalls_total",
                           b["dispatch_stalls"])):
            lines += [f"# TYPE {name} counter", f"{name} {val}"]
        # per-score-mode tile attribution: which scorer (MXU matmul-form
        # vs VPU elementwise) burned the executed tiles — the kernel-bench
        # speedup's dashboard counterpart
        lines += ["# TYPE knn_tiles_executed_by_mode_total counter"] + [
            f'knn_tiles_executed_by_mode_total{{mode="{m}"}} '
            f'{e[f"tiles_executed_{m}"]}' for m in ("mxu", "vpu")]
        lines += ["# TYPE knn_tiles_skipped_by_mode_total counter"] + [
            f'knn_tiles_skipped_by_mode_total{{mode="{m}"}} '
            f'{e[f"tiles_skipped_{m}"]}' for m in ("mxu", "vpu")]
        lines += ["# TYPE knn_merge_mode gauge",
                  f'knn_merge_mode{{mode="{e["merge"]}"}} 1']
        lines += ["# TYPE knn_score_dtype gauge",
                  f'knn_score_dtype{{dtype="{e["score_dtype"]}"}} 1']
        lines += ["# TYPE knn_query_buckets gauge"] + [
            f'knn_query_buckets{{qpad="{q}"}} {b}'
            for q, b in e["query_buckets"].items()]
        gauges = {
            "knn_ready": int(srv.ready),
            "knn_engine_degraded": int(e["degraded_reason"] is not None),
            "knn_compile_count": e["compile_count"],
            "knn_index_points": e["n_points"],
            "knn_num_shards": e["num_shards"],
            "knn_queue_rows": b["queue_rows"],
            "knn_inflight_rows": a["inflight_rows"],
            "knn_admission_rejected_total": a["rejected"],
            "knn_batches_total": b["batches"],
            "knn_batch_rows_served_total": b["rows_served"],
            # pipeline occupancy: configured depth, batches/rows currently
            # between dispatch and demux, and cumulative dispatch stalls
            # (dispatch worker blocked on the depth bound)
            "knn_pipeline_depth": b["pipeline_depth"],
            "knn_pipeline_inflight_batches": b["inflight_batches"],
            "knn_pipeline_inflight_rows": b["inflight_rows"],
            "knn_pipeline_dispatch_stalls_total": b["dispatch_stalls"],
            "knn_pipeline_dispatch_stall_seconds_total":
                b["dispatch_stall_seconds"],
        }
        for name, val in gauges.items():
            lines += [f"# TYPE {name} gauge", f"{name} {val}"]
        # certified query cache (serve/qcache.py): the three reuse tiers'
        # counters with {tenant=} twins on multi-tenant servers — absent
        # when the cache is off, so those servers' text is unchanged
        lines += qcache_prometheus_lines(srv.qcache)
        # tiered slab index (serve/slabpool.py): per-tier residency,
        # promotion/eviction totals, stream-stall accounting — absent for
        # fully-resident engines
        lines += slab_pool_prometheus_lines(e)
        # multi-index tenancy: per-tenant pool occupancy/stall shares and
        # admission-quota state — absent on single-index servers
        lines += _tenant_prometheus_lines(srv, e)
        # recall-SLO tier: exact/approx request split plus the calibrated
        # recall_estimated distribution of the approximate responses
        lines += srv.metrics.recall_prometheus_lines()
        lines += srv.metrics.latency.prometheus_lines(
            "knn_request_latency_seconds")
        for src, prom in (("engine_batch_seconds",
                           "knn_engine_batch_seconds"),
                          ("pipeline_stall_seconds",
                           "knn_pipeline_stall_seconds")):
            hist = srv.engine.timers.histograms.get(src)
            if hist is not None:
                lines += hist.prometheus_lines(prom)
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------ POST
    def _parse_body(self):
        """-> (queries, want_neighbors, timeout_s, recall, tenant,
        binary)."""
        return parse_knn_body(self.path, self.headers, self.rfile,
                              dim=getattr(self.server.engine, "dim", 3))

    @staticmethod
    def _tenant_path(path: str) -> str | None:
        """The <tenant> of a ``/v1/<tenant>/knn`` POST path (None when
        the path is not tenant-scoped)."""
        parts = path.split("/")
        if (len(parts) == 4 and parts[0] == "" and parts[1] == "v1"
                and parts[2] and parts[3] == "knn"):
            return parts[2]
        return None

    def do_POST(self):
        srv: KnnServer = self.server
        path = urlparse(self.path).path
        path_tenant = self._tenant_path(path)
        if path != "/knn" and path_tenant is None:
            self._send_json(404, {"error": "POST /knn only"})
            return
        if path_tenant is not None and srv.tenants is None:
            self._send_json(404, {
                "error": f"no tenant namespaces on a single-index server "
                         f"(POST /knn); got {path}"})
            return
        if self._apply_fault("/knn"):
            return
        t0 = time.perf_counter()
        try:
            q, want_nbrs, timeout_s, recall, tenant, binary = (
                self._parse_body())
        except (ValueError, json.JSONDecodeError) as e:
            srv.metrics.inc("knn_requests_total")
            srv.metrics.inc("knn_badrequest_total")
            self._send_json(400, {"error": str(e)})
            return
        # tenant resolution: URL > JSON field / header > default. On a
        # single-index server the field is ignored entirely (the legacy
        # wire, byte for byte); on a multi-tenant server every request
        # lands on exactly one named tenant and strangers are a 404
        name = None
        if srv.tenants is not None:
            name = path_tenant or tenant or srv.engine.default_tenant
            if name not in srv.tenants:
                srv.metrics.inc("knn_requests_total")
                srv.metrics.inc("knn_unknown_tenant_total")
                self._send_json(404, {"error": f"no such tenant {name!r}",
                                      "tenants": srv.tenants.names()})
                return
        srv.metrics.inc("knn_requests_total", tenant=name)
        # recall-SLO resolution: a target of 1.0 (or one no calibrated plan
        # meets) falls through to plan=None — the exact path, untouched
        plan = (srv.recall_policy.plan_for(recall)
                if recall is not None else None)
        timeout_s = timeout_s or srv.admission.default_timeout_s
        n = len(q)
        if n > srv.engine.max_batch:
            srv.metrics.inc("knn_badrequest_total", tenant=name)
            self._send_json(413, {
                "error": f"batch of {n} exceeds max_batch "
                         f"{srv.engine.max_batch}; split the request"})
            return
        if n == 0:
            if binary:
                self._send(200, b"", "application/octet-stream")
            else:
                self._send_json(200, {"dists": []})
            return
        try:
            # multi-tenant admission reserves the tenant's quota slice
            # first, then the global row cap (serve/tenancy.py); both
            # reject with the same OverloadError -> 429 + Retry-After
            admitted = (srv.quotas.admitted_rows(name, n)
                        if srv.quotas is not None
                        else srv.admission.admitted_rows(n))
            with admitted:
                dists, nbrs = srv.batcher.submit(q, timeout_s=timeout_s,
                                                 plan=plan, tenant=name)
        except OverloadError as e:
            srv.metrics.inc("knn_overload_total", tenant=name)
            self._send_json(429, {"error": str(e)},
                            extra=[("Retry-After", f"{e.retry_after_s:g}")])
            return
        except DeadlineExceeded as e:
            srv.metrics.inc("knn_deadline_total", tenant=name)
            self._send_json(504, {"error": str(e)})
            return
        except UnservableShapeError as e:
            srv.metrics.inc("knn_badrequest_total", tenant=name)
            self._send_json(413, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - the service must not die
            srv.metrics.inc("knn_error_total", tenant=name)
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        srv.metrics.inc("knn_rows_total", n, tenant=name)
        srv.metrics.note_recall(plan)
        srv.metrics.record_latency(time.perf_counter() - t0, tenant=name)
        fields, hdrs = recall_response_fields(plan, recall)
        # multi-tenant responses echo the resolved tenant (JSON field /
        # binary header); single-index responses stay byte-identical
        if name is not None:
            fields = dict(fields, tenant=name)
            hdrs = list(hdrs) + [("X-Knn-Tenant", name)]
        if binary:
            self._send(200, np.asarray(dists, "<f4").tobytes(),
                       "application/octet-stream", extra=hdrs)
        else:
            out = {"dists": np.asarray(dists, np.float64).tolist()}
            if want_nbrs:
                out["neighbors"] = np.asarray(nbrs).tolist()
            out.update(fields)
            self._send_json(200, out)


def build_server(engine, host: str = "127.0.0.1", port: int = 8080,
                 **kwargs) -> KnnServer:
    """Construct (but do not start) a KnnServer; ``port=0`` picks a free
    port (``server.server_address[1]`` reports it — how the tests run)."""
    return KnnServer((host, port), engine, **kwargs)


def serve_forever(server: KnnServer, warmup: bool = True,
                  ready=None) -> None:
    """Warm every shape bucket, mark ready, and block serving requests.
    ``ready``, if given, is called with the server just before it starts
    serving (a caller in another thread stops it with
    ``server.shutdown()``)."""
    eng = server.engine
    if warmup:
        info = eng.warmup()
        if "tenants" in info:
            # MultiTenantEngine.warmup: one launch-plan pass covers every
            # tenant (the compile-count-flat contract)
            print(f"warmup plans built: {info['compile_count']} plans "
                  f"shared across {len(info['tenants'])} tenants")
        else:
            print(f"warmup plans built: {info['per_bucket_s']} "
                  f"(seconds per bucket); query buckets "
                  f"{info['query_buckets']}; tiles executed/skipped "
                  f"{info['tiles_executed']}/{info['tiles_skipped']}")
    server.ready = True
    host, port = server.server_address[:2]
    print(f"serving kNN on http://{host}:{port} "
          f"(engine={eng.engine_name}, k={eng.k}, n={eng.n_points}, "
          f"dim={eng.dim}, score={eng.score_dtype}, "
          f"morton_sort={'on' if eng.sort_queries else 'off'})")
    if ready is not None:
        ready(server)
    server.serve_forever()
