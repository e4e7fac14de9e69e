#!/usr/bin/env python3
"""Load generator for the port's kNN serving layer (importable).

The PyTorch port's copy of the JAX package's ``tools/loadgen.py``: the
same workloads, flags, request streams and report, run as its own process
against ``python -m mpi_cuda_largescaleknn_torch.cli.serve_main`` (or the
port's pod front end), so its clients never share the server's
interpreter. It imports nothing of the package but ``LatencyHistogram``
(``mpi_cuda_largescaleknn_torch/obs/timers.py``), and no torch: a loadgen
process starts in well under a second and touches no device.

Closed loop (default): N workers fire back-to-back requests — measures the
server's saturated throughput and the latency it costs. Open loop: requests
fire on a fixed-rate schedule regardless of completions — measures latency
at a target offered load, the regime where queueing (and admission's 429
shedding) actually shows. Both report q/s, rows/s and p50/p95/p99 from the
same obs/timers.py LatencyHistogram the server exports on /metrics, so
client-side and server-side percentiles line up bucket-for-bucket.

Workloads (``--workload``): ``uniform`` draws every query independently in
[0, scale)^3 — spatially incoherent traffic, the radius prune's worst case.
``clustered`` draws ``--blobs`` Gaussian blob centers from the same box
(``--scale`` stands in for the index bounding box — match it to the data)
and each REQUEST samples one blob with ``--blob-sigma`` spread: the
one-user-one-region pattern the serving engine's Morton-sorted multi-bucket
traversal exists to exploit (``/stats`` ``tiles_executed`` /
``tiles_skipped`` compare them). ``sweep`` drifts a blob window along the
box diagonal over ``--sweep-period`` seconds: the hot region MOVES, so a
tiered slab index (serve/slabpool.py) churns through real
eviction/readmission cycles — clustered/uniform never evict once warm.

    python tools/torch_loadgen.py --url http://127.0.0.1:8080 --duration 10 \
        --concurrency 8 --batch 16 [--qps 500] [--workload clustered] \
        [--neighbors] [--out rep.json]
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
import urllib.request
from urllib.parse import urlparse

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root when run as a file

from mpi_cuda_largescaleknn_torch.obs.timers import LatencyHistogram  # noqa: E402


class _Client:
    """One worker's persistent HTTP/1.1 connection to the server.

    The server speaks keep-alive; reusing one socket per worker drops the
    per-request TCP connect AND the per-connection handler thread the
    threading server would otherwise spawn — so the measurement (and any
    real client) pays for kNN, not connection churn. Any transport error
    tears the socket down and the next request reconnects.
    """

    def __init__(self, url: str, timeout_s: float):
        p = urlparse(url if "//" in url else "//" + url)
        self._https = p.scheme == "https"
        self._host = p.hostname or "127.0.0.1"
        self._port = p.port or (443 if self._https else 80)
        #: URL path prefix, kept so a reverse-proxied server
        #: (http://host/prefix -> /prefix/knn) still routes
        self._prefix = p.path.rstrip("/")
        self._timeout_s = timeout_s
        self._conn: http.client.HTTPConnection | None = None

    def _request(self, path: str, body: bytes, ctype: str):
        if self._conn is None:
            conn_cls = (http.client.HTTPSConnection if self._https
                        else http.client.HTTPConnection)
            self._conn = conn_cls(
                self._host, self._port, timeout=self._timeout_s)
        path = self._prefix + path
        try:
            self._conn.request("POST", path, body=body,
                               headers={"Content-Type": ctype})
            resp = self._conn.getresponse()
            payload = resp.read()  # must drain to reuse the socket
            return resp.status, payload, resp.headers
        except Exception:
            self.close()  # poisoned socket: reconnect on the next request
            raise

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def post_batch(self, queries: np.ndarray, neighbors: bool,
                   binary: bool, recall: float | None = None,
                   tenant: str | None = None):
        """-> (status, degraded, retry_after_s|None, tier|None).

        ``degraded`` is the server's HOST-LOSS exactness flag for a 200
        (the pod front end's degraded partial answers under
        --on-host-loss degrade) — a recall-SLO approximate answer is NOT
        degraded: it carries a plan (``recall_plan`` in JSON,
        ``X-Knn-Recall-Plan`` in binary) and lands in ``tier`` instead.
        ``recall`` attaches the request's recall-SLO target (JSON body
        key; query string for binary — the octet codec's only option
        channel); ``tier`` then reports the server's resolution:
        ``{"exact": bool, "recall_estimated": float|None, "plan":
        str|None}``. ``retry_after_s`` echoes a Retry-After header so the
        load loop can honor 503/429 backpressure instead of hammering a
        draining pod. ``tenant`` routes the request to a multi-index
        server's ``/v1/<tenant>/knn`` namespace (docs/SERVING.md
        'Multi-index tenancy'); None keeps the legacy ``/knn`` path."""
        tier = None
        knn_path = f"/v1/{tenant}/knn" if tenant else "/knn"
        if binary:
            # raw f32 xyz triples in, raw f32 distances out — the server's
            # octet-stream format. Skips both sides' JSON encode/decode, so
            # the client measures the engine, not the text codec (neighbors
            # ride the query string; only the JSON response carries them)
            opts = [o for o in (
                "neighbors=1" if neighbors else "",
                f"recall={recall:g}" if recall is not None else "") if o]
            status, payload, headers = self._request(
                knn_path + ("?" + "&".join(opts) if opts else ""),
                np.ascontiguousarray(queries, np.float32).tobytes(),
                "application/octet-stream")
            degraded = False
            if status == 200:
                np.frombuffer(payload, np.float32)
                plan = headers.get("X-Knn-Recall-Plan")
                degraded = (headers.get("X-Knn-Exact") == "0"
                            and plan is None)
                if recall is not None:
                    est = headers.get("X-Knn-Recall-Estimated")
                    tier = {"exact": headers.get("X-Knn-Exact") != "0",
                            "recall_estimated": (float(est)
                                                 if est is not None
                                                 else None),
                            "plan": plan}
        else:
            body = {"queries": queries.tolist(), "neighbors": neighbors}
            if recall is not None:
                body["recall"] = recall
            status, payload, headers = self._request(
                knn_path, json.dumps(body).encode(), "application/json")
            obj = json.loads(payload.decode())
            degraded = (status == 200 and obj.get("exact") is False
                        and "recall_plan" not in obj)
            if status == 200 and recall is not None:
                tier = {"exact": obj.get("exact") is not False,
                        "recall_estimated": obj.get("recall_estimated"),
                        "plan": obj.get("recall_plan")}
        ra = headers.get("Retry-After")
        try:
            retry_after_s = float(ra) if ra is not None else None
        except ValueError:
            retry_after_s = None
        return status, degraded, retry_after_s, tier


def _server_pipeline_stats(url: str, timeout_s: float) -> dict | None:
    """Scrape /stats and project the pipeline-occupancy view the report
    embeds: configured depth, in-flight occupancy, dispatch stalls, mean
    batch width. None (JSON null) when the server has no /stats."""
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/stats",
                                    timeout=timeout_s) as r:
            stats = json.loads(r.read().decode())
    except Exception:  # noqa: BLE001 - stats are optional decoration
        return None
    b = stats.get("batcher", {})
    return {
        "pipeline_depth": b.get("pipeline_depth"),
        "pipelined": b.get("pipelined"),
        "inflight_batches": b.get("inflight_batches"),
        "inflight_rows": b.get("inflight_rows"),
        "dispatch_stalls": b.get("dispatch_stalls"),
        "dispatch_stall_seconds": b.get("dispatch_stall_seconds"),
        "batches": b.get("batches"),
        "mean_batch_rows": b.get("mean_batch_rows"),
        "engine": stats.get("engine", {}).get("engine"),
        "compile_count": stats.get("engine", {}).get("compile_count"),
        # merge placement + cumulative fetch accounting: a host-vs-device
        # merge comparison derives bytes-per-row from these
        "merge": stats.get("engine", {}).get("merge"),
        "fetch_bytes": stats.get("engine", {}).get("fetch_bytes"),
        "result_rows": stats.get("engine", {}).get("result_rows"),
        # query-locality surface: bucketing config + tile-skip counters
        # (tile-row units) — the locality bench's primary signal
        "query_buckets": stats.get("engine", {}).get("query_buckets"),
        "sort_queries": stats.get("engine", {}).get("sort_queries"),
        "tiles_executed": stats.get("engine", {}).get("tiles_executed"),
        "tiles_skipped": stats.get("engine", {}).get("tiles_skipped"),
        # shard-local routing surface (pod front ends with
        # --routing bounds): routed-row share per host — clustered traffic
        # skews it toward the hosts owning the hot regions — plus the
        # escalation rate and mean hosts visited per query, so one loadgen
        # run shows clustered-vs-uniform routing behavior end to end
        **_routing_projection(stats),
        # wire-codec surface (serve/wire.py): which codec each endpoint
        # negotiated and the observed exchange bytes-per-row — the
        # compression ratio as measured by the server, not the bench
        **_wire_projection(stats),
        # certified query-cache surface (serve/qcache.py): how much
        # device work the exact-hit / dedup / radius-seeding tiers
        # actually removed, per the server's own counters
        **_qcache_projection(stats),
    }


def _qcache_projection(stats: dict) -> dict:
    """Hit/seed/dedup rates from the server's qcache block. Hit rate is
    over lookups (hits + misses); seed rate is the fraction of MISSED
    rows that still got a certified radius seed — the triangle-inequality
    tier's coverage of the revisit stream. An old server (or one launched
    with --qcache-rows 0) has no block and projects nothing."""
    qc = stats.get("qcache")
    if not qc:
        return {}
    lookups = qc.get("hits", 0) + qc.get("misses", 0)
    return {
        "qcache_hits": qc.get("hits"),
        "qcache_misses": qc.get("misses"),
        "qcache_hit_rate": (round(qc.get("hits", 0) / lookups, 4)
                            if lookups else None),
        "qcache_seeds": qc.get("seeds"),
        "qcache_seed_rate": (round(qc.get("seeds", 0) / qc["misses"], 4)
                             if qc.get("misses") else None),
        "qcache_dedup_rows": qc.get("dedup_rows"),
        "qcache_evictions": qc.get("evictions"),
        "qcache_size_rows": qc.get("size_rows"),
    }


def _wire_projection(stats: dict) -> dict:
    """Codec-in-use + bytes-per-row per (path, codec). Reads a pod front
    end's fan-out table (``fanout.wire``: mode, per-url negotiation,
    traffic) or a single host's root ``wire_traffic`` block; an old
    server has neither and projects nothing."""
    out: dict = {}
    fan = stats.get("fanout", {}).get("wire")
    if fan:
        out["wire_mode"] = fan.get("mode")
        out["wire_negotiated"] = fan.get("negotiated")
        traffic = fan.get("traffic")
    else:
        traffic = stats.get("wire_traffic")
    if traffic:
        out["wire_bytes_per_row"] = {
            f"{path}:{codec}": cell.get("bytes_per_row")
            for path, codecs in traffic.items()
            for codec, cell in codecs.items()
            if "bytes_per_row" in cell}
    return out


def _routing_projection(stats: dict) -> dict:
    routing = stats.get("fanout", {}).get("routing")
    if not routing:
        return {}
    rr = routing.get("routed_rows", {})
    total = sum(rr.values())
    rows_served = stats.get("batcher", {}).get("rows_served", 0)
    return {
        "routing_mode": routing.get("mode"),
        "routing_escalations": routing.get("escalations"),
        "routing_escalation_rate": (
            round(routing.get("escalations", 0) / rows_served, 4)
            if rows_served else None),
        "routed_rows": rr,
        "routed_row_share": {u: round(v / total, 4) for u, v in rr.items()}
        if total else {},
        "hosts_per_query_mean": routing.get("hosts_per_query_mean"),
    }


def run_load(url: str, *, duration_s: float = 5.0, concurrency: int = 4,
             batch: int = 8, qps: float = 0.0, neighbors: bool = False,
             timeout_s: float = 10.0, seed: int = 0,
             scale: float = 1.0, server_stats: bool = False,
             binary: bool = False, workload: str = "uniform",
             blobs: int = 16, blob_sigma: float = 0.02,
             sweep_period_s: float = 2.0,
             hosts: list[str] | None = None,
             retry_after_cap_s: float = 1.0,
             recall: float | None = None,
             tenants: list[str] | None = None,
             tenant_skew: float = 0.0,
             dup_frac: float = 0.0,
             revisit_sigma: float = 0.0) -> dict:
    """Drive the server; returns the JSON-able report (also the test API).

    ``qps > 0`` switches to open loop: the request schedule is fixed at
    ``qps`` requests/s, spread over the workers; a worker that falls behind
    skips ahead (lost sends are counted) rather than silently compressing
    the offered load. ``server_stats`` appends a post-run /stats scrape of
    the server's pipeline occupancy (depth, stalls, mean batch width) so
    one artifact carries both sides of a throughput run.

    ``workload="clustered"`` draws each request's queries from one of
    ``blobs`` Gaussian blobs (centers uniform in the [0, scale)^3 box,
    per-axis sigma ``blob_sigma * scale``, samples clipped to the box);
    concurrent workers hit different blobs, so a coalesced server batch
    mixes a few tight clusters — the locality pattern the engine's Morton
    admission separates back out.

    ``hosts`` switches to round-robin multi-endpoint mode: each worker
    holds one persistent connection per endpoint and rotates requests
    across them (front-end-BYPASS — point it at independent replica
    servers, NOT at one pod's slice servers, whose /shard_knn protocol is
    collective). The report then carries per-endpoint p50/p95/p99 AND
    per-endpoint availability / degraded_rate next to the aggregate —
    under a rolling host kill the aggregate can look healthy while one
    endpoint serves every degraded answer; the per-endpoint split is how
    the replica bench reads which host actually absorbed the loss.

    ``retry_after_cap_s`` caps how long a closed-loop worker honors a
    server's Retry-After on 503/429 (default 1.0 s): a chaos/replica
    bench must not park its workers past the measurement window, while a
    patient production client can raise it to the server's real drain
    horizon.

    ``workload="sweep"`` drives a WINDOW of blob centers drifting along
    the index box's main diagonal over ``sweep_period_s`` (wrapping):
    each request samples a blob around the current window position, so
    the hot slab set MOVES through the index — the churn pattern that
    forces a tiered slab pool (serve/slabpool.py) through real
    eviction/readmission cycles, where clustered/uniform streams never
    evict again once warm.

    ``dup_frac``/``revisit_sigma`` shape the stream for the certified
    query cache (serve/qcache.py): every FRESH batch enters a bounded
    shared pool of issued batches. With probability ``dup_frac`` a
    request replays a pooled batch byte-identically — the exact-hit and
    in-flight-dedup tiers' traffic. With ``revisit_sigma > 0`` three
    quarters of the remaining requests re-ask a pooled batch jittered
    by a per-row Gaussian of sigma ``revisit_sigma * scale`` (the last
    quarter stays fresh draws so the pool keeps churning) —
    near-duplicates the triangle-inequality radius-seeding tier
    certifies. The report's ``server`` scrape then projects the cache's
    own hit/seed/dedup rates next to the measured q/s (docs/SERVING.md
    "Query cache & radius seeding").

    ``tenants`` switches to multi-index mode against a tenanted server
    (serve/tenancy.py): each request picks a tenant name and posts to
    ``/v1/<tenant>/knn``. ``tenant_skew`` is the zipf exponent ``a`` of
    the pick distribution — weight of rank-i tenant is 1/(i+1)^a, so
    rank 0 is the hot tenant and the tail goes cold as ``a`` grows
    (0 = uniform). The report then carries a per-tenant
    availability/p50/p99 split plus a hot/cold rollup (hot = rank 0,
    cold = everything else aggregated) — the read the tenancy bench
    uses to bound a cold tenant's p99 under one shared byte budget.
    """
    if workload not in ("uniform", "clustered", "sweep"):
        raise ValueError(f"unknown workload '{workload}'")
    endpoints = list(hosts) if hosts else [url]
    # blob centers are seed-deterministic and shared by all workers; each
    # request picks a blob, so the stream is a mixture of tight clusters.
    # Query draws use a PER-WORKER Generator (numpy Generators are not
    # thread-safe — concurrent draws from a shared one can corrupt state)
    centers = np.random.default_rng(seed).random((max(1, blobs), 3)) * scale
    t_start = time.monotonic()
    hist = LatencyHistogram()
    ep_hists = {u: LatencyHistogram() for u in endpoints}
    lock = threading.Lock()
    counts = {"ok": 0, "degraded": 0, "overload": 0, "deadline": 0,
              "unavailable": 0, "http_error": 0,
              "net_error": 0, "rows_ok": 0, "sched_skipped": 0,
              "approx": 0}
    status_counts: dict[str, int] = {}
    #: recall-SLO accounting: per-plan approx counts and the server's
    #: claimed recall_estimated distribution over the approx 200s
    recall_plan_counts: dict[str, int] = {}
    recall_est_counts: dict[str, int] = {}
    ep_counts = {u: {"requests": 0, "ok": 0, "errors": 0, "degraded": 0,
                     "rejected": 0}
                 for u in endpoints}
    # multi-index mode: zipf pick weights — rank-i tenant draws
    # 1/(i+1)^tenant_skew of the traffic (skew 0 = uniform), so rank 0
    # is the hot tenant and the tail goes cold as the exponent grows
    tenant_names = list(tenants) if tenants else []
    if len(set(tenant_names)) != len(tenant_names):
        raise ValueError("duplicate tenant names")
    tenant_weights = None
    if tenant_names:
        w = np.array([1.0 / (i + 1) ** tenant_skew
                      for i in range(len(tenant_names))])
        tenant_weights = w / w.sum()
    tenant_hists = {t: LatencyHistogram() for t in tenant_names}
    tenant_counts = {t: {"requests": 0, "ok": 0, "rejected": 0,
                         "net_errors": 0}
                     for t in tenant_names}
    hc_hists = {"hot": LatencyHistogram(), "cold": LatencyHistogram()}
    # query-reuse pool (serve/qcache.py workloads): fresh batches are
    # remembered here so --dup-frac can replay one byte-identically and
    # --revisit can re-ask one jittered; bounded, random-replacement so
    # long runs keep mixing recent and old anchors
    issued_pool: list[np.ndarray] = []
    issued_cap = 64
    stop_at = time.monotonic() + duration_s

    def account(endpoint: str, status: int, dt: float, rows: int,
                degraded: bool = False, tier: dict | None = None,
                tenant: str | None = None):
        hist.record(dt)
        ep_hists[endpoint].record(dt)
        if tenant is not None:
            tenant_hists[tenant].record(dt)
            hc_hists["hot" if tenant == tenant_names[0]
                     else "cold"].record(dt)
        with lock:
            if tenant is not None:
                tenant_counts[tenant]["requests"] += 1
                if status == 200:
                    tenant_counts[tenant]["ok"] += 1
                else:
                    tenant_counts[tenant]["rejected"] += 1
            ep_counts[endpoint]["requests"] += 1
            status_counts[str(status)] = status_counts.get(str(status), 0) + 1
            if status == 200:
                counts["ok"] += 1
                counts["rows_ok"] += rows
                ep_counts[endpoint]["ok"] += 1
                if degraded:
                    counts["degraded"] += 1
                    ep_counts[endpoint]["degraded"] += 1
                if tier is not None and not tier["exact"]:
                    counts["approx"] += 1
                    plan = tier.get("plan") or "?"
                    recall_plan_counts[plan] = (
                        recall_plan_counts.get(plan, 0) + 1)
                    est = tier.get("recall_estimated")
                    if est is not None:
                        key = f"{est:g}"
                        recall_est_counts[key] = (
                            recall_est_counts.get(key, 0) + 1)
            elif status == 429:
                counts["overload"] += 1
            elif status == 503:
                counts["unavailable"] += 1
            elif status == 504:
                counts["deadline"] += 1
            else:
                counts["http_error"] += 1
            if status != 200:
                ep_counts[endpoint]["rejected"] += 1

    def one_request(pick_client, rng: np.random.Generator):
        """Fire one request; returns a Retry-After backoff (seconds) the
        caller should honor, or None."""
        q = None
        if dup_frac > 0 or revisit_sigma > 0:
            with lock:
                prev = (issued_pool[int(rng.integers(len(issued_pool)))]
                        if issued_pool else None)
            if prev is not None:
                u = rng.random()
                if u < dup_frac:
                    # byte-identical replay: the exact-hit tier (and,
                    # under enough concurrency, the in-flight dedup tier)
                    q = prev
                elif revisit_sigma > 0 and u < dup_frac + 0.75 * (
                        1.0 - dup_frac):
                    # near-duplicate revisit: the radius-seeding tier
                    q = np.clip(
                        prev + rng.normal(0.0, revisit_sigma * scale,
                                          prev.shape),
                        0.0, scale).astype(np.float32)
        if q is None:
            if workload == "clustered":
                c = centers[rng.integers(len(centers))]
                q = np.clip(
                    c + rng.normal(0.0, blob_sigma * scale, (batch, 3)),
                    0.0, scale).astype(np.float32)
            elif workload == "sweep":
                # drifting window: position along the box diagonal is a
                # pure function of elapsed time, so the hot slab set moves
                # through the index at a controlled rate
                # (eviction/readmission churn)
                frac = ((time.monotonic() - t_start) / sweep_period_s) % 1.0
                c = np.full(3, frac * scale)
                q = np.clip(
                    c + rng.normal(0.0, blob_sigma * scale, (batch, 3)),
                    0.0, scale).astype(np.float32)
            else:
                q = (rng.random((batch, 3)) * scale).astype(np.float32)
            if dup_frac > 0 or revisit_sigma > 0:
                # only FRESH batches enter the reuse pool: replays and
                # revisits anchor to originals, never to each other
                with lock:
                    if len(issued_pool) < issued_cap:
                        issued_pool.append(q)
                    else:
                        issued_pool[int(rng.integers(issued_cap))] = q
        tenant = None
        if tenant_names:
            tenant = tenant_names[int(rng.choice(len(tenant_names),
                                                 p=tenant_weights))]
        endpoint, client = pick_client()
        t0 = time.perf_counter()
        try:
            status, degraded, retry_after, tier = client.post_batch(
                q, neighbors, binary, recall=recall, tenant=tenant)
            account(endpoint, status, time.perf_counter() - t0,
                    batch if status == 200 else 0, degraded, tier,
                    tenant=tenant)
            if status in (429, 503) and retry_after:
                # honor the server's backpressure, capped by the
                # --retry-after-cap knob (an outage must not park workers
                # past the measurement window)
                return min(retry_after, retry_after_cap_s)
        except Exception:  # noqa: BLE001 - connection refused/reset, timeout
            with lock:
                counts["net_error"] += 1
                ep_counts[endpoint]["requests"] += 1
                ep_counts[endpoint]["errors"] += 1
                if tenant is not None:
                    tenant_counts[tenant]["requests"] += 1
                    tenant_counts[tenant]["net_errors"] += 1
        return None

    def make_picker(wid: int):
        """One persistent connection per endpoint per worker; round-robin
        rotation offset by worker id so concurrent workers spread load."""
        clients = {u: _Client(u, timeout_s) for u in endpoints}
        state = {"i": wid}

        def pick():
            u = endpoints[state["i"] % len(endpoints)]
            state["i"] += 1
            return u, clients[u]

        def close_all():
            for c in clients.values():
                c.close()

        return pick, close_all

    def closed_worker(wid: int):
        pick, close_all = make_picker(wid)
        wrng = np.random.default_rng((seed, wid))
        try:
            while time.monotonic() < stop_at:
                backoff = one_request(pick, wrng)
                if backoff:
                    time.sleep(min(backoff, max(0.0,
                                                stop_at - time.monotonic())))
        finally:
            close_all()

    def open_worker(wid: int):
        # worker wid owns schedule slots wid, wid+W, wid+2W, ...
        pick, close_all = make_picker(wid)
        wrng = np.random.default_rng((seed, wid))
        interval = concurrency / qps
        next_t = time.monotonic() + (wid / qps)
        try:
            while next_t < stop_at:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                elif now - next_t > interval:
                    # behind by a full slot: drop it, keep the offered rate
                    # honest
                    missed = int((now - next_t) / interval)
                    next_t += missed * interval
                    with lock:
                        counts["sched_skipped"] += missed
                    continue
                one_request(pick, wrng)
                next_t += interval
        finally:
            close_all()

    t_start = time.monotonic()
    workers = [threading.Thread(
        target=(open_worker if qps > 0 else closed_worker),
        args=(i,), daemon=True)
        for i in range(concurrency)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=duration_s + timeout_s + 30)
    elapsed = time.monotonic() - t_start
    # open loop: a sparse schedule (fractional offered q/s) can finish
    # its last slot well before the window closes — rates divide by the
    # offered window, not the early-exit wall, or a one-request run at
    # 0.1 q/s reports whatever its single latency happened to be
    if qps > 0:
        elapsed = max(elapsed, float(duration_s))

    total = sum(counts[c] for c in
                ("ok", "overload", "deadline", "unavailable", "http_error"))
    attempted = total + counts["net_error"]
    lat = hist.report()

    def _pct_ms(rep, p):
        return None if rep[p] is None else round(rep[p] * 1e3, 3)

    per_endpoint = None
    if hosts:
        per_endpoint = {}
        for u in endpoints:
            rep = ep_hists[u].report()
            c = ep_counts[u]
            per_endpoint[u] = {
                **c,
                "qps": round(c["requests"] / elapsed, 2),
                # per-endpoint availability/degraded split: under a
                # rolling kill the aggregate hides WHICH endpoint
                # absorbed the loss — this is how the replica bench
                # reads it (requests includes net errors, like the
                # aggregate's attempted denominator)
                "availability": (round(c["ok"] / c["requests"], 4)
                                 if c["requests"] else None),
                "degraded_rate": (round(c["degraded"] / c["ok"], 4)
                                  if c["ok"] else None),
                "p50_ms": _pct_ms(rep, "p50"),
                "p95_ms": _pct_ms(rep, "p95"),
                "p99_ms": _pct_ms(rep, "p99"),
            }
    tenancy = None
    if tenant_names:
        per_tenant = {}
        for i, t in enumerate(tenant_names):
            rep = tenant_hists[t].report()
            c = tenant_counts[t]
            per_tenant[t] = {
                **c,
                "rank": i,
                "share": (round(c["requests"] / attempted, 4)
                          if attempted else None),
                "availability": (round(c["ok"] / c["requests"], 4)
                                 if c["requests"] else None),
                "p50_ms": _pct_ms(rep, "p50"),
                "p95_ms": _pct_ms(rep, "p95"),
                "p99_ms": _pct_ms(rep, "p99"),
            }

        def _roll(names, h):
            req = sum(tenant_counts[t]["requests"] for t in names)
            ok = sum(tenant_counts[t]["ok"] for t in names)
            rep = h.report()
            return {"tenants": list(names), "requests": req, "ok": ok,
                    "availability": round(ok / req, 4) if req else None,
                    "p50_ms": _pct_ms(rep, "p50"),
                    "p99_ms": _pct_ms(rep, "p99")}

        # hot = the zipf rank-0 tenant, cold = everything else pooled:
        # the tenancy bench's primary read for "does a cold tenant still
        # answer inside its p99 bound under one shared byte budget"
        tenancy = {
            "tenants": len(tenant_names),
            "zipf_a": tenant_skew,
            "per_tenant": per_tenant,
            "hot_cold": {
                "hot": _roll(tenant_names[:1], hc_hists["hot"]),
                "cold": _roll(tenant_names[1:], hc_hists["cold"]),
            },
        }
    return {
        **({"server": ({u: _server_pipeline_stats(u, timeout_s)
                        for u in endpoints} if hosts
                       else _server_pipeline_stats(url, timeout_s))}
           if server_stats else {}),
        "mode": "open" if qps > 0 else "closed",
        **({"endpoint_mode": "round_robin",
            "per_endpoint": per_endpoint} if hosts else {}),
        "workload": workload,
        **({"blobs": blobs, "blob_sigma": blob_sigma}
           if workload == "clustered" else {}),
        **({"blob_sigma": blob_sigma, "sweep_period_s": sweep_period_s}
           if workload == "sweep" else {}),
        **({"dup_frac": dup_frac, "revisit_sigma": revisit_sigma}
           if (dup_frac > 0 or revisit_sigma > 0) else {}),
        "url": url, "duration_s": round(elapsed, 3),
        "concurrency": concurrency, "batch": batch, "binary": binary,
        "offered_qps": qps if qps > 0 else None,
        "requests": total, "qps": round(total / elapsed, 2),
        "rows_per_s": round(counts["rows_ok"] / elapsed, 2),
        **counts,
        # availability surface (the chaos bench's primary read): fraction
        # of ATTEMPTED requests answered 200 (degraded 200s included —
        # they are answers, flagged), the status-code breakdown, and the
        # degraded share of the 200s
        "status_counts": dict(sorted(status_counts.items())),
        "availability": (round(counts["ok"] / attempted, 4)
                         if attempted else None),
        "error_rate": (round((attempted - counts["ok"]) / attempted, 4)
                       if attempted else None),
        "degraded_rate": (round(counts["degraded"] / counts["ok"], 4)
                          if counts["ok"] else None),
        # recall-SLO surface (only when a target was offered): the
        # approx-tier share of the 200s, the q/s split by served tier,
        # and the server's claimed recall_estimated / plan distributions
        **({"recall": {
            "target": recall,
            "approx_requests": counts["approx"],
            "exact_requests": counts["ok"] - counts["approx"],
            "approx_share": (round(counts["approx"] / counts["ok"], 4)
                             if counts["ok"] else None),
            "qps_approx": round(counts["approx"] / elapsed, 2),
            "qps_exact": round(
                (counts["ok"] - counts["approx"]) / elapsed, 2),
            "plan_counts": dict(sorted(recall_plan_counts.items())),
            "recall_estimated_counts": dict(
                sorted(recall_est_counts.items())),
        }} if recall is not None else {}),
        # multi-index surface (only when --tenants was asked): per-tenant
        # availability/latency split + the hot/cold rollup
        **({"tenancy": tenancy} if tenancy is not None else {}),
        "latency_seconds": lat,
        # None (JSON null) when nothing was measured — e.g. server down,
        # every request a net_error — keeping the report strict JSON
        "p50_ms": None if lat["p50"] is None else round(lat["p50"] * 1e3, 3),
        "p95_ms": None if lat["p95"] is None else round(lat["p95"] * 1e3, 3),
        "p99_ms": None if lat["p99"] is None else round(lat["p99"] * 1e3, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:8080")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated endpoint URLs: round-robin "
                         "front-end-bypass mode with per-endpoint "
                         "p50/p95/p99 (point at independent replica "
                         "servers; for a pod, --url the front end instead)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8,
                    help="queries per request")
    ap.add_argument("--qps", type=float, default=0.0,
                    help=">0: open loop at this offered request rate")
    ap.add_argument("--neighbors", action="store_true")
    ap.add_argument("--binary", action="store_true",
                    help="octet-stream bodies (raw f32), not JSON")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="query box [0, scale)^3 (match the index bbox)")
    ap.add_argument("--workload", choices=("uniform", "clustered", "sweep"),
                    default="uniform",
                    help="uniform: every query independent in the box; "
                         "clustered: each request samples one Gaussian "
                         "blob (query locality); sweep: a blob window "
                         "drifting along the box diagonal (tiered-slab "
                         "eviction/readmission churn)")
    ap.add_argument("--blobs", type=int, default=16,
                    help="clustered: number of blob centers in the box")
    ap.add_argument("--blob-sigma", type=float, default=0.02,
                    help="clustered/sweep: per-axis blob sigma as a "
                         "fraction of --scale")
    ap.add_argument("--sweep-period", type=float, default=2.0,
                    help="sweep: seconds per full diagonal traversal "
                         "(wrapping)")
    ap.add_argument("--dup-frac", type=float, default=0.0,
                    help="fraction of requests replaying a previously "
                         "issued batch byte-identically — the certified "
                         "query cache's exact-hit / in-flight-dedup "
                         "traffic (docs/SERVING.md 'Query cache & radius "
                         "seeding')")
    ap.add_argument("--revisit", type=float, default=0.0, metavar="SIGMA",
                    help=">0: most non-duplicate requests re-ask a "
                         "previously issued batch jittered by a per-row "
                         "Gaussian of sigma SIGMA*scale — the "
                         "near-duplicate stream the cache's "
                         "triangle-inequality radius seeding certifies")
    ap.add_argument("--recall", type=float, default=None,
                    help="attach this recall-SLO target to every request "
                         "(JSON body key / binary query string); the "
                         "report then splits q/s by served tier and "
                         "carries the plan + recall_estimated "
                         "distributions (docs/SERVING.md 'Recall-SLO "
                         "tier')")
    ap.add_argument("--tenants", type=int, default=0,
                    help=">0: multi-index mode — spread requests over N "
                         "tenant namespaces /v1/<t>/knn of one tenanted "
                         "server (names t0..t{N-1} unless --tenant-names); "
                         "the report gains per-tenant and hot/cold "
                         "availability/p50/p99 splits")
    ap.add_argument("--tenant-names", default=None,
                    help="comma-separated tenant names (overrides the "
                         "t0..tN default; list order = zipf rank order, "
                         "first name is the hot tenant)")
    ap.add_argument("--tenant-skew", default="zipf:0",
                    help="traffic skew across tenants as 'zipf:a': rank-i "
                         "tenant draws weight 1/(i+1)^a (zipf:0 uniform; "
                         "zipf:1.6 one hot tenant and a cold tail)")
    ap.add_argument("--retry-after-cap", type=float, default=1.0,
                    help="max seconds a closed-loop worker honors a "
                         "Retry-After on 503/429 (default 1.0; raise for "
                         "patient-client drills)")
    ap.add_argument("--server-stats", action="store_true",
                    help="embed a post-run /stats pipeline-occupancy scrape")
    ap.add_argument("--out", default=None, help="write JSON report here")
    a = ap.parse_args(argv)

    hosts = ([h for h in a.hosts.split(",") if h] if a.hosts else None)
    if a.tenant_names:
        tenant_names = [t for t in a.tenant_names.split(",") if t]
    elif a.tenants > 0:
        tenant_names = [f"t{i}" for i in range(a.tenants)]
    else:
        tenant_names = None
    if not a.tenant_skew.startswith("zipf:"):
        ap.error("--tenant-skew must look like 'zipf:a' (e.g. zipf:1.6)")
    try:
        tenant_skew = float(a.tenant_skew.partition(":")[2])
    except ValueError:
        ap.error("--tenant-skew must look like 'zipf:a' (e.g. zipf:1.6)")
    report = run_load(a.url, duration_s=a.duration, concurrency=a.concurrency,
                      batch=a.batch, qps=a.qps, neighbors=a.neighbors,
                      timeout_s=a.timeout, seed=a.seed, scale=a.scale,
                      server_stats=a.server_stats, binary=a.binary,
                      workload=a.workload, blobs=a.blobs,
                      blob_sigma=a.blob_sigma,
                      sweep_period_s=a.sweep_period, hosts=hosts,
                      retry_after_cap_s=a.retry_after_cap,
                      recall=a.recall, tenants=tenant_names,
                      tenant_skew=tenant_skew, dup_frac=a.dup_frac,
                      revisit_sigma=a.revisit)
    text = json.dumps(report, indent=2)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
