"""Pod serving: per-host servers and the front end that fans out to them.

The port of the JAX package's ``serve/frontend.py``. Two pods:

- The routed pod (``--routing bounds``). The hosts are INDEPENDENT engines
  (no shared mesh, no collectives, no sequence order): each owns one row
  slab of the index with GLOBAL neighbor ids (``id_offset``) and serves
  full candidate rows from ``POST /route_knn`` (``engine.emit=
  'candidates'``), its kernels on its card. The front end builds a
  ``PodBoundsTable`` from every host's per-shard AABBs at startup and, per
  batch: (wave 1) sends each query to its nearest-bounds slab (and to
  every slab whose boxes contain it); folds the returned partials with the
  canonical (dist2, id) merge, commutative, so arrival order never changes
  bits; and (escalation waves) re-dispatches exactly the (query, slab)
  pairs whose box lower bound can still beat the query's current k-th
  distance, until every skipped slab is CERTIFIED unable to contribute
  (``lb * (1 - slack) > kth_dist2``; the slack covers the engines' f32
  rounding, so certification never skips a true neighbor, ties included).
  Slab sharding keeps ids ascending by host, so the answer is bitwise
  equal to one engine over all the points.
- The replicate pod (``--routing off``). H serving processes, joined into
  one ``torch.distributed`` group (``parallel/mesh.py``, the batch CLIs'
  lifecycle), each run ONE ``ResidentKnnEngine`` over the process-spanning
  ``Mesh`` with ``merge="device"``: a host traverses the batch against the
  shards of its own positions, and one ``all_to_all`` a batch
  (``parallel/ring.py`` ``merge_over_mesh``) hands each host the partial
  rows of its positions' row slices, which it merges and fetches alone
  (``engine.complete_slices``), so the pod's fetched result bytes equal
  ONE final answer. The merge is a collective, so every host must dispatch
  IDENTICAL batches in the SAME order: ``PodFanout`` replicates each
  admitted batch to every host's ``POST /shard_knn?seq=N``, and each
  ``HostSliceServer`` dispatches strictly in ``seq`` order. The fan-out
  exposes the engine's ``dispatch`` / ``complete`` split, so the front
  end's ``DynamicBatcher`` pipelines pod batches, and it records the
  straggler spread (last host minus first host a batch).

Failure handling: each host is supervised through a ``healthy -> suspect
-> drained -> rejoining`` lifecycle (serve/health.py) fed by dispatch
outcomes and the background ``HealthMonitor``'s /healthz probes. Routed:
dispatch retries transient failures (connect errors, timeouts, 5xx) with
capped exponential deterministic backoff; a host that keeps failing is
drained and routed around. ``on_host_loss`` decides the queries whose
certified routing set touches a drained slab: ``fail`` answers them 503 +
Retry-After (unaffected queries keep serving bit-identical), ``degrade``
serves the fold of the surviving hosts flagged ``exact: false``. A drained
host rejoins only after the monitor matches its config/bounds fingerprint
against the pod table captured at startup. Hosts claiming the same row
range are replicas of one slab (serve/replica.py ``ReplicaSet``); the
monitor's ``ReplicaManager`` directs a warm ``--standby`` host to adopt a
slab that fell below ``handoff_floor`` live replicas (``POST
/adopt_slab``: the slab read again from the source file or pulled from a
surviving replica) and binds it only after its fingerprint matches the
pod table. The wire between front end and routed hosts negotiates the q16
candidate codec (serve/wire.py), whose exact f32 re-merge keeps served
bits identical. Replicate: the pod is one program, so a lost host is not
degradable: the first failed post marks the stream broken
(``PodBrokenError``), requests answer 503, and the monitor resets the
stream once every host probes healthy again with a matching fingerprint
and one ``next_seq``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.request
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.obs.timers import (
    LatencyHistogram,
    PhaseTimers,
)
from mpi_cuda_largescaleknn_torch.serve.admission import (
    AdmissionController,
    DeadlineExceeded,
    OverloadError,
)
from mpi_cuda_largescaleknn_torch.serve.batcher import DynamicBatcher
from mpi_cuda_largescaleknn_torch.serve.faults import FaultInjector
from mpi_cuda_largescaleknn_torch.serve.health import (
    Backoff,
    HealthMonitor,
    HostHealth,
    host_fingerprint,
)
from mpi_cuda_largescaleknn_torch.serve.qcache import QueryCache
from mpi_cuda_largescaleknn_torch.serve.recall import RecallPolicy
from mpi_cuda_largescaleknn_torch.serve.server import (
    LISTEN_BACKLOG,
    JsonHttpHandler,
    ServingMetrics,
    parse_knn_body,
    qcache_prometheus_lines,
    recall_response_fields,
    slab_pool_prometheus_lines,
)
from mpi_cuda_largescaleknn_torch.serve.wire import (
    WireError,
    WireNegotiator,
    WireStats,
    decode_candidates_q16,
    encode_candidates_q16,
    encode_slab_chunk,
    frame_chunk,
    wire_caps,
)
from mpi_cuda_largescaleknn_torch.utils.math import aabb_lower_bound_dist2

# -------------------------------------------------------------- host side


class HostSliceServer(ThreadingHTTPServer):
    """One serving process of a pod. Serves the front end only (no public
    /knn). Two modes:

    - ``routing="off"`` (the replicate pod): ``POST /shard_knn?seq=N``
      with a raw little-endian f32 body dispatches the batch on the
      process-spanning mesh, in strict ``seq`` order (the merge is a
      collective every host must enter identically), and answers with this
      host's row slices of the pod-final result.
    - ``routing="bounds"`` (the routed pod): an independent slab engine
      (``emit='candidates'``) behind ``POST /route_knn``, which dispatches
      any sub-batch in arrival order and answers with the full candidate
      rows (d2[m, k] + ids[m, k]) the front end folds across hosts
      (``?wire=q16`` compressed, ``?wire=x32`` the exact re-fetch).
      ``standby_config`` makes it a warm standby: no engine until ``POST
      /adopt_slab`` materializes one.

    /healthz, /stats (the per-shard AABB table, ``row_offset``, the
    ``wire`` caps) and /metrics mirror the single-host server's surface;
    ``GET /slab_rows`` streams a routed host's slab rows; ``GET|POST
    /faults`` read and replace the fault rules at runtime.
    """

    daemon_threads = True
    #: how long a handler thread waits for ITS turn in the seq order before
    #: giving up (a lost lower seq means the pod is wedged anyway); the
    #: default of the constructor's knob
    seq_timeout_s = 120.0

    def __init__(self, addr, engine, *, routing: str = "off",
                 seq_timeout_s: float | None = None,
                 faults: FaultInjector | None = None,
                 standby_config: dict | None = None,
                 wire: str = "auto",
                 verbose: bool = False):
        if routing not in ("off", "bounds"):
            raise ValueError(f"routing must be 'off' or 'bounds', "
                             f"got {routing!r}")
        if wire not in ("auto", "f32"):
            raise ValueError(f"host wire mode must be 'auto' or 'f32', "
                             f"got {wire!r}")
        if seq_timeout_s is not None:
            if seq_timeout_s <= 0:
                raise ValueError(f"seq_timeout_s must be > 0, "
                                 f"got {seq_timeout_s}")
            self.seq_timeout_s = float(seq_timeout_s)
        #: "f32" = advertise and serve only the uncompressed codecs (the
        #: old-binary emulation / codec kill switch; serve_main --wire)
        self.wire_mode = wire
        #: deterministic fault injection (serve/faults.py): programmatic,
        #: or KNN_FAULTS at start, or POST /faults at runtime
        self.faults = (faults if faults is not None
                       else FaultInjector.from_env())
        #: warm-standby mode (slab handoff, serve/replica.py): the server
        #: starts with NO engine and materializes one on POST /adopt_slab
        #: from the engine-construction knobs recorded here (path, k,
        #: shards, bucket geometry, device: serve_main --standby fills it)
        self.standby_config = dict(standby_config) if standby_config else None
        if self.standby_config is not None:
            if routing != "bounds":
                raise ValueError("standby hosts serve the routed tier — "
                                 "launch with --routing bounds")
            if engine is not None:
                raise ValueError("a standby starts empty; its engine is "
                                 "materialized by POST /adopt_slab")
        elif routing == "bounds":
            if getattr(engine, "emit", "final") != "candidates":
                raise ValueError(
                    "routed host serving needs an engine built with "
                    "emit='candidates' — the front end's partial merge "
                    "folds full candidate rows, not kth distances")
            if getattr(engine, "process_count", 1) > 1:
                raise ValueError(
                    "routed hosts are independent processes — do not join "
                    "a global mesh (launch without --coordinator)")
            # the front end pipelines depth-2 sub-batches per host
            engine.set_launch_workers(2)
        self.engine = engine
        self.routing = routing
        self.ready = False
        self.verbose = verbose
        self._loop_entered = False
        self.metrics = ServingMetrics()
        #: per-(path, codec) wire byte accounting (serve/wire.py) behind
        #: /stats wire_traffic and the /metrics knn_wire_* families
        self.wire_stats = WireStats()
        self._seq_cond = threading.Condition()
        self.next_seq: guarded_by("_seq_cond") = 0
        self._adopt_lock = threading.Lock()
        # the adoption lifecycle, written by the adopt handler and its
        # background thread and read by /healthz scrapes (the replica
        # manager polls it): all access under _adopt_lock
        self.adopt_state: guarded_by("_adopt_lock") = (
            "standby" if self.standby_config is not None else None)
        self.adopt_error: guarded_by("_adopt_lock") = None
        self.adopt_slab: guarded_by("_adopt_lock") = None
        self.adopt_seconds: guarded_by("_adopt_lock") = None
        super().__init__(addr, _HostHandler)

    def serve_forever(self, poll_interval=0.5):
        self._loop_entered = True
        super().serve_forever(poll_interval)

    def close(self):
        if self._loop_entered:
            self.shutdown()
        self.server_close()

    def run_in_order(self, seq: int, queries: np.ndarray):
        """Dispatch ``queries`` as pod batch ``seq`` and fetch this host's
        slices. Dispatch (the traversal and the merge's ``all_to_all``) is
        serialized in ascending ``seq``, the pod-wide program order;
        completes overlap freely."""
        with self._seq_cond:
            deadline = time.monotonic() + self.seq_timeout_s
            while seq != self.next_seq:
                if seq < self.next_seq:
                    raise ValueError(f"seq {seq} already dispatched "
                                     f"(next is {self.next_seq})")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"seq {seq} waited {self.seq_timeout_s:.0f}s for "
                        f"seq {self.next_seq} to arrive — pod stream broken")
                self._seq_cond.wait(remaining)
            try:
                handle = self.engine.dispatch(queries)
            finally:
                # advance even on a dispatch error: the engine validates a
                # batch before its collective, so the same failure raises
                # on EVERY host (same bytes, same config) and the pod stays
                # aligned at seq+1
                self.next_seq += 1
                self._seq_cond.notify_all()
        return self.engine.complete_slices(handle)

    def next_seq_snapshot(self) -> int:
        """Locked read of the stream position for handler threads (the
        monitor's seq-consensus reset reads it through /healthz)."""
        with self._seq_cond:
            return self.next_seq

    def run_routed(self, queries: np.ndarray):
        """Routed mode: dispatch a sub-batch in arrival order (the
        engine's own lock and its CUDA stream serialize the card; nothing
        is collective, so concurrent handler threads are fine) and return
        the full candidate rows ``(d2[m, k], idx[m, k])``."""
        handle = self.engine.dispatch(queries)
        return self.engine.complete_candidates(handle)

    # ------------------------------------------------------------- handoff

    def adopt_snapshot(self) -> dict:
        """Locked view of the adoption lifecycle (None state = not a
        standby): what /healthz reports and the replica manager polls."""
        with self._adopt_lock:
            return {"state": self.adopt_state, "slab": self.adopt_slab,
                    "error": self.adopt_error,
                    "seconds": self.adopt_seconds}

    def start_adoption(self, req: dict, host_id: int,
                       num_hosts: int) -> bool:
        """Begin adopting slab ``host_id`` of ``num_hosts`` on a background
        thread (an engine build and its warmup take seconds: the handler
        answers 202 at once and the manager polls /healthz). False when an
        adoption is already running or done (409 upstream); ``failed``
        may retry."""
        with self._adopt_lock:
            if self.adopt_state not in ("standby", "failed"):
                return False
            self.adopt_state = "adopting"
            self.adopt_slab = int(host_id)
            self.adopt_error = None
        threading.Thread(target=self._run_adoption,
                         args=(dict(req), int(host_id), int(num_hosts)),
                         daemon=True, name="knn-adopt").start()
        return True

    def _run_adoption(self, req: dict, host_id: int, num_hosts: int):
        """Materialize and warm the adopted slab, then flip ready. The
        engine is assigned BEFORE ``ready``, so a handler that sees ready
        always sees the engine; any failure (a kernel's build or launch on
        the card included) parks the server in ``failed`` with the reason
        on /healthz, so the manager's fingerprint gate never sees a
        half-built host."""
        from mpi_cuda_largescaleknn_torch.serve.engine import (
            materialize_slab_engine,
        )
        from mpi_cuda_largescaleknn_torch.serve.replica import pull_slab_rows

        t0 = time.perf_counter()
        try:
            cfg = dict(self.standby_config)
            points = id_offset = None
            if req.get("source_url"):
                points, id_offset = pull_slab_rows(req["source_url"])
            eng, id_offset, _n_total = materialize_slab_engine(
                cfg.get("path"), host_id, num_hosts,
                k=cfg["k"], num_shards=cfg.get("shards") or 1,
                engine=cfg.get("engine", "auto"),
                merge=cfg.get("merge", "auto"),
                bucket_size=cfg.get("bucket_size", 0),
                max_radius=cfg.get("max_radius", float("inf")),
                max_batch=cfg.get("max_batch", 1024),
                min_batch=cfg.get("min_batch", 8),
                query_buckets=cfg.get("query_buckets", 0),
                score_dtype=cfg.get("score_dtype", "f32"),
                points=points, id_offset=id_offset, warmup=True,
                device=cfg.get("device"))
            # the adopt request carries the pod table's slab identity: a
            # file / num_hosts mismatch fails HERE, loudly, and never
            # reaches the (fingerprint-gated) bind downstream
            want_off = req.get("row_offset")
            if want_off is not None and int(want_off) != id_offset:
                raise ValueError(
                    f"adopted slab starts at row {id_offset}, the pod "
                    f"table expects {want_off} — input file or num_hosts "
                    "disagrees with the pod's split")
            want_n = req.get("n_points")
            if want_n is not None and int(want_n) != eng.n_points:
                raise ValueError(
                    f"adopted slab holds {eng.n_points} rows, the pod "
                    f"table expects {want_n}")
            eng.set_launch_workers(2)
            self.engine = eng
            self.ready = True
            with self._adopt_lock:
                self.adopt_state = "adopted"
                self.adopt_seconds = round(time.perf_counter() - t0, 3)
        except Exception as e:  # noqa: BLE001 - surfaced on /healthz
            with self._adopt_lock:
                self.adopt_state = "failed"
                self.adopt_error = f"{type(e).__name__}: {e}"


class _HostHandler(JsonHttpHandler):
    def do_GET(self):
        srv: HostSliceServer = self.server
        path = urlparse(self.path).path
        if path == "/faults":
            # the fault admin surface is always exempt from injection
            self._send_json(200, {"specs": srv.faults.config()})
            return
        if self._apply_fault(path):
            return
        if srv.engine is None:
            # warm standby (slab handoff): no slab adopted yet. /healthz
            # reports the adoption lifecycle so the replica manager can
            # poll it; everything else answers 503 until adoption lands
            snap = srv.adopt_snapshot()
            status = {"standby": "standby", "adopting": "adopting",
                      "failed": "adopt-failed"}.get(snap["state"],
                                                    "standby")
            if path == "/healthz":
                body = {"status": status, "role": "standby",
                        "routing": srv.routing, "adopt": snap}
                if snap["error"]:
                    body["adopt_error"] = snap["error"]
                self._send_json(503, body)
            elif path == "/stats":
                self._send_json(200, {"routing": srv.routing,
                                      "standby": True, "adopt": snap,
                                      "wire": wire_caps(srv.wire_mode),
                                      "server": srv.metrics.snapshot()})
            elif path == "/metrics":
                self._send(200, "# TYPE knn_ready gauge\nknn_ready 0\n"
                           .encode(), "text/plain; version=0.0.4")
            else:
                self._send_json(503, {"error": "standby host: no slab "
                                               "adopted yet"},
                                extra=[("Retry-After", "1")])
            return
        if path == "/healthz":
            body = {"status": "ok" if srv.ready else "warming",
                    "role": ("host-routed" if srv.routing == "bounds"
                             else "host-slice"),
                    "routing": srv.routing,
                    "process_index": srv.engine.process_index,
                    "next_seq": srv.next_seq_snapshot()}
            adopt = srv.adopt_snapshot()
            if adopt["state"] is not None:
                body["adopt"] = adopt
            self._send_json(200 if srv.ready else 503, body)
        elif path == "/stats":
            from mpi_cuda_largescaleknn_torch.cli.common import (
                launch_counts,
            )

            # wire caps live at the ROOT (not in the engine block), so
            # advertising a new codec can never shift the replica
            # fingerprint; ``launches``: this process's kernel launches
            self._send_json(200, {"engine": srv.engine.stats(),
                                  "routing": srv.routing,
                                  "next_seq": srv.next_seq_snapshot(),
                                  "wire": wire_caps(srv.wire_mode),
                                  "wire_traffic": srv.wire_stats.snapshot(),
                                  "server": srv.metrics.snapshot(),
                                  "launches": launch_counts()})
        elif path == "/slab_rows":
            # the slab pull path (serve/replica.py pull_slab_rows): a
            # tiered pool's url= source, or a standby adopting this slab
            pts = getattr(srv.engine, "host_points", None)
            if pts is None:
                self._send_json(404, {
                    "error": "no host-side slab rows on this server "
                             "(routed slab hosts only)"})
                return
            qs = parse_qs(urlparse(self.path).query)
            if "wire" in qs:
                self._send_slab_stream(srv, pts, qs)
                return
            # a puller without ?wire=: the single-shot f32 body, zero-copy
            # (a .tobytes() here would transiently double the slab's RAM)
            body = memoryview(np.ascontiguousarray(pts, "<f4")).cast("B")
            srv.wire_stats.add("slab_rows", "f32", len(body), len(pts))
            self._send(200, body, "application/octet-stream",
                       extra=[("X-Knn-Rows", str(len(pts))),
                              ("X-Knn-Dim", str(srv.engine.dim)),
                              ("X-Knn-Row-Offset",
                               str(srv.engine.id_offset))])
        elif path == "/metrics":
            e = srv.engine.stats()
            lines = []
            for name, val in (
                    ("knn_fetch_bytes_total", e["fetch_bytes"]),
                    ("knn_result_rows_total", e["result_rows"]),
                    ("knn_tiles_executed_total", e["tiles_executed"]),
                    ("knn_tiles_skipped_total", e["tiles_skipped"])):
                lines += [f"# TYPE {name} counter", f"{name} {val}"]
            # server-side request counters (incl. the routed-row counter
            # knn_routed_rows_total in routed mode)
            for name, val in sorted(srv.metrics.snapshot().items()):
                lines += [f"# TYPE {name} counter", f"{name} {val}"]
            for name, val in (("knn_ready", int(srv.ready)),
                              ("knn_compile_count", e["compile_count"]),
                              ("knn_num_shards", e["num_shards"]),
                              ("knn_host_process_index", e["process_index"]),
                              ("knn_host_next_seq", srv.next_seq_snapshot()),
                              ("knn_host_row_offset", e["row_offset"]),
                              ("knn_host_routed",
                               int(srv.routing == "bounds"))):
                lines += [f"# TYPE {name} gauge", f"{name} {val}"]
            # a routed host may itself STREAM sub-slabs of its row range
            # (serve_main --routing bounds --num-slabs): surface its
            # tiered-pool counters with the single-host server's renderer
            lines += slab_pool_prometheus_lines(e)
            lines += srv.wire_stats.prometheus_lines()
            self._send(200, ("\n".join(lines) + "\n").encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no such path {path}"})

    #: rows per /slab_rows stream chunk: ~768 KiB of f32 at dim=3 — big
    #: enough to amortize framing, small enough that the transient copy
    #: is a rounding error next to the slab itself
    slab_chunk_rows = 65536

    def _send_slab_stream(self, srv, pts, qs):
        """New-style ``/slab_rows?wire=d16|f32``: chunk-streamed with the
        serve/wire.py app framing. Each chunk is encoded (d16 delta codec
        or raw f32) and written immediately — the peak transient is one
        chunk, never a second copy of the slab. The fingerprint header is
        the crc32 of the RAW f32 bytes; the puller verifies it after
        decode, so a torn or corrupt transfer can never materialize."""
        codec = ("d16" if qs.get("wire", ["f32"])[0] == "d16"
                 and self.server.wire_mode != "f32" else "f32")
        pts = np.ascontiguousarray(pts, "<f4")
        try:
            begin = int(qs.get("begin", ["0"])[0])
            end = int(qs.get("end", [str(len(pts))])[0])
            if not (0 <= begin <= end <= len(pts)):
                raise ValueError(f"row range [{begin}, {end}) outside "
                                 f"[0, {len(pts)})")
        except ValueError as e:
            self._send_json(400, {"error": f"bad slab range: {e}"})
            return
        sel = pts[begin:end]
        crc = zlib.crc32(memoryview(sel).cast("B"))
        self._start_chunked(
            200, "application/octet-stream",
            extra=[("X-Knn-Rows", str(len(sel))),
                   ("X-Knn-Dim", str(srv.engine.dim)),
                   ("X-Knn-Row-Offset", str(srv.engine.id_offset + begin)),
                   ("X-Knn-Wire", codec),
                   ("X-Knn-Fingerprint", f"{crc:08x}")])
        sent = 0
        step = self.slab_chunk_rows
        try:
            for i in range(0, len(sel), step):
                sub = sel[i:i + step]
                if codec == "d16":
                    payload = encode_slab_chunk(sub)
                else:
                    payload = b"\x00" + sub.tobytes()
                self._write_chunk(frame_chunk(len(sub), payload))
                sent += 8 + len(payload)
            self._end_chunked()
        except (BrokenPipeError, ConnectionResetError):
            # puller went away mid-stream (its torn-transfer detection
            # handles the partial body); nothing for us to salvage
            self.close_connection = True
        srv.wire_stats.add("slab_rows", codec, sent, len(sel))

    def do_POST(self):
        srv: HostSliceServer = self.server
        parsed = urlparse(self.path)
        if parsed.path == "/faults":
            # runtime fault-spec replacement (failure drills): body is
            # {"spec": "<grammar>"}; empty spec clears. Exempt from
            # injection, so a "dead" host can still be revived
            try:
                length = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(length).decode() or "{}")
                srv.faults.set_specs(obj.get("spec", ""))
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            self._send_json(200, {"specs": srv.faults.config()})
            return
        if self._apply_fault(parsed.path):
            return
        if parsed.path == "/adopt_slab":
            # slab handoff (serve/replica.py): direct a warm standby to
            # materialize and warm one slab. 202 = adoption started; the
            # caller polls /healthz and fingerprint-gates before binding
            if srv.standby_config is None:
                self._send_json(409, {
                    "error": "not a standby host — adopt_slab only "
                             "applies to --standby processes"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(length).decode() or "{}")
                host_id = int(obj["host_id"])
                num_hosts = int(obj.get(
                    "num_hosts", srv.standby_config.get("num_hosts", 1)))
                if not (0 <= host_id < num_hosts):
                    raise ValueError(f"host_id {host_id} outside "
                                     f"[0, {num_hosts})")
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send_json(400, {"error": f"bad adopt request: {e}"})
                return
            if not srv.start_adoption(obj, host_id, num_hosts):
                self._send_json(409, {
                    "error": "adoption already in progress or done",
                    "adopt": srv.adopt_snapshot()})
                return
            self._send_json(202, {"status": "adopting",
                                  "host_id": host_id,
                                  "num_hosts": num_hosts})
            return
        if srv.engine is None:
            self._send_json(503, {"error": "standby host: no slab "
                                           "adopted yet"},
                            extra=[("Retry-After", "1")])
            return
        want = "/route_knn" if srv.routing == "bounds" else "/shard_knn"
        if parsed.path != want:
            self._send_json(404, {
                "error": f"this host serves POST {want} only "
                         f"(routing={srv.routing})"})
            return
        srv.metrics.inc("knn_requests_total")
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            dim = getattr(srv.engine, "dim", 3)
            if len(raw) % (4 * dim):
                raise ValueError(f"need an n*{4 * dim}-byte f32 body")
            if srv.routing == "off":
                seq = int(parse_qs(parsed.query).get("seq", ["-1"])[0])
                if seq < 0:
                    raise ValueError("need ?seq=N (the pod program order)")
            q = np.frombuffer(raw, "<f4").reshape(-1, dim)
        except ValueError as e:
            srv.metrics.inc("knn_badrequest_total")
            self._send_json(400, {"error": str(e)})
            return
        wire_req = parse_qs(parsed.query).get("wire", ["f32"])[0]
        try:
            if srv.routing == "off":
                rows, dists, nbrs = srv.run_in_order(seq, q)
            elif wire_req == "x32":
                # survivor re-fetch: the engine hook re-derives the exact
                # rows (batch-composition independent, so they are
                # byte-equal to the quantized wave's)
                d2, idx = srv.engine.refetch_exact(q)
            else:
                d2, idx = srv.run_routed(q)
        except TimeoutError as e:
            # seq-order wait expired: the pod stream is stalled, not this
            # request's fault — 503 + Retry-After, so a well-behaved
            # client backs off instead of treating it as a server bug
            srv.metrics.inc("knn_seq_timeout_total")
            self._send_json(503, {"error": f"TimeoutError: {e}"},
                            extra=[("Retry-After", "1")])
            return
        except Exception as e:  # noqa: BLE001 - the front end retries/fails
            # a kernel failure on the card lands here: the request fails,
            # the front end's health cycle takes over
            srv.metrics.inc("knn_error_total")
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if srv.routing == "off":
            srv.metrics.inc("knn_rows_total", len(rows))
            body = (np.ascontiguousarray(rows, "<i4").tobytes()
                    + np.ascontiguousarray(dists, "<f4").tobytes()
                    + np.ascontiguousarray(nbrs, "<i4").tobytes())
            self._send(200, body, "application/octet-stream",
                       extra=[("X-Knn-Rows", str(len(rows))),
                              ("X-Knn-K", str(srv.engine.k))])
            return
        srv.metrics.inc("knn_rows_total", len(q))
        srv.metrics.inc("knn_routed_rows_total", len(q))
        # negotiated wire codec (serve/wire.py): ?wire=q16 compresses
        # the candidate rows (upper-bound decode, exact re-merge on
        # the frontend); ?wire=x32 is the survivor re-fetch variant —
        # exact d2 only, ids implied by the engine's determinism. An
        # old frontend sends no ?wire= and gets the f32 body with no
        # X-Knn-Wire header, byte-identical to the pre-codec binary.
        codec, extra = "f32", []
        d2 = np.ascontiguousarray(d2, "<f4")
        idx = np.ascontiguousarray(idx, "<i4")
        if srv.wire_mode == "f32":
            # f32-only host (old-binary emulation): any ?wire= ask
            # degrades to the uncompressed body with no X-Knn-Wire
            # header — the frontend's negotiated fallback, never an
            # error (an x32 refetch still gets exact d2 this way)
            body = d2.tobytes() + idx.tobytes()
        elif wire_req == "x32":
            codec, body = "x32", d2.tobytes()
        elif wire_req == "q16":
            body = encode_candidates_q16(d2, idx)
            if body is not None:
                codec = "q16"
            else:
                body = d2.tobytes() + idx.tobytes()
        else:
            body = d2.tobytes() + idx.tobytes()
        if codec != "f32":
            extra = [("X-Knn-Wire", codec)]
        srv.wire_stats.add("candidates", codec, len(body), len(q))
        self._send(200, body, "application/octet-stream",
                   extra=[("X-Knn-Rows", str(len(q))),
                          ("X-Knn-K", str(srv.engine.k))] + extra)


# ---------------------------------------------------------- front-end side


class PodBrokenError(RuntimeError):
    """A host failed mid-stream: the pod's collective program order is
    unrecoverable without restarting the host processes together (the
    monitor's pod-reset path clears it once they do)."""


class HostCallError(RuntimeError):
    """One HTTP call to one host failed. ``transient`` distinguishes
    retry-worthy failures (connect errors, timeouts, 5xx, torn payloads)
    from config errors (4xx) that retrying can never fix."""

    def __init__(self, msg: str, transient: bool = True):
        super().__init__(msg)
        self.transient = transient


class _HostEndpoint:
    """Front-end bookkeeping for one host: address pieces + accounting +
    the supervised health lifecycle (serve/health.py)."""

    def __init__(self, url: str, health_config: dict | None = None):
        self.url = url
        p = urlparse(url if "//" in url else "//" + url)
        self.host = p.hostname or "127.0.0.1"
        self.port = p.port or 80
        self.prefix = p.path.rstrip("/")
        self.latency = LatencyHistogram()
        self.ok = 0
        self.errors = 0
        self.last_error: str | None = None
        self.health = HostHealth(**(health_config or {}))
        self.retries = 0
        self.probe_errors = 0
        self.scrape_errors = 0



class PodFanout:
    """Replicate each batch to every host; assemble the per-host slices.

    The ``dispatch``/``complete`` split mirrors the engine's, so the front
    end's ``DynamicBatcher`` pipelines pod batches: ``dispatch`` assigns
    the next pod-wide sequence number and posts the batch to all hosts
    concurrently (returning a handle of in-flight HTTP futures);
    ``complete`` joins them, scatters each host's ``(rows, dists, nbrs)``
    slices into the full batch, and records the straggler spread (last
    host minus first host wall-clock a batch). Row coverage is asserted: a
    missing row means the pod's mesh ownership disagrees with the front
    end's host list, never something to paper over. The host table,
    per-thread keep-alive connections, probes, scrapes and accounting are
    what the routed fan-out (``RoutedPodFanout``) inherits.
    """

    def __init__(self, host_urls: list[str], *, k: int, max_batch: int,
                 timeout_s: float = 120.0, timers: PhaseTimers | None = None,
                 dim: int = 3, retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 request_timeout_s: float | None = None,
                 health_config: dict | None = None):
        if not host_urls:
            raise ValueError("need at least one host URL")
        #: retained so endpoints bound at runtime (slab handoff's
        #: bind_replica) get the same health lifecycle knobs
        self._health_cfg = health_config
        self.endpoints = [_HostEndpoint(u, health_config)
                          for u in host_urls]
        self.k = int(k)
        self.dim = int(dim)
        self.max_batch = int(max_batch)
        self.timeout_s = float(timeout_s)
        #: per-TRY budget for routed posts (None = the pod-wide timeout_s):
        #: one slow host burns at most this much of the batch's wall-clock
        #: per attempt instead of the whole fan-out timeout
        self.request_timeout_s = (float(request_timeout_s)
                                  if request_timeout_s else None)
        #: bounded retries on TRANSIENT per-host failures (routed mode; the
        #: replicate stream is a collective and cannot re-send a seq)
        self.retries = int(retries)
        self.retry_backoff = Backoff(base_s=retry_backoff_s, cap_s=2.0,
                                     jitter=0.1, seed=0)
        self._sleep = time.sleep  # injectable: retry tests never sleep
        self.timers = timers if timers is not None else PhaseTimers()
        self._lock = threading.Lock()
        # stream state + accounting shared between the batcher's dispatch/
        # completion workers, handler threads (/stats), and the health
        # monitor's reset path — all access under _lock
        #: the replicate pod's broken-stream marker: a routed pod never
        #: sets it (its hosts fail alone), the surfaces still read it
        self.broken: guarded_by("_lock") = None
        self._seq: guarded_by("_lock") = 0
        self.batches: guarded_by("_lock") = 0
        self.straggler_seconds: guarded_by("_lock") = 0.0
        self._tls = threading.local()
        # enough workers for `depth` batches x H hosts in flight
        self._pool = ThreadPoolExecutor(
            max_workers=4 * len(self.endpoints),
            thread_name_prefix="knn-fanout")

    # ------------------------------------------------------------- transport

    def _conn(self, ep: _HostEndpoint) -> http.client.HTTPConnection:
        conns = getattr(self._tls, "conns", None)
        if conns is None:
            conns = self._tls.conns = {}
        c = conns.get(ep.url)
        if c is None:
            c = http.client.HTTPConnection(
                ep.host, ep.port,
                timeout=self.request_timeout_s or self.timeout_s)
            conns[ep.url] = c
        return c

    def _drop_conn(self, ep: _HostEndpoint):
        c = getattr(self._tls, "conns", {}).pop(ep.url, None)
        if c is not None:
            try:
                c.close()
            # lsk: allow[except-swallow] teardown of an already-failed
            except Exception:  # noqa: BLE001 - connection: nothing to record
                pass

    def _post_shard(self, ep: _HostEndpoint, seq: int, body: bytes):
        """POST one batch to one host; parse its slice triple. Returns
        (rows, dists, nbrs, seconds)."""
        t0 = time.perf_counter()
        try:
            conn = self._conn(ep)
            conn.request("POST", f"{ep.prefix}/shard_knn?seq={seq}",
                         body=body,
                         headers={"Content-Type":
                                  "application/octet-stream"})
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise PodBrokenError(
                    f"host {ep.url} answered {resp.status} for seq {seq}: "
                    f"{payload[:300].decode(errors='replace')}")
            m = int(resp.getheader("X-Knn-Rows", "-1"))
            kk = int(resp.getheader("X-Knn-K", str(self.k)))
            if m < 0 or kk != self.k or len(payload) != 4 * m * (2 + kk):
                raise PodBrokenError(
                    f"host {ep.url} slice malformed: rows={m} k={kk} "
                    f"bytes={len(payload)}")
            rows = np.frombuffer(payload, "<i4", count=m)
            dists = np.frombuffer(payload, "<f4", count=m, offset=4 * m)
            nbrs = np.frombuffer(payload, "<i4", count=m * kk,
                                 offset=8 * m).reshape(m, kk)
        except PodBrokenError:
            self._drop_conn(ep)
            raise
        except Exception as e:
            self._drop_conn(ep)
            raise PodBrokenError(
                f"host {ep.url} unreachable for seq {seq}: "
                f"{type(e).__name__}: {e}") from e
        return rows, dists, nbrs, time.perf_counter() - t0

    # ---------------------------------------------------------- query_fn API

    def dispatch(self, queries: np.ndarray):
        """Fan one admitted batch out to every host (non-blocking)."""
        q = np.ascontiguousarray(np.asarray(queries, np.float32)
                                 .reshape(-1, self.dim))
        with self._lock:
            # broken-check and seq-assignment are ONE atomic step: a
            # reset_stream racing between them could otherwise hand this
            # batch a stale stream position
            if self.broken:
                raise PodBrokenError(self.broken)
            seq = self._seq
            self._seq += 1
        body = q.astype("<f4").tobytes()
        futs = [self._pool.submit(self._post_shard, ep, seq, body)
                for ep in self.endpoints]
        return {"seq": seq, "n": len(q), "futs": futs,
                "t0": time.perf_counter()}

    def complete(self, handle):
        """Join every host's slice and assemble the full batch."""
        n = handle["n"]
        out_d = np.full(n, np.nan, np.float32)
        out_n = np.full((n, self.k), -1, np.int32)
        filled = np.zeros(n, bool)
        dts = []
        err: PodBrokenError | None = None
        for ep, fut in zip(self.endpoints, handle["futs"]):
            try:
                rows, dists, nbrs, dt = fut.result()
            except PodBrokenError as e:
                with self._lock:
                    ep.errors += 1
                    ep.last_error = str(e)
                # drain-then-fail: the health state records WHICH host took
                # the pod down, and the monitor's pod-reset path undrains
                # it once the whole pod restarts consistently
                ep.health.force_drain(str(e))
                err = err or e
                continue
            with self._lock:
                ep.ok += 1
                ep.latency.record(dt)
            ep.health.note_success()
            dts.append(dt)
            out_d[rows] = dists
            out_n[rows] = nbrs
            filled[rows] = True
        if err is not None:
            # one program across the pod: a lost host slice is not
            # degradable
            with self._lock:
                self.broken = self.broken or str(err)
            raise err
        if not filled.all():
            missing = int((~filled).sum())
            raise PodBrokenError(
                f"assembled batch seq {handle['seq']} is missing {missing} "
                f"of {n} rows — host list does not cover the pod mesh")
        with self._lock:
            self.batches += 1
            if len(dts) > 1:
                spread = max(dts) - min(dts)
                self.straggler_seconds += spread
                self.timers.hist("fanout_straggler_seconds").record(spread)
        self.timers.hist("fanout_batch_seconds").record(
            time.perf_counter() - handle["t0"])
        return out_d, out_n

    def __call__(self, queries):
        return self.complete(self.dispatch(queries))

    # ------------------------------------------------------------------ admin

    def probe_health(self, timeout_s: float = 2.0) -> dict:
        """GET every host's /healthz; {url: {"ok": bool, ...}}. Failures
        are no longer swallowed silently: each lands in the endpoint's
        ``last_error`` + ``probe_errors`` counter, so the health monitor
        and a /stats reader see the same truth."""
        out = {}
        for ep in self.endpoints:
            try:
                with urllib.request.urlopen(ep.url.rstrip("/") + "/healthz",
                                            timeout=timeout_s) as r:
                    out[ep.url] = {"ok": r.status == 200,
                                   **json.loads(r.read().decode())}
            except Exception as e:  # noqa: BLE001 - down IS the answer
                msg = f"healthz probe failed: {type(e).__name__}: {e}"
                with self._lock:
                    ep.probe_errors += 1
                    ep.last_error = msg
                out[ep.url] = {"ok": False, "error": msg}
        return out

    def scrape_host_stats(self, timeout_s: float = 5.0) -> dict:
        out = {}
        for ep in self.endpoints:
            try:
                with urllib.request.urlopen(ep.url.rstrip("/") + "/stats",
                                            timeout=timeout_s) as r:
                    out[ep.url] = json.loads(r.read().decode())
            except Exception as e:  # noqa: BLE001 - surfaced per host
                msg = f"stats scrape failed: {type(e).__name__}: {e}"
                with self._lock:
                    ep.scrape_errors += 1
                    ep.last_error = msg
                out[ep.url] = {"error": msg}
        return out

    def broken_reason(self) -> str | None:
        """Locked read of the broken marker — the accessor cross-object
        readers (handlers, the health monitor) use; the guarded_by
        convention does not reach them, so they must not touch
        ``.broken`` directly."""
        with self._lock:
            return self.broken

    def reset_stream(self, next_seq: int) -> None:
        """Clean-restart path (replicate mode): clear the broken marker and
        re-align the front end's sequence counter with the (restarted)
        hosts' consistent ``next_seq``. Only the health monitor calls
        this, after validating every host's fingerprint."""
        with self._lock:
            self.broken = None
            self._seq = int(next_seq)

    def drained_mask(self) -> np.ndarray:
        """bool[H]: which endpoints are currently drained/rejoining."""
        return np.array([ep.health.is_drained() for ep in self.endpoints],
                        bool)

    def health_snapshot(self) -> dict:
        return {ep.url: dict(ep.health.snapshot(), retries=ep.retries,
                             probe_errors=ep.probe_errors,
                             scrape_errors=ep.scrape_errors)
                for ep in self.endpoints}

    def close(self) -> None:
        """Stop the fan-out pool. Worker threads exit and their cached
        per-host connections are closed with them (each thread's dict is
        only reachable from its own ``threading.local`` slot)."""
        self._pool.shutdown(wait=False)

    def stats(self) -> dict:
        health = self.health_snapshot()
        with self._lock:
            return {
                "hosts": [ep.url for ep in self.endpoints],
                "batches": self.batches,
                "next_seq": self._seq,
                "broken": self.broken,
                "straggler_seconds_total": round(self.straggler_seconds, 6),
                "per_host": {
                    ep.url: {"ok": ep.ok, "errors": ep.errors,
                             "retries": ep.retries,
                             "probe_errors": ep.probe_errors,
                             "scrape_errors": ep.scrape_errors,
                             "state": health[ep.url]["state"],
                             "last_error": ep.last_error,
                             "latency": ep.latency.report()}
                    for ep in self.endpoints},
                "health": health,
            }



def routing_cert_slack(dim: int) -> float:
    """Relative certification slack: a slab (or a pod's host) is only
    CERTIFIED skippable when ``lb * (1 - slack) > kth_dist2``. The box
    bound is computed in f64, but the engines score pairs in f32 with a
    relative error bounded by ~(D+2) * 2^-24 (one rounding per multiply or
    add of the D-term sum), so a point exactly ON a box face could score
    BELOW the exact bound. The slack therefore grows with the dimension:
    16 x the error-model bound with a 1e-5 floor. The non-strict ``<=``
    comparison keeps every exact-tie slab, which is what keeps tie ids
    bitwise equal to one engine over all the points."""
    return max(1e-5, 16.0 * (dim + 2) * 2.0 ** -24)


class PodBoundsTable:
    """The routing decision table: every host's per-shard AABBs + counts.

    Assembled once at front-end startup from the hosts' /stats
    (``pod_config_from_hosts``). ``lower_bounds(q)`` returns, per (query,
    host), the squared distance below which NO point of that host can lie
    — the min over the host's per-shard box bounds (tighter than one
    whole-slab box). Empty shards carry the ``lo/hi = None`` sentinel and
    contribute nothing; a host with ONLY empty shards is unreachable
    (bound +inf) and is never routed to nor escalated to.
    """

    def __init__(self, hosts: list[dict], dim: int):
        self.dim = int(dim)
        self.num_hosts = len(hosts)
        self.host_points = [int(h["n_points"]) for h in hosts]
        los, his, owner = [], [], []
        for hid, h in enumerate(hosts):
            for sb in h["shards"]:
                if sb.get("count", 0) > 0:
                    if sb.get("lo") is None or sb.get("hi") is None:
                        raise ValueError(
                            f"host {hid} shard bounds malformed: "
                            f"count {sb['count']} but no lo/hi box")
                    los.append(sb["lo"])
                    his.append(sb["hi"])
                    owner.append(hid)
        self._lo = np.asarray(los, np.float64).reshape(-1, self.dim)
        self._hi = np.asarray(his, np.float64).reshape(-1, self.dim)
        self._owner = np.asarray(owner, np.int64)

    def lower_bounds(self, queries: np.ndarray) -> np.ndarray:
        """f64[n, H] squared lower-bound distance per (query, host);
        +inf for hosts with no points."""
        q = np.asarray(queries, np.float64).reshape(-1, self.dim)
        out = np.full((len(q), self.num_hosts), np.inf)
        if len(self._lo) == 0 or len(q) == 0:
            return out
        lb = aabb_lower_bound_dist2(q, self._lo, self._hi)
        for h in range(self.num_hosts):
            sel = self._owner == h
            if sel.any():
                out[:, h] = lb[:, sel].min(axis=1)
        return out


class RoutedPodFanout(PodFanout):
    """Bounds-routed fan-out: each query visits only the hosts whose shard
    boxes can still improve it, instead of the whole pod.

    ``dispatch`` (wave 1) computes the bounds table's lower bounds and
    posts each query to its single nearest-bounds host (ties -> lowest
    host index). ``complete`` joins the wave, folds the returned candidate
    rows with the canonical (dist2, id) merge — commutative, so the fold
    cannot depend on arrival order — then repeats: any (query, host) pair
    with ``lb * (1 - slack) <= kth_dist2`` and not yet visited is
    re-dispatched in an escalation wave, until every skipped host is
    certified unable to contribute (monotone radius ⇒ the loop terminates;
    in practice one escalation wave at most). Queries with fewer than k
    candidates keep an infinite radius, so they escalate to every
    reachable host — exactness is never traded for routing.

    Results are bit-identical to one engine over all the points (ties
    included) when the hosts' engines run the canonical tie order — the
    default; ``pod_config_from_hosts`` warns otherwise.
    """

    def __init__(self, host_urls: list[str], *, k: int, max_batch: int,
                 bounds: PodBoundsTable, timeout_s: float = 120.0,
                 timers: PhaseTimers | None = None, dim: int = 3,
                 retries: int = 2, retry_backoff_s: float = 0.05,
                 request_timeout_s: float | None = None,
                 health_config: dict | None = None,
                 replica_groups: list[dict] | None = None,
                 spread_seed: int = 0, wire: str = "auto",
                 wire_host_caps: dict | None = None):
        from mpi_cuda_largescaleknn_torch.serve.replica import ReplicaSet

        super().__init__(host_urls, k=k, max_batch=max_batch,
                         timeout_s=timeout_s, timers=timers, dim=dim,
                         retries=retries, retry_backoff_s=retry_backoff_s,
                         request_timeout_s=request_timeout_s,
                         health_config=health_config)
        #: per-host negotiated wire codec (serve/wire.py): ``wire`` is the
        #: frontend knob (auto|f32|q16); caps come from each host's /stats
        #: root as scraped at startup (pod_config_from_hosts) and on
        #: adoption (ReplicaManager) — a host with no caps negotiates f32,
        #: so mixed pods interop without config
        self.negotiator = WireNegotiator(
            "f32" if wire == "f32" else ("q16" if wire == "q16" else "auto"))
        for url, caps in (wire_host_caps or {}).items():
            self.negotiator.set_caps(url, caps)
        self.wire_stats = WireStats()
        #: slab -> replica-endpoint-group table (serve/replica.py): every
        #: routing decision is per SLAB; a healthy member is picked per
        #: sub-batch. None = the trivial R=1 set (one slab per endpoint),
        #: which reproduces the pre-replica behavior exactly.
        self.replicas = ReplicaSet(self.endpoints, replica_groups,
                                   seed=spread_seed)
        if bounds.num_hosts != self.replicas.num_slabs:
            raise ValueError(f"bounds table covers {bounds.num_hosts} "
                             f"slabs, replica set has "
                             f"{self.replicas.num_slabs}")
        self.bounds = bounds
        self.routing_mode = "bounds"
        self.cert_slack = routing_cert_slack(self.dim)
        # routing accounting (under the inherited fan-out _lock)
        self.escalations: guarded_by("_lock") = 0
        self.escalation_waves: guarded_by("_lock") = 0
        self.degraded_rows: guarded_by("_lock") = 0
        self.host_loss_events: guarded_by("_lock") = 0
        self.hosts_per_query: guarded_by("_lock") = Counter()
        # quantized-exchange resolution accounting: how often the exact
        # re-merge was served verbatim (provably unchanged by re-fetch),
        # re-fetched, or degraded because every re-fetch replica failed
        self.wire_verbatim_rows: guarded_by("_lock") = 0
        self.wire_refetch_rows: guarded_by("_lock") = 0
        self.wire_refetch_posts: guarded_by("_lock") = 0
        self.wire_refetch_failed_rows: guarded_by("_lock") = 0
        for ep in self.endpoints:
            ep.routed_rows = 0

    def bind_replica(self, slab: int, url: str) -> _HostEndpoint:
        """Runtime re-bind of a slab's endpoint set: add a NEW endpoint
        (a handoff-validated adopted standby) as a replica of ``slab``.
        Only the replica manager calls this, AFTER the fingerprint gate:
        an unproven slab must never enter the routing tables. The
        endpoint list only ever grows (append is atomic under the GIL;
        dispatch threads iterate by index)."""
        ep = _HostEndpoint(url, self._health_cfg)
        ep.routed_rows = 0
        self.endpoints.append(ep)
        self.replicas.rebind(slab, len(self.endpoints) - 1)
        return ep

    # ------------------------------------------------------------- transport

    def _route_once(self, ep: _HostEndpoint, body: bytes, m: int,
                    codec: str = "f32"):
        """ONE POST attempt to one routed host; parse its candidate rows.
        Returns ``(d2, d2_lo, idx, seconds, codec)`` where ``codec`` is
        what the RESPONSE actually carried (the X-Knn-Wire header — a host
        that ignores or declines ``?wire=q16`` answers plain f32, so a
        mismatch is a clean fallback, never a decode error). For f32 the
        bounds coincide (``d2_lo is d2``); for q16 they bracket the true
        distance with the anchor (kth) slot exact; for x32 (the survivor
        re-fetch variant) ``idx`` is None — ids are implied by the
        engine's determinism. Raises ``HostCallError`` classified
        transient (5xx, timeouts, connect errors, torn payloads — worth a
        retry) or not (4xx config)."""
        k = self.k
        t0 = time.perf_counter()
        qs = f"?wire={codec}" if codec != "f32" else ""
        try:
            conn = self._conn(ep)
            conn.request("POST", f"{ep.prefix}/route_knn{qs}", body=body,
                         headers={"Content-Type":
                                  "application/octet-stream"})
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise HostCallError(
                    f"host {ep.url} answered {resp.status}: "
                    f"{payload[:300].decode(errors='replace')}",
                    transient=resp.status >= 500)
            got = int(resp.getheader("X-Knn-Rows", "-1"))
            kk = int(resp.getheader("X-Knn-K", str(k)))
            wire_got = resp.getheader("X-Knn-Wire") or "f32"
            if got != m or kk != k:
                raise HostCallError(
                    f"host {ep.url} partial malformed: rows={got} (want "
                    f"{m}) k={kk}")
            if wire_got == "q16":
                try:
                    d2, d2_lo, idx = decode_candidates_q16(payload, m, k)
                except WireError as e:
                    raise HostCallError(
                        f"host {ep.url} q16 partial undecodable: {e}") \
                        from e
            elif wire_got == "x32":
                if len(payload) != 4 * m * k:
                    raise HostCallError(
                        f"host {ep.url} x32 partial malformed: "
                        f"bytes={len(payload)}")
                d2 = np.frombuffer(payload, "<f4",
                                   count=m * k).reshape(m, k)
                d2_lo, idx = d2, None
            else:
                if len(payload) != 8 * m * k:
                    raise HostCallError(
                        f"host {ep.url} partial malformed: rows={got} "
                        f"(want {m}) k={kk} bytes={len(payload)}")
                d2 = np.frombuffer(payload, "<f4",
                                   count=m * k).reshape(m, k)
                idx = np.frombuffer(payload, "<i4", count=m * k,
                                    offset=4 * m * k).reshape(m, k)
                d2_lo = d2
        except HostCallError:
            self._drop_conn(ep)
            raise
        except Exception as e:
            self._drop_conn(ep)
            raise HostCallError(
                f"host {ep.url} unreachable: "
                f"{type(e).__name__}: {e}") from e
        self.wire_stats.add("candidates", wire_got, len(payload), m)
        return d2, d2_lo, idx, time.perf_counter() - t0, wire_got

    def _post_route(self, ep: _HostEndpoint, body: bytes, m: int,
                    codec: str = "f32"):
        """`_route_once` with bounded retries + deterministic backoff on
        TRANSIENT failures (the /route_knn contract is idempotent — a
        routed sub-batch is a pure read, so re-sending it is always safe,
        unlike the replicate pod's seq-consuming /shard_knn)."""
        attempt = 0
        while True:
            try:
                return self._route_once(ep, body, m, codec)
            except HostCallError as e:
                if not e.transient or attempt >= self.retries:
                    raise
                attempt += 1
                with self._lock:
                    ep.retries += 1
                self._sleep(self.retry_backoff.delay(attempt, key=ep.url))

    def _submit_wave(self, q: np.ndarray, rows_by_slab,
                     batch_failures: dict | None = None) -> list:
        """Post per-slab sub-batches concurrently, each to one healthy
        replica chosen by the spread policy (``ReplicaSet.pick`` — batch
        failures first, so a replica that just failed this batch is
        routed around immediately); returns ``[(slab, ep_index, rows,
        future)]`` for the sub-batches actually submitted. A slab whose
        every member is drained or over its per-batch budget submits
        nothing — the caller leaves those rows unvisited and the
        on-host-loss policy resolves them."""
        futs = []
        for s, rows in rows_by_slab:
            if len(rows) == 0:
                continue
            ep_i = self.replicas.pick(s, penalties=batch_failures,
                                      budget=self.retries)
            if ep_i is None:
                continue
            body = np.ascontiguousarray(q[rows], "<f4").tobytes()
            codec = self.negotiator.codec_for(self.endpoints[ep_i].url)
            futs.append((s, ep_i, rows,
                         self._pool.submit(self._post_route,
                                           self.endpoints[ep_i], body,
                                           len(rows), codec)))
        return futs

    # ---------------------------------------------------------- query_fn API

    def dispatch(self, queries: np.ndarray, plan=None, seed_radius=None):
        """Wave 1: each query to its nearest-bounds AVAILABLE slab (one
        picked replica of it), PLUS every available slab whose boxes
        contain it (non-blocking). A zero lower bound can never be
        certified away (0 <= kth_dist2 always), so an inside-the-box slab
        would be escalated to unconditionally — visiting it in wave 1
        spends the same rows one round trip earlier, which is most of the
        boundary traffic's latency. A slab is unavailable only when EVERY
        replica is drained — a single drained host is simply routed
        around; whether the answers a fully-down slab would have touched
        are 503d or served degraded is ``complete``'s caller's policy.

        ``plan`` (serve/recall.py RecallPlan, None = exact) is FRONTEND
        side only here: the /route_knn wire is unchanged (hosts always
        serve their exact slab partials) and the plan's ``route_slack``
        shaves ``complete``'s escalation margin — fewer boundary waves,
        bounded recall cost.

        ``seed_radius`` (serve/qcache.py certified radius seeds, exact
        tier only — dropped under a plan) is frontend-side too: the
        /route_knn wire is unchanged (hosts serve their full exact slab
        partials), but ``complete`` starts its escalation radius at the
        certified seed instead of +inf, so certification closes with
        fewer escalation waves. The seed sits strictly above the true
        kth distance, so every slab holding a true top-k or
        boundary-tied candidate is still visited — identical answer."""
        q = np.ascontiguousarray(np.asarray(queries, np.float32)
                                 .reshape(-1, self.dim))
        n = len(q)
        seeds = None
        if seed_radius is not None and plan is None:
            seeds = np.asarray(seed_radius, np.float32).reshape(-1)
            if len(seeds) != n:
                raise ValueError(
                    f"seed_radius has {len(seeds)} rows for {n} queries")
            if not np.any(np.isfinite(seeds)):
                seeds = None
        num_slabs = self.replicas.num_slabs
        lb = self.bounds.lower_bounds(q)
        visited = np.zeros((n, num_slabs), bool)
        futs = []
        if n:
            avail = self.replicas.slab_live_mask()
            lb_route = np.where(avail[None, :], lb, np.inf)
            first = np.argmin(lb_route, axis=1)
            reachable = np.isfinite(lb_route[np.arange(n), first])
            want = (lb <= 0.0) & avail[None, :]
            want[np.nonzero(reachable)[0], first[reachable]] = True
            waves = [(s, np.nonzero(want[:, s])[0])
                     for s in range(num_slabs)]
            futs = self._submit_wave(q, waves)
            # only rows actually submitted count as visited: a slab whose
            # last replica drained between the mask and the pick stays
            # unvisited and resolves per policy
            for s, _ep_i, rows, _f in futs:
                visited[rows, s] = True
        return {"q": q, "n": n, "lb": lb, "visited": visited,
                "futs": futs, "t0": time.perf_counter(), "plan": plan,
                "seeds": seeds}

    #: the front end resolves recall plans only against fan-outs that
    #: accept them; the replicate pod (base class) stays plan-blind and
    #: serves every target exactly
    supports_recall = True

    def __call__(self, queries, plan=None, seed_radius=None):
        return self.complete(self.dispatch(queries, plan=plan,
                                           seed_radius=seed_radius))

    def complete(self, handle):
        """Fold wave partials; escalate uncertified (query, slab) pairs.

        Returns ``(dists, idx, exact)``. A replica that fails all its
        retries feeds the health state machine (eventually draining it)
        and its sub-batch is put back on the uncertified list: the next
        wave's pick prefers a DIFFERENT live replica of the same slab (a
        single host loss costs one extra round trip, never exactness),
        falling back to wave-level retry of the same host only when it is
        the slab's sole member. After certification converges, any
        (query, all-replicas-down slab) pair whose bound could still
        improve the query marks that query ``exact=False`` — the fold of
        the surviving slabs' partials is still well-defined
        (commutative), just possibly missing that slab's candidates.
        Queries whose certified routing set never touched a fully-down
        slab stay bit-identical to a healthy pod."""
        n, k = handle["n"], self.k
        cur_d2 = np.full((n, k), np.inf, np.float32)
        cur_idx = np.full((n, k), -1, np.int32)
        seeds = handle.get("seeds")
        if seeds is not None:
            # certified seeds (serve/qcache.py) bound the escalation
            # radius from wave 1: r2 starts at seed² (> true kth²,
            # strictly), escalation visits strictly fewer slabs, and the
            # filler (seed², -1) slots are pushed out before the fold
            # closes — the final rows are bit-identical to unseeded
            cur_d2[:] = (seeds * seeds)[:, None]
        if n == 0:
            return (np.zeros(0, np.float32), cur_idx,
                    np.zeros(0, bool))
        q, visited = handle["q"], handle["visited"]
        num_slabs = self.replicas.num_slabs
        # recall plan (knob c): escalate only when a bound beats the kth
        # distance by the plan's slack margin — fewer boundary waves at a
        # bounded recall cost; 0.0 (exact) keeps certification exact
        plan = handle.get("plan")
        slack = float(plan.route_slack) if plan is not None else 0.0
        # the dim-scaled slack makes the certification conservative
        # against the engines' f32 rounding (routing_cert_slack)
        lb_safe = handle["lb"] * (1.0 - self.cert_slack)
        reachable = np.isfinite(lb_safe)
        futs = handle["futs"]
        dts = []
        wave = 1
        # per-BATCH failure budget per ENDPOINT: wave-level retries are
        # capped independently of the global drain threshold, so a host
        # that keeps answering /healthz (resetting its failure streak via
        # the monitor) while failing /route_knn can never loop this batch
        # forever — once over budget it is unusable for THIS batch; a
        # slab with no usable member resolves per the on-host-loss policy
        batch_failures: dict[int, int] = {}
        # every successful sub-batch is retained: quantized (q16) partials
        # fold as UPPER bounds — sound for the escalation radius — and the
        # retained rows + lower bounds drive the exact re-merge afterwards
        contribs: list[tuple] = []
        while True:
            for s, ep_i, rows, fut in futs:
                ep = self.endpoints[ep_i]
                try:
                    d2, d2_lo, idx, dt, codec = fut.result()
                except HostCallError as e:
                    with self._lock:
                        ep.errors += 1
                        ep.last_error = str(e)
                    ep.health.note_failure(str(e))
                    batch_failures[ep_i] = batch_failures.get(ep_i, 0) + 1
                    # un-visit the lost sub-batch: the certification loop
                    # re-dispatches it to another replica (or retries the
                    # sole member while it stays usable); once the whole
                    # slab is out, these pairs surface as uncertified ->
                    # degraded/failed per policy
                    visited[rows, s] = False
                    continue
                with self._lock:
                    ep.ok += 1
                    ep.latency.record(dt)
                    ep.routed_rows += len(rows)
                ep.health.note_success()
                dts.append(dt)
                fold_candidates(cur_d2, cur_idx, rows, d2, idx, k)
                contribs.append((s, ep_i, rows, d2, d2_lo, idx, codec))
            # quantized partials fold upper bounds, so this radius is >=
            # the exact fold's on the same visited set: escalation can
            # only widen — certification never skips a host a
            # full-precision fold would have visited
            r2 = cur_d2[:, k - 1].astype(np.float64)
            need = (~visited) & reachable & (
                lb_safe <= r2[:, None] * (1.0 - slack))
            avail = self.replicas.slab_live_mask(
                penalties=batch_failures, budget=self.retries)
            dispatchable = need & avail[None, :]
            if not dispatchable.any():
                break
            with self._lock:
                if wave == 1:
                    self.escalations += int(
                        dispatchable.any(axis=1).sum())
                self.escalation_waves += 1
            wave += 1
            waves = [(s, np.nonzero(dispatchable[:, s])[0])
                     for s in range(num_slabs)]
            futs = self._submit_wave(q, waves, batch_failures)
            if not futs:
                # no sub-batch could be submitted (every needed slab lost
                # its last usable replica between mask and pick): no
                # progress is possible — resolve the remainder per policy
                break
            for s, _ep_i, rows, _f in futs:
                visited[rows, s] = True
        # exact re-merge: with any quantized contribution in play, the
        # conservative fold's bits are NOT the served answer — resolve
        # each query to the f32-identical row (verbatim when provable,
        # x32 re-fetch + one-shot exact fold otherwise). A pure-f32 batch
        # skips this entirely: the fold above IS the pre-codec path.
        if any(c[6] == "q16" for c in contribs):
            r2_f32, cur_idx, refetch_failed = self._resolve_quantized(
                q, n, contribs, cur_d2, cur_idx)
            r2 = r2_f32.astype(np.float64)
        else:
            refetch_failed = None
            r2_f32 = cur_d2[:, k - 1]
        # certification closed over the AVAILABLE slabs; whatever remains
        # uncertified points at fully-down slabs — those queries are
        # inexact (judged under the plan's slack: the approximate tier
        # flags its rows inexact at the response layer regardless). The
        # exact radius is <= the conservative loop radius, so this final
        # check can only shrink the uncertified set — exact flags match
        # an f32-negotiated pod's bit for bit.
        uncertified = (~visited) & reachable & (
            lb_safe <= r2[:, None] * (1.0 - slack))
        exact = ~uncertified.any(axis=1)
        if refetch_failed is not None:
            # every replica of a quantized contributor refused the exact
            # re-fetch: those rows serve the conservative fold, flagged
            # inexact — the same honesty contract as a lost slab
            exact &= ~refetch_failed
        with self._lock:
            self.batches += 1
            if not exact.all():
                self.degraded_rows += int((~exact).sum())
                self.host_loss_events += 1
            self.hosts_per_query.update(
                visited.sum(axis=1).astype(int).tolist())
            if len(dts) > 1:
                spread = max(dts) - min(dts)
                self.straggler_seconds += spread
                self.timers.hist("fanout_straggler_seconds").record(spread)
        self.timers.hist("fanout_batch_seconds").record(
            time.perf_counter() - handle["t0"])
        return np.sqrt(r2_f32), cur_idx, exact

    # -------------------------------------------------- exact re-merge (q16)

    def _resolve_quantized(self, q, n, contribs, cur_d2, cur_idx):
        """Resolve the batch to the f32-identical served rows after a
        conservative (upper-bound) fold. Per query:

        - ONE contribution: its transmitted row verbatim — the ids ride
          the wire exactly and the kth slot (anchor / pad) is bit-exact,
          so the served pair needs no re-fetch.
        - several: serve the smallest-kth contribution verbatim when
          every OTHER contribution's smallest lower bound strictly
          exceeds that kth (``lo <= true d2``, so none of their
          candidates can enter the merged top-k — ties included, the
          inequality is strict); otherwise re-fetch exact distances for
          the quantized contributions (``?wire=x32`` — ids are implied by
          the engines' determinism) and run ONE exact fold over all of
          the query's rows, which equals the incremental f32 fold bit
          for bit (the merge is a total order over unique (d2, id)).

        Returns ``(kth_d2 f32[n], idx i32[n, k], refetch_failed bool[n])``
        — failed rows keep the conservative fold and are flagged by the
        caller."""
        k = self.k
        by_q: list[list] = [[] for _ in range(n)]
        for ci, c in enumerate(contribs):
            for j, qi in enumerate(c[2].tolist()):
                by_q[qi].append((ci, j))
        out_d2 = cur_d2[:, k - 1].copy()
        out_idx = cur_idx.copy()
        verbatim_rows = 0
        merge_q: list[int] = []
        refetch: dict[int, list[int]] = {}
        for qi in range(n):
            cl = by_q[qi]
            if not cl:
                continue  # unvisited everywhere — the host-loss path
            if len(cl) > 1:
                kths = [float(contribs[ci][3][j, k - 1]) for ci, j in cl]
                b = int(np.argmin(kths))
                if not all(float(contribs[ci][4][j, 0]) > kths[b]
                           for t, (ci, j) in enumerate(cl) if t != b):
                    merge_q.append(qi)
                    for ci, j in cl:
                        if contribs[ci][6] == "q16":
                            refetch.setdefault(ci, []).append(j)
                    continue
            else:
                b = 0
            ci, j = cl[b]
            out_d2[qi] = contribs[ci][3][j, k - 1]
            out_idx[qi] = contribs[ci][5][j]
            verbatim_rows += 1
        failed = np.zeros(n, bool)
        failed_ci: set[int] = set()
        if merge_q:
            jobs = {}
            for ci, js in refetch.items():
                s, ep_i, rows = contribs[ci][0], contribs[ci][1], \
                    contribs[ci][2]
                sub = np.asarray(js, np.int64)
                jobs[ci] = (sub, self._pool.submit(
                    self._refetch_exact, s, ep_i, q, rows[sub]))
            for ci, (sub, fut) in jobs.items():
                d2x = fut.result()
                if d2x is None:
                    failed_ci.add(ci)
                else:
                    # overwrite the decoded upper bounds with exact f32
                    # (q16 decode owns its arrays — always writeable)
                    contribs[ci][3][sub] = d2x
            init_d2 = np.full(k, np.inf, np.float32)
            init_idx = np.full(k, -1, np.int32)
            for qi in merge_q:
                cl = by_q[qi]
                if any(ci in failed_ci for ci, _j in cl):
                    failed[qi] = True  # conservative row already out_*
                    continue
                cat_d2 = np.concatenate(
                    [init_d2] + [contribs[ci][3][j] for ci, j in cl])
                cat_idx = np.concatenate(
                    [init_idx] + [contribs[ci][5][j] for ci, j in cl])
                order = np.lexsort((cat_idx, cat_d2))[:k]
                out_d2[qi] = cat_d2[order[k - 1]]
                out_idx[qi] = cat_idx[order]
        with self._lock:
            self.wire_verbatim_rows += verbatim_rows
            self.wire_refetch_rows += sum(
                len(sub) for sub, _f in jobs.values()) if merge_q else 0
            self.wire_refetch_posts += len(refetch) if merge_q else 0
            self.wire_refetch_failed_rows += int(failed.sum())
        return out_d2, out_idx, failed

    def _refetch_exact(self, s, ep_i, q, rows):
        """Exact-distance re-fetch for the fold survivors of one
        quantized sub-batch: ``?wire=x32`` re-poses the same query rows
        (a pure idempotent read) to the SAME endpoint; the response is
        d2 only — ids are implied because the engine is deterministic
        and batch-composition independent (the property every escalation
        wave already relies on). When that replica fails its retries,
        any other usable replica of the slab answers instead (members
        are byte-interchangeable by the fingerprint gate; an f32-only
        member simply answers full f32, which carries exact d2 too).
        Returns f32[len(rows), k] or None when the whole slab is out."""
        body = np.ascontiguousarray(q[rows], "<f4").tobytes()
        tried: dict[int, int] = {}
        while True:
            ep = self.endpoints[ep_i]
            try:
                d2, _lo, _idx, _dt, _codec = self._post_route(
                    ep, body, len(rows), "x32")
                return d2
            except HostCallError as e:
                with self._lock:
                    ep.errors += 1
                    ep.last_error = str(e)
                ep.health.note_failure(str(e))
                tried[ep_i] = self.retries + 1  # over budget: exclude
                nxt = self.replicas.pick(s, penalties=tried,
                                         budget=self.retries)
                if nxt is None:
                    return None
                ep_i = nxt

    # ------------------------------------------------------------------ admin

    def stats(self) -> dict:
        s = super().stats()
        replicas = self.replicas.stats()
        with self._lock:
            total_q = sum(self.hosts_per_query.values())
            total_h = sum(c * v for c, v in self.hosts_per_query.items())
            s["routing"] = {
                "mode": "bounds",
                "escalations": self.escalations,
                "escalation_waves": self.escalation_waves,
                "degraded_rows": self.degraded_rows,
                "host_loss_events": self.host_loss_events,
                "routed_rows": {ep.url: ep.routed_rows
                                for ep in self.endpoints},
                "hosts_per_query": {str(c): int(v) for c, v in
                                    sorted(self.hosts_per_query.items())},
                "hosts_per_query_mean": round(total_h / total_q, 4)
                if total_q else None,
                # replication surface: per-slab member/live table + the
                # spread counters (how picks distributed across replicas)
                "replicas": replicas,
            }
            s["wire"] = {
                **self.negotiator.snapshot(),
                "traffic": self.wire_stats.snapshot(),
                "verbatim_rows": self.wire_verbatim_rows,
                "refetch_rows": self.wire_refetch_rows,
                "refetch_posts": self.wire_refetch_posts,
                "refetch_failed_rows": self.wire_refetch_failed_rows,
            }
        return s


def fold_candidates(cur_d2, cur_idx, rows, d2, idx, k):
    """Fold one slab's candidate rows into the running per-query top-k
    under the canonical (dist2, id) total order, in numpy. Commutative and
    associative (ids are unique), so the order in which slabs complete can
    never change the folded bits; init slots (id -1) still win their ties
    at the radius cutoff, preserving the engines' strict-< adoption.
    Shared by the routed fan-out above and the tiered slab pool's
    in-process fold (serve/slabpool.py): one fold, one tie discipline."""
    cat_d2 = np.concatenate([cur_d2[rows], np.asarray(d2, np.float32)],
                            axis=1)
    cat_idx = np.concatenate([cur_idx[rows], np.asarray(idx, np.int32)],
                             axis=1)
    order = np.lexsort((cat_idx, cat_d2), axis=1)[:, :k]
    cur_d2[rows] = np.take_along_axis(cat_d2, order, axis=1)
    cur_idx[rows] = np.take_along_axis(cat_idx, order, axis=1)


class FrontendServer(ThreadingHTTPServer):
    """Public pod front end: the single-host server's exact HTTP contract
    (POST /knn JSON + binary, /healthz, /stats, /metrics) backed by a
    ``PodFanout`` instead of a local engine, with the same admission
    backpressure and the same pipelined ``DynamicBatcher``."""

    daemon_threads = True
    request_queue_size = LISTEN_BACKLOG

    def __init__(self, addr, fanout: PodFanout, *, max_delay_s=0.002,
                 max_queue_rows=4096, default_timeout_s=5.0,
                 pipeline_depth=2, min_batch=8, on_host_loss="fail",
                 verbose=False, recall_policy=None,
                 qcache_rows=4096, qcache_seed_rows=512):
        if on_host_loss not in ("fail", "degrade"):
            raise ValueError(f"on_host_loss must be 'fail' or 'degrade', "
                             f"got {on_host_loss!r}")
        self.fanout = fanout
        #: recall-SLO tier (serve/recall.py). Plans only engage on a
        #: routed fan-out (``supports_recall``); a replicate pod serves
        #: every target exactly — exact always meets any target. The
        #: built-in default table is k-conditioned on the pod's k.
        self.recall_policy = (
            RecallPolicy.for_k(getattr(fanout, "k", None))
            if recall_policy is None else recall_policy)
        #: what happens to queries whose certified routing set touches a
        #: drained slab: "fail" 503s them (exactness preserved), "degrade"
        #: serves the surviving hosts' fold flagged ``exact: false``
        self.on_host_loss = on_host_loss
        #: background drain/rejoin supervisor (serve/health.py); attached
        #: by build_frontend, stopped by close()
        self.monitor: HealthMonitor | None = None
        self.admission = AdmissionController(
            max_queue_rows=max_queue_rows,
            default_timeout_s=default_timeout_s)
        #: certified query cache (serve/qcache.py): exact hits and dedup
        #: on any pod; radius seeds only on a routed fan-out (a replicate
        #: pod folds every host anyway — a tightened radius saves nothing
        #: on its wire, so seeding stays off there)
        self.qcache = None
        if qcache_rows:
            seeding = bool(getattr(fanout, "supports_recall", False))
            self.qcache = QueryCache(
                capacity_rows=qcache_rows,
                seed_rows=(qcache_seed_rows if seeding else 0),
                fingerprint=f"pod:{type(fanout).__name__}"
                            f":hosts={len(fanout.endpoints)}:k={fanout.k}")
        self.batcher = DynamicBatcher(fanout, max_batch=fanout.max_batch,
                                      max_delay_s=max_delay_s,
                                      timers=fanout.timers,
                                      pipeline_depth=pipeline_depth,
                                      min_batch=min_batch,
                                      qcache=self.qcache)
        self.admission.pipeline_rows_fn = self.batcher.inflight_rows
        self.metrics = ServingMetrics()
        # pre-seed the failure-path counters so dashboards see zeros, not
        # missing series, before the first incident
        for name in ("knn_degraded_responses_total", "knn_unavailable_total"):
            self.metrics.inc(name, 0)
        self.ready = False
        self.verbose = verbose
        self._loop_entered = False
        super().__init__(addr, _FrontendHandler)

    def serve_forever(self, poll_interval=0.5):
        self._loop_entered = True
        super().serve_forever(poll_interval)

    def close(self):
        if self.monitor is not None:
            self.monitor.stop()
        self.batcher.shutdown()
        self.fanout.close()
        if self._loop_entered:
            self.shutdown()
        self.server_close()


class _FrontendHandler(JsonHttpHandler):
    # the POST /knn flow below deliberately mirrors server.py _Handler's
    # (same status mapping, same binary/JSON responses) — the two ARE the
    # same public contract; change them together
    def do_GET(self):
        srv: FrontendServer = self.server
        path = urlparse(self.path).path
        if path == "/healthz":
            # with a running monitor, answer from its supervised state (no
            # inline probe storm per scrape); otherwise probe live
            if srv.monitor is not None and srv.monitor.running:
                # suspect still counts as up: it is serving every request
                # (one blip of fail_threshold); only drained/rejoining
                # hosts are genuinely out of rotation
                hosts = {url: {"ok": h["state"] in ("healthy", "suspect"),
                               **h}
                         for url, h in srv.fanout.health_snapshot().items()}
            else:
                hosts = srv.fanout.probe_health()
            n_ok = sum(1 for h in hosts.values() if h.get("ok"))
            routed = getattr(srv.fanout, "routing_mode", "off") == "bounds"
            broken = srv.fanout.broken_reason()
            if broken or n_ok == 0 or not srv.ready:
                status, code = ("broken" if broken else "degraded"), 503
            elif n_ok == len(hosts):
                status, code = "ok", 200
            elif routed:
                # partial capacity: a routed pod keeps serving around the
                # drained slab (degraded or selectively 503d per policy)
                status, code = "degraded", 200
            else:
                status, code = "degraded", 503
            self._send_json(code, {
                "status": status,
                "role": "pod-frontend",
                "broken": broken,
                "on_host_loss": srv.on_host_loss,
                "hosts": hosts})
        elif path == "/stats":
            fan_stats = srv.fanout.stats()
            self._send_json(200, {
                "fanout": fan_stats,
                "pod": {
                    "on_host_loss": srv.on_host_loss,
                    "broken": fan_stats["broken"],
                    # same snapshot the fanout block embeds — taken once,
                    # so the two read paths can never diverge
                    "health": fan_stats["health"],
                    "monitor": (srv.monitor.stats()
                                if srv.monitor is not None else None),
                },
                "batcher": srv.batcher.stats(),
                "admission": srv.admission.stats(),
                "server": dict(srv.metrics.snapshot(),
                               request_latency=srv.metrics.latency.report()),
                "recall": dict(srv.metrics.recall_snapshot(),
                               policy=srv.recall_policy.stats()),
                "hosts": srv.fanout.scrape_host_stats(),
                **({"qcache": srv.qcache.stats()}
                   if srv.qcache is not None else {}),
            })
        elif path == "/metrics":
            self._send(200, self._prometheus(srv).encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no such path {path}"})

    @staticmethod
    def _prometheus(srv: FrontendServer) -> str:
        f, b, a = (srv.fanout.stats(), srv.batcher.stats(),
                   srv.admission.stats())
        lines = []
        for name, val in srv.metrics.snapshot().items():
            lines += [f"# TYPE {name} counter", f"{name} {val}"]
        for name, val in (
                ("knn_fanout_batches_total", f["batches"]),
                ("knn_fanout_straggler_seconds_total",
                 f["straggler_seconds_total"]),
                ("knn_dispatch_stall_seconds_total",
                 b["dispatch_stall_seconds"]),
                ("knn_dispatch_stalls_total", b["dispatch_stalls"])):
            lines += [f"# TYPE {name} counter", f"{name} {val}"]
        gauges = {
            "knn_ready": int(srv.ready),
            "knn_pod_broken": int(f["broken"] is not None),
            "knn_pod_hosts": len(f["hosts"]),
            "knn_queue_rows": b["queue_rows"],
            "knn_inflight_rows": a["inflight_rows"],
            "knn_admission_rejected_total": a["rejected"],
            "knn_batches_total": b["batches"],
            "knn_pipeline_depth": b["pipeline_depth"],
            "knn_pipeline_inflight_batches": b["inflight_batches"],
        }
        for name, val in gauges.items():
            lines += [f"# TYPE {name} gauge", f"{name} {val}"]
        # certified query cache (serve/qcache.py), absent when off
        lines += qcache_prometheus_lines(srv.qcache)
        # per-host health + latency percentiles (straggler hunting): one
        # gauge line per host, labelled by endpoint
        lines += ["# TYPE knn_host_up gauge", "# TYPE knn_host_p99_seconds "
                  "gauge", "# TYPE knn_host_errors_total gauge"]
        for url, h in f["per_host"].items():
            up = int(h["errors"] == 0 or h["ok"] > 0)
            p99 = h["latency"].get("p99")
            lines += [f'knn_host_up{{host="{url}"}} {up}',
                      f'knn_host_errors_total{{host="{url}"}} {h["errors"]}']
            if p99 is not None:
                lines += [f'knn_host_p99_seconds{{host="{url}"}} {p99}']
        # supervised lifecycle surface: state enum (0 healthy / 1 suspect /
        # 2 drained / 3 rejoining), dispatch retries, cumulative drained
        # seconds — the drain/rejoin story as numbers
        lines += ["# TYPE knn_host_state gauge"] + [
            f'knn_host_state{{host="{url}"}} {h["state_code"]}'
            for url, h in f["health"].items()]
        lines += ["# TYPE knn_dispatch_retries_total counter"] + [
            f'knn_dispatch_retries_total{{host="{url}"}} {h["retries"]}'
            for url, h in f["health"].items()]
        lines += ["# TYPE knn_host_drained_seconds_total counter"] + [
            f'knn_host_drained_seconds_total{{host="{url}"}} '
            f'{h["drained_seconds_total"]}'
            for url, h in f["health"].items()]
        lines += ["# TYPE knn_host_probe_errors_total counter"] + [
            f'knn_host_probe_errors_total{{host="{url}"}} '
            f'{h["probe_errors"]}'
            for url, h in f["health"].items()]
        # shard-local routing observability: escalation + per-host routed
        # rows + the hosts-visited-per-query histogram (the routing win as
        # a number: mean ~1 = clustered traffic certifying after one host,
        # mean ~H = incoherent traffic degenerating to replicate-everything)
        routing = f.get("routing")
        if routing:
            lines += ["# TYPE knn_routing_escalations_total counter",
                      f"knn_routing_escalations_total "
                      f"{routing['escalations']}",
                      "# TYPE knn_routing_escalation_waves_total counter",
                      f"knn_routing_escalation_waves_total "
                      f"{routing['escalation_waves']}",
                      "# TYPE knn_degraded_rows_total counter",
                      f"knn_degraded_rows_total "
                      f"{routing['degraded_rows']}"]
            lines += ["# TYPE knn_routed_rows_total counter"] + [
                f'knn_routed_rows_total{{host="{u}"}} {v}'
                for u, v in routing["routed_rows"].items()]
            hpq = {int(c): v for c, v in routing["hosts_per_query"].items()}
            total = sum(hpq.values())
            hsum = sum(c * v for c, v in hpq.items())
            lines += ["# TYPE knn_hosts_per_query histogram"]
            cum = 0
            for c in sorted(hpq):
                cum += hpq[c]
                lines += [f'knn_hosts_per_query_bucket{{le="{c}"}} {cum}']
            lines += [f'knn_hosts_per_query_bucket{{le="+Inf"}} {total}',
                      f"knn_hosts_per_query_sum {hsum}",
                      f"knn_hosts_per_query_count {total}"]
            # replication surface: live replicas per slab (0 = the only
            # state that can cost exactness), pick-spread per host, and
            # the handoff counters from the monitor's replica manager
            replicas = routing.get("replicas")
            if replicas:
                lines += ["# TYPE knn_replica_live gauge"] + [
                    f'knn_replica_live{{slab="{p["slab"]}"}} {p["live"]}'
                    for p in replicas["per_slab"]]
                lines += ["# TYPE knn_replica_spread gauge"] + [
                    f'knn_replica_spread{{host="{u}"}} {c}'
                    for u, c in sorted(replicas["spread"].items())]
                lines += ["# TYPE knn_replica_rebinds_total counter",
                          f"knn_replica_rebinds_total "
                          f"{replicas['rebinds']}"]
            mon = srv.monitor
            handoff = (mon.stats().get("handoff")
                       if mon is not None else None)
            if handoff:
                lines += [
                    "# TYPE knn_handoffs_total counter",
                    f"knn_handoffs_total {handoff['handoffs']}",
                    "# TYPE knn_handoff_rejections_total counter",
                    f"knn_handoff_rejections_total "
                    f"{handoff['handoff_rejections']}",
                    "# TYPE knn_handoff_failures_total counter",
                    f"knn_handoff_failures_total "
                    f"{handoff['handoff_failures']}",
                    "# TYPE knn_handoff_seconds_total counter",
                    f"knn_handoff_seconds_total "
                    f"{handoff['handoff_seconds_total']}"]
        # quantized wire exchange: bytes/rows per (path, codec) — the
        # same families the hosts export, so a scrape sees both ends
        # (routed fan-out only; the replicate pod ships no partials)
        wire_stats = getattr(srv.fanout, "wire_stats", None)
        if wire_stats is not None:
            lines += wire_stats.prometheus_lines()
        # recall-SLO tier: exact/approx split + recall_estimated histogram
        lines += srv.metrics.recall_prometheus_lines()
        lines += srv.metrics.latency.prometheus_lines(
            "knn_request_latency_seconds")
        for src, prom in (("fanout_batch_seconds", "knn_fanout_batch_seconds"),
                          ("fanout_straggler_seconds",
                           "knn_fanout_straggler_seconds"),
                          ("pipeline_stall_seconds",
                           "knn_pipeline_stall_seconds")):
            hist = srv.fanout.timers.histograms.get(src)
            if hist is not None:
                lines += hist.prometheus_lines(prom)
        return "\n".join(lines) + "\n"

    def do_POST(self):
        srv: FrontendServer = self.server
        if urlparse(self.path).path != "/knn":
            self._send_json(404, {"error": "POST /knn only"})
            return
        srv.metrics.inc("knn_requests_total")
        t0 = time.perf_counter()
        try:
            # the pod front end serves one index — the parsed tenant (a
            # serve/tenancy.py concern) is ignored, like the single-index
            # server does
            q, want_nbrs, timeout_s, recall, _tenant, binary = (
                parse_knn_body(self.path, self.headers, self.rfile,
                               dim=getattr(srv.fanout, "dim", 3)))
        except (ValueError, json.JSONDecodeError) as e:
            srv.metrics.inc("knn_badrequest_total")
            self._send_json(400, {"error": str(e)})
            return
        # plans only engage on a routed fan-out; a replicate pod is
        # plan-blind and serves the target exactly (plan stays None)
        plan = (srv.recall_policy.plan_for(recall)
                if recall is not None
                and getattr(srv.fanout, "supports_recall", False) else None)
        timeout_s = timeout_s or srv.admission.default_timeout_s
        n = len(q)
        if n > srv.fanout.max_batch:
            srv.metrics.inc("knn_badrequest_total")
            self._send_json(413, {
                "error": f"batch of {n} exceeds max_batch "
                         f"{srv.fanout.max_batch}; split the request"})
            return
        if n == 0:
            if binary:
                self._send(200, b"", "application/octet-stream")
            else:
                self._send_json(200, {"dists": []})
            return
        try:
            with srv.admission.admitted_rows(n):
                res = srv.batcher.submit(q, timeout_s=timeout_s, plan=plan)
        except OverloadError as e:
            srv.metrics.inc("knn_overload_total")
            self._send_json(429, {"error": str(e)},
                            extra=[("Retry-After", f"{e.retry_after_s:g}")])
            return
        except DeadlineExceeded as e:
            srv.metrics.inc("knn_deadline_total")
            self._send_json(504, {"error": str(e)})
            return
        except PodBrokenError as e:
            # drain-then-fail: the pod stream is down until the hosts
            # restart together (the monitor's reset path) — an operational
            # state, not a server bug, so 503 + Retry-After, never 500
            srv.metrics.inc("knn_unavailable_total")
            self._send_json(503, {"error": f"PodBrokenError: {e}"},
                            extra=[("Retry-After", "1")])
            return
        except Exception as e:  # noqa: BLE001 - the service must not die
            srv.metrics.inc("knn_error_total")
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        # routed fan-outs return (dists, nbrs, exact); the replicate pod's
        # stream is all-or-nothing, so its results are always exact
        dists, nbrs = res[0], res[1]
        exact = res[2] if len(res) > 2 else None
        all_exact = bool(exact.all()) if exact is not None else True
        if not all_exact and srv.on_host_loss == "fail":
            # only the queries whose certified routing set touches the
            # drained slab are refused; a request is the granularity the
            # client can retry, so any inexact row 503s the request
            srv.metrics.inc("knn_unavailable_total")
            self._send_json(503, {
                "error": f"{int((~exact).sum())} of {n} queries touch a "
                         "drained host slab (on-host-loss=fail); retry "
                         "after the host rejoins",
                "exact": False},
                extra=[("Retry-After", "1")])
            return
        if not all_exact:
            srv.metrics.inc("knn_degraded_responses_total")
        srv.metrics.inc("knn_rows_total", n)
        srv.metrics.note_recall(plan)
        srv.metrics.latency.record(time.perf_counter() - t0)
        fields, rhdrs = recall_response_fields(plan, recall)
        if plan is None and not all_exact:
            # a target served on the exact plan but degraded by host loss
            # must not claim exactness — the degradation surface below
            # (exact/exact_per_query, X-Knn-Exact) is the truthful answer
            fields, rhdrs = {}, []
        if binary:
            self._send(200, np.asarray(dists, "<f4").tobytes(),
                       "application/octet-stream",
                       extra=(rhdrs if rhdrs else
                              [] if exact is None else
                              [("X-Knn-Exact", "1" if all_exact else "0")]))
        else:
            out = {"dists": np.asarray(dists, np.float64).tolist()}
            if want_nbrs:
                out["neighbors"] = np.asarray(nbrs).tolist()
            if exact is not None:
                out["exact"] = all_exact
                if not all_exact:
                    out["exact_per_query"] = [bool(x) for x in exact]
            out.update(fields)
            self._send_json(200, out)


# ------------------------------------------------------------------ startup


def wait_hosts_ready(host_urls: list[str], timeout_s: float = 600.0,
                     poll_s: float = 1.0) -> None:
    """Block until every host's /healthz answers 200 (engines warmed).
    A probe failure here is the EXPECTED state (still warming / not bound
    yet), but it is recorded, not swallowed: the last error per host is
    what the timeout message reports, so "not ready" is actionable."""
    deadline = time.monotonic() + timeout_s
    pending = list(host_urls)
    last_err = "no probe answered"
    while pending:
        url = pending[0]
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                        timeout=5.0) as r:
                if r.status == 200:
                    pending.pop(0)
                    continue
                last_err = f"healthz answered {r.status}"
        except Exception as e:  # noqa: BLE001 - warming IS an answer here
            last_err = f"{type(e).__name__}: {e}"
        if time.monotonic() > deadline:
            raise TimeoutError(f"host {url} not ready after "
                               f"{timeout_s:.0f}s (last error: {last_err})")
        time.sleep(poll_s)


def pod_config_from_hosts(host_urls: list[str],
                          routing: str = "auto") -> dict:
    """Scrape every host's /stats, detect the serving mode, and validate
    the pod is coherent.

    ``routing="auto"`` adopts whatever mode the hosts were launched in
    (they must all agree); "off"/"bounds" additionally assert it. The
    replicate pod (off) validates: the same k / max_batch / shape buckets
    / merge=device and every other launch-plan knob, process_count
    matching the host list, mesh positions covering the whole axis. The
    routed pod (bounds) validates: every host independent (process_count
    1) with emit='candidates', same k / dim / score config / radius cap,
    and the hosts' row slabs tiling [0, N) with no gap or overlap — a hole
    would silently drop real neighbors. Returns the front-end construction
    config (routed configs carry ``host_urls`` re-ordered ascending by row
    offset plus the bounds-table inputs)."""
    if routing not in ("auto", "off", "bounds"):
        raise ValueError(f"routing must be auto|off|bounds, got {routing!r}")
    raw = []
    for url in host_urls:
        with urllib.request.urlopen(url.rstrip("/") + "/stats",
                                    timeout=10.0) as r:
            raw.append(json.loads(r.read().decode()))
    modes = {s.get("routing", "off") for s in raw}
    if len(modes) != 1:
        raise ValueError(f"hosts disagree on serving mode: {sorted(modes)} "
                         "— launch every host with the same --routing")
    mode = modes.pop()
    if routing != "auto" and routing != mode:
        raise ValueError(f"front end asked for routing='{routing}' but the "
                         f"hosts serve routing='{mode}'")
    stats = [s["engine"] for s in raw]
    # per-host config/bounds fingerprints, captured at validation time: the
    # health monitor's rejoin gate compares a RETURNING host against these
    # (serve/health.py host_fingerprint) before undraining it
    fingerprints = {url: host_fingerprint(e, mode)
                    for url, e in zip(host_urls, stats)}
    ref = stats[0]
    if mode == "off":
        covered: set[int] = set()
        for url, e in zip(host_urls, stats):
            # every key that feeds the launch plan's identity must agree,
            # or the hosts would enter the pod-wide merge with different
            # operands (engine and buckets change the traversal;
            # query_buckets / sort_queries change the staged batch and the
            # Morton permutation each host computes locally)
            for key in ("k", "max_batch", "num_shards", "shape_buckets",
                        "merge", "n_points", "engine", "bucket_size",
                        "query_buckets", "sort_queries", "score_dtype",
                        "dim"):
                if e.get(key) != ref.get(key):
                    raise ValueError(
                        f"pod mismatch: host {url} has {key}={e.get(key)!r},"
                        f" host {host_urls[0]} has {ref.get(key)!r}")
            if e.get("merge") != "device":
                raise ValueError(f"host {url} serves merge="
                                 f"{e.get('merge')!r}; the pod front end "
                                 "needs merge='device'")
            if e.get("process_count") != len(host_urls):
                raise ValueError(
                    f"host {url} reports process_count="
                    f"{e.get('process_count')} but the front end was given "
                    f"{len(host_urls)} hosts")
            covered.update(e.get("my_positions", []))
        if covered != set(range(ref["num_shards"])):
            raise ValueError(
                f"host list covers mesh positions {sorted(covered)} of "
                f"{ref['num_shards']} — slices would be missing rows")
        return {"routing": "off",
                "host_urls": list(host_urls),
                "fingerprints": fingerprints,
                "k": ref["k"], "max_batch": ref["max_batch"],
                "min_batch": ref["shape_buckets"][0],
                "num_shards": ref["num_shards"],
                "n_points": ref["n_points"], "dim": ref.get("dim", 3)}
    for url, e in zip(host_urls, stats):
        # routed hosts answer independently, so only the result CONTRACT
        # must agree — k, dim, radius semantics, score dtype (distances
        # must be the same f32 values on every host) — plus the
        # candidate-emission wire format
        for key in ("k", "dim", "max_radius", "score_dtype", "max_batch"):
            if e.get(key) != ref.get(key):
                raise ValueError(
                    f"routed pod mismatch: host {url} has "
                    f"{key}={e.get(key)!r}, host {host_urls[0]} has "
                    f"{ref.get(key)!r}")
        if e.get("emit") != "candidates":
            raise ValueError(f"host {url} serves emit={e.get('emit')!r};"
                             " routed hosts must emit candidates")
        if e.get("process_count", 1) > 1:
            raise ValueError(f"host {url} joined a global mesh "
                             "(process_count > 1) — routed hosts are "
                             "independent processes")
    if not all(e.get("canonical_ties", False) for e in stats):
        print("warning: a routed host serves without canonical "
              "(dist2, id) ties — distances stay exact, but "
              "equal-distance neighbor-id choices may differ from one "
              "engine over all the points")
    # replica grouping (serve/replica.py): hosts claiming the same row
    # range are replicas of one slab — replica-for-replica fingerprint
    # equality and slab tiling over the GROUPS are validated there
    from mpi_cuda_largescaleknn_torch.serve.replica import (
        group_routed_hosts,
    )

    grouped = group_routed_hosts(host_urls, stats, fingerprints)
    # wire caps come from the /stats ROOT (a host without them → f32),
    # keyed by url so the negotiator can resolve per endpoint
    caps = {url: s.get("wire") for url, s in zip(host_urls, raw)}
    return {"routing": "bounds",
            "host_urls": grouped["host_urls"],
            "wire_host_caps": caps,
            "fingerprints": fingerprints,
            "replica_groups": grouped["slabs"],
            "slab_fingerprints": grouped["slab_fingerprints"],
            "k": ref["k"], "dim": ref.get("dim", 3),
            "max_batch": min(e["max_batch"] for e in stats),
            # routed sub-batches start the moment a host is idle (no
            # pod-wide program to queue behind), so the batcher's
            # stall-aware flush floor drops to 1 row
            "min_batch": 1,
            "n_points": grouped["n_points"],
            "bounds_hosts": grouped["bounds_hosts"]}


def build_frontend(host_urls: list[str], *, host: str = "127.0.0.1",
                   port: int = 8080, max_delay_s: float = 0.002,
                   pipeline_depth: int = 2, max_queue_rows: int = 4096,
                   default_timeout_s: float = 5.0, timeout_s: float = 120.0,
                   routing: str = "auto", on_host_loss: str = "fail",
                   retries: int = 2, retry_backoff_s: float = 0.05,
                   request_timeout_s: float | None = None,
                   probe_interval_s: float = 5.0, fail_threshold: int = 3,
                   health_config: dict | None = None,
                   start_monitor: bool = True,
                   standbys: list[str] | None = None,
                   handoff_floor: int = 1, wire: str = "auto",
                   qcache_rows: int = 4096, qcache_seed_rows: int = 512,
                   verbose: bool = False) -> FrontendServer:
    """Validate the pod and construct (but do not start) a
    FrontendServer; ``port=0`` picks a free port
    (``server.server_address[1]``). ``routing`` selects the fan-out:
    "off" = the replicate pod, "bounds" = shard-local routing, "auto" =
    whatever the hosts serve. ``on_host_loss`` picks the drained-slab
    policy (fail = 503 affected queries, degrade = serve them flagged
    ``exact: false``); the health monitor starts supervising immediately
    unless ``start_monitor=False`` (tests drive
    ``server.monitor.check_once()`` by hand instead). Routed pods: hosts
    claiming the same row range are REPLICAS of one slab (exactness
    degrades only when all of a slab's replicas are down); ``standbys``
    lists warm ``--standby`` hosts the monitor's replica manager directs
    to adopt a slab whose live-replica count falls below
    ``handoff_floor``. ``wire`` picks the candidate-exchange codec policy
    (routed pods): "auto" negotiates the compressed q16 exchange with
    every capable host (the exact f32 re-merge keeps served bits
    identical), "f32" forces the uncompressed wire everywhere, "q16" is
    auto said explicitly."""
    from mpi_cuda_largescaleknn_torch.serve.replica import ReplicaManager

    cfg = pod_config_from_hosts(host_urls, routing=routing)
    hc = dict(fail_threshold=fail_threshold,
              probe_interval_s=probe_interval_s)
    hc.update(health_config or {})
    if cfg["routing"] == "bounds":
        table = PodBoundsTable(cfg["bounds_hosts"], cfg["dim"])
        fanout: PodFanout = RoutedPodFanout(
            cfg["host_urls"], k=cfg["k"], max_batch=cfg["max_batch"],
            bounds=table, timeout_s=timeout_s, dim=cfg["dim"],
            retries=retries, retry_backoff_s=retry_backoff_s,
            request_timeout_s=request_timeout_s, health_config=hc,
            replica_groups=cfg["replica_groups"], wire=wire,
            wire_host_caps=cfg.get("wire_host_caps"))
    else:
        if standbys:
            raise ValueError("standby hosts (slab handoff) apply to "
                             "routed pods only — a replicate-mode pod is "
                             "one program across its hosts")
        fanout = PodFanout(cfg["host_urls"], k=cfg["k"],
                           max_batch=cfg["max_batch"],
                           timeout_s=timeout_s, dim=cfg["dim"],
                           retries=retries, retry_backoff_s=retry_backoff_s,
                           request_timeout_s=request_timeout_s,
                           health_config=hc)
    server = FrontendServer((host, port), fanout, max_delay_s=max_delay_s,
                            pipeline_depth=pipeline_depth,
                            max_queue_rows=max_queue_rows,
                            default_timeout_s=default_timeout_s,
                            min_batch=cfg["min_batch"],
                            on_host_loss=on_host_loss,
                            qcache_rows=qcache_rows,
                            qcache_seed_rows=qcache_seed_rows,
                            verbose=verbose)
    server.monitor = HealthMonitor(fanout,
                                   fingerprints=cfg["fingerprints"],
                                   mode=cfg["routing"])
    if cfg["routing"] == "bounds":
        # the handoff brain rides the monitor's check_once cadence; a
        # bound standby is registered in the monitor's fingerprint table
        # so its own later drain/rejoin cycles get the same gate
        server.monitor.replica_manager = ReplicaManager(
            fanout, slabs=cfg["replica_groups"],
            slab_fingerprints=cfg["slab_fingerprints"],
            standbys=standbys or [], handoff_floor=handoff_floor,
            fingerprint_registry=server.monitor.fingerprints)
    if start_monitor:
        server.monitor.start()
    return server


FRONTEND_FLAGS = """
  --hosts U1,U2,... per-host servers (required): the replicate pod's
                    (serve_main --coordinator, one per process, in any
                    order — mesh coverage is validated at startup) or the
                    routed pod's (serve_main --routing bounds, one per
                    slab or several per slab as replicas, in any order —
                    slab tiling is validated at startup)
  --port P          HTTP port (default 8080; 0 = pick a free port)
  --host H          bind address (default 127.0.0.1)
  --max-delay-ms F  micro-batch flush deadline (default 2.0)
  --pipeline-depth N  pod batches in flight between dispatch and demux
                    (default 2)
  --max-queue-rows N  admission cap on queued+running rows (default 4096)
  --timeout-ms F    default per-request deadline (default 5000)
  --wait-ready-s F  how long to wait for host warmup (default 600)
  --routing M       auto | off | bounds (default auto = adopt the hosts'
                    mode): off replicates every batch pod-wide; bounds
                    routes each query only to hosts whose shard AABBs can
                    beat its current k-th distance, with certified
                    escalation
  --on-host-loss P  fail | degrade (default fail): what happens to queries
                    whose certified routing set touches a DRAINED host —
                    fail answers them 503 + Retry-After (exactness
                    preserved), degrade serves the surviving hosts' fold
                    flagged exact:false
  --retries N       bounded retries per routed sub-batch on transient
                    failures: connect errors, timeouts, 5xx (default 2)
  --retry-backoff-ms F  base of the capped-exponential retry backoff
                    (default 50; deterministic jitter rides on top)
  --request-timeout-ms F  per-TRY budget for routed host posts (default:
                    the pod-wide fan-out timeout); one slow host burns at
                    most this per attempt instead of poisoning the batch
  --probe-interval-s F  health monitor probe cadence for healthy hosts
                    (default 5; drained hosts re-probe on capped
                    exponential backoff + jitter)
  --fail-threshold N  consecutive failures that drain a host (default 3)
  --standbys U1,U2,...  warm standby hosts (serve_main --standby; routed
                    pods only): when a slab's live-replica count falls
                    below --handoff-floor the monitor directs one to
                    ADOPT the slab (POST /adopt_slab), fingerprint-gated
                    before it serves
  --handoff-floor N live replicas per slab below which a handoff starts
                    (default 1 = hand off only when a slab is fully
                    down; R with --handoff-floor R keeps full replication
                    through any single loss)
  --wire M          auto | f32 | q16 (default auto): candidate-exchange
                    codec policy for routed pods — auto negotiates the compressed q16 wire
                    per host (served bits stay identical: exact f32
                    re-merge), f32 forces the uncompressed exchange
  --qcache-rows N   certified query cache capacity in cached rows
                    (default 4096; 0 disables the cache entirely).
                    Exact-hit reuse and in-flight dedup are byte-identical
                    by construction
  --qcache-seed-rows N  triangle-inequality seed pool rows per tenant
                    (default 512; 0 disables radius seeding while
                    keeping the hit/dedup tiers). Seeding applies on
                    routed pods only — a replicate pod folds every host
                    regardless
  --verbose         log each HTTP request to stderr
"""


def main(argv: list[str] | None = None, ready=None) -> int:
    """``python -m mpi_cuda_largescaleknn_torch.serve.frontend --hosts
    U1,U2,... --port P``: wait for the hosts, validate the pod and serve
    until interrupted. ``ready`` (for callers that run it in process) is
    called with the server once it is listening; the caller stops it with
    ``server.shutdown()`` from another thread."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    opt = {"hosts": "", "port": 8080, "host": "127.0.0.1",
           "max_delay_ms": 2.0, "pipeline_depth": 2,
           "max_queue_rows": 4096, "timeout_ms": 5000.0,
           "wait_ready_s": 600.0, "routing": "auto",
           "on_host_loss": "fail", "retries": 2,
           "retry_backoff_ms": 50.0, "request_timeout_ms": 0.0,
           "probe_interval_s": 5.0, "fail_threshold": 3,
           "standbys": "", "handoff_floor": 1, "wire": "auto",
           "qcache_rows": 4096, "qcache_seed_rows": 512,
           "verbose": False}
    i = 0
    try:
        while i < len(args):
            a = args[i]
            if a == "--hosts":
                i += 1; opt["hosts"] = args[i]
            elif a == "--port":
                i += 1; opt["port"] = int(args[i])
            elif a == "--host":
                i += 1; opt["host"] = args[i]
            elif a == "--max-delay-ms":
                i += 1; opt["max_delay_ms"] = float(args[i])
            elif a == "--pipeline-depth":
                i += 1; opt["pipeline_depth"] = int(args[i])
            elif a == "--max-queue-rows":
                i += 1; opt["max_queue_rows"] = int(args[i])
            elif a == "--timeout-ms":
                i += 1; opt["timeout_ms"] = float(args[i])
            elif a == "--wait-ready-s":
                i += 1; opt["wait_ready_s"] = float(args[i])
            elif a == "--routing":
                i += 1; opt["routing"] = args[i]
            elif a == "--on-host-loss":
                i += 1; opt["on_host_loss"] = args[i]
            elif a == "--retries":
                i += 1; opt["retries"] = int(args[i])
            elif a == "--retry-backoff-ms":
                i += 1; opt["retry_backoff_ms"] = float(args[i])
            elif a == "--request-timeout-ms":
                i += 1; opt["request_timeout_ms"] = float(args[i])
            elif a == "--probe-interval-s":
                i += 1; opt["probe_interval_s"] = float(args[i])
            elif a == "--fail-threshold":
                i += 1; opt["fail_threshold"] = int(args[i])
            elif a == "--standbys":
                i += 1; opt["standbys"] = args[i]
            elif a == "--handoff-floor":
                i += 1; opt["handoff_floor"] = int(args[i])
            elif a == "--wire":
                i += 1; opt["wire"] = args[i]
            elif a == "--qcache-rows":
                i += 1; opt["qcache_rows"] = int(args[i])
            elif a == "--qcache-seed-rows":
                i += 1; opt["qcache_seed_rows"] = int(args[i])
            elif a == "--verbose":
                opt["verbose"] = True
            else:
                raise ValueError(f"unknown cmdline arg '{a}'")
            i += 1
        hosts = [h for h in opt["hosts"].split(",") if h]
        if not hosts:
            raise ValueError("--hosts is required (comma-separated URLs)")
    except (IndexError, ValueError) as e:
        sys.stderr.write(f"Error: {e}\n\ntorchknn-frontend --hosts <urls> "
                         f"[options]\n{FRONTEND_FLAGS}")
        return 1

    print(f"waiting for {len(hosts)} host(s) to warm up...")
    wait_hosts_ready(hosts, timeout_s=opt["wait_ready_s"])
    server = build_frontend(
        hosts, host=opt["host"], port=opt["port"],
        max_delay_s=opt["max_delay_ms"] / 1e3,
        pipeline_depth=opt["pipeline_depth"],
        max_queue_rows=opt["max_queue_rows"],
        default_timeout_s=opt["timeout_ms"] / 1e3,
        routing=opt["routing"], on_host_loss=opt["on_host_loss"],
        retries=opt["retries"],
        retry_backoff_s=opt["retry_backoff_ms"] / 1e3,
        request_timeout_s=(opt["request_timeout_ms"] / 1e3
                           if opt["request_timeout_ms"] > 0 else None),
        probe_interval_s=opt["probe_interval_s"],
        fail_threshold=opt["fail_threshold"],
        standbys=[s for s in opt["standbys"].split(",") if s],
        handoff_floor=opt["handoff_floor"], wire=opt["wire"],
        qcache_rows=opt["qcache_rows"],
        qcache_seed_rows=opt["qcache_seed_rows"],
        verbose=opt["verbose"])
    server.ready = True
    h, p = server.server_address[:2]
    mode = getattr(server.fanout, "routing_mode", "off")
    print(f"pod front end on http://{h}:{p} fanning to {len(hosts)} host(s) "
          f"(routing={mode}, "
          f"on-host-loss={opt['on_host_loss']})", flush=True)
    if ready is not None:
        ready(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
