"""Replica groups, slab pulls and slab handoff of a routed pod.

The port of the JAX package's ``serve/replica.py``, used by the routed
fan-out (serve/frontend.py ``RoutedPodFanout``), its health monitor and
the tiered slab pool's ``url=`` source:

- ``ReplicaSet`` — the slab -> endpoint-group table the routed fan-out
  dispatches through. Each slab (one contiguous row range of the global
  index) is served by R >= 1 host endpoints running IDENTICAL engines
  (validated replica-for-replica by the routed ``host_fingerprint`` when
  the front end is built), so any member's answer is byte-equal to any
  other's. ``pick`` chooses one healthy member per (slab, sub-batch) with
  health-weighted spreading: per-batch failure penalties first, then the
  lifecycle state, then cumulative drained seconds and observed latency
  (coarse buckets, so noise cannot flap the choice), then a least-picked
  spread counter, with a deterministic ``crc32(seed, slab, url)``
  tie-break: no RNG, so a fixed seed reproduces the pick sequence. A slab
  is DOWN only when every member is drained, the only way a routed query
  goes ``exact: false``.
- ``group_routed_hosts`` — groups the hosts' scraped /stats into replica
  slabs and checks that the slabs tile the index.
- ``pull_slab_rows`` — a host's slab rows over ``GET /slab_rows`` (the
  d16 codec or chunked f32, crc32-verified after decode).
- ``ReplicaManager`` — the slab-HANDOFF brain, driven from the
  ``HealthMonitor``'s ``check_once`` loop. When a slab's live-replica
  count falls below ``handoff_floor``, an idle WARM STANDBY host (a
  ``serve_main --standby`` process holding no slab) is directed to adopt
  the rows through ``POST /adopt_slab``: the standby reads the slab again
  from the source file (the reference's ``read_file_portion`` split, the
  same integer arithmetic, so the adopted rows are byte-equal to the lost
  host's) or pulls them from a surviving replica (``pull_slab_rows``),
  builds the slab engine on its card, and warms every shape bucket (the
  kernels built and launched once) before it reports ready. The adopted
  slab NEVER serves unproven: the manager compares its /stats fingerprint
  with the pod table captured when the front end was built, and only an
  exact match is bound into the ``ReplicaSet``
  (``fanout.bind_replica``); a standby that came up on the wrong slab or
  config stays out of rotation with the difference in ``last_error``.

All transports are injectable (``probe_fn`` / ``stats_fn`` / ``adopt_fn``)
and time rides an injectable monotonic clock, so every handoff transition
is testable without HTTP or sleeps.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import zlib

import numpy as np

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.serve.health import (
    STATE_CODE,
    host_fingerprint,
)
from mpi_cuda_largescaleknn_torch.serve.wire import (
    WireError,
    decode_slab_chunk,
    read_frames,
)

# ------------------------------------------------------------- replica set


class ReplicaSet:
    """Slab -> replica-endpoint-group table with deterministic spreading.

    ``endpoints`` is the owning fan-out's live endpoint list, shared BY
    REFERENCE: ``bind_replica`` appends to it at runtime and ``rebind``
    here records the new member index, so the set always sees the same
    endpoints the dispatch path uses. ``groups`` come from
    ``group_routed_hosts`` (slab-major, validated); ``None`` builds the
    trivial R=1 set — one slab per endpoint, which reduces the routed
    fan-out to its exact pre-replica behavior.
    """

    def __init__(self, endpoints, groups=None, *, seed: int = 0):
        self._endpoints = endpoints
        self.seed = int(seed)
        if groups is None:
            groups = [{"row_offset": None, "n_points": None,
                       "urls": [ep.url]} for ep in endpoints]
        url_to_i = {ep.url: i for i, ep in enumerate(endpoints)}
        members, meta, covered = [], [], set()
        for g in groups:
            idxs = []
            for u in g["urls"]:
                if u not in url_to_i:
                    raise ValueError(f"replica group references unknown "
                                     f"endpoint {u!r}")
                if url_to_i[u] in covered:
                    raise ValueError(f"endpoint {u!r} appears in more than "
                                     "one replica group")
                covered.add(url_to_i[u])
                idxs.append(url_to_i[u])
            if not idxs:
                raise ValueError("empty replica group")
            members.append(idxs)
            meta.append({"row_offset": g.get("row_offset"),
                         "n_points": g.get("n_points")})
        if covered != set(range(len(endpoints))):
            raise ValueError("replica groups do not cover every endpoint")
        #: immutable per-slab identity (row range); the member lists are
        #: the mutable part
        self.slab_meta = meta
        self._lock = threading.Lock()
        # the slab->members table grows at runtime (bind_replica) while
        # dispatch threads read it and /stats scrapes snapshot it; the
        # spread counters are bumped per pick from dispatch/completion
        # threads — all access under _lock
        self._members: guarded_by("_lock") = members
        self.picks: guarded_by("_lock") = {}
        self.rebinds: guarded_by("_lock") = 0

    @property
    def num_slabs(self) -> int:
        return len(self.slab_meta)

    def members(self, slab: int) -> list[int]:
        with self._lock:
            return list(self._members[slab])

    def _usable(self, i: int, penalties, budget) -> bool:
        if (penalties is not None and budget is not None
                and penalties.get(i, 0) > budget):
            return False
        return not self._endpoints[i].health.is_drained()

    def pick(self, slab: int, *, penalties: dict | None = None,
             budget: int | None = None) -> int | None:
        """Choose a live member endpoint index for one sub-batch, or None
        when the slab has no usable replica.

        Order of preference (lexicographic key, smallest wins): per-batch
        failure penalty, lifecycle state (healthy < suspect), cumulative
        drained seconds (whole-second buckets — a historically flaky
        replica loses ties), observed p50 latency (ms buckets), pick
        count (the spreader: least-picked wins among equals), then the
        deterministic ``crc32(seed, slab, url)`` tie-break. No RNG and no
        wall-clock, so the sequence is a pure function of the health
        state and the pick history."""
        with self._lock:
            cand = list(self._members[slab])
            picks = dict(self.picks)
        best, best_key = None, None
        for i in cand:
            if not self._usable(i, penalties, budget):
                continue
            ep = self._endpoints[i]
            h = ep.health.snapshot()
            lat = ep.latency.percentile(50.0)
            key = ((penalties or {}).get(i, 0),
                   STATE_CODE[h["state"]],
                   int(h["drained_seconds_total"]),
                   int(lat * 1e3) if np.isfinite(lat) else 0,
                   picks.get(i, 0),
                   zlib.crc32(f"{self.seed}:{slab}:{ep.url}".encode()))
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best is not None:
            with self._lock:
                self.picks[best] = self.picks.get(best, 0) + 1
        return best

    def slab_live_mask(self, *, penalties: dict | None = None,
                       budget: int | None = None) -> np.ndarray:
        """bool[S]: slab has at least one usable replica. With
        ``penalties``/``budget`` the mask additionally excludes members
        over their per-batch failure budget — the same predicate ``pick``
        uses, so a True slab always yields a pick (modulo races, which
        the wave loop's no-progress escape covers)."""
        with self._lock:
            members = [list(m) for m in self._members]
        out = np.zeros(len(members), bool)
        for s, idxs in enumerate(members):
            out[s] = any(self._usable(i, penalties, budget) for i in idxs)
        return out

    def live_counts(self) -> list[int]:
        with self._lock:
            members = [list(m) for m in self._members]
        return [sum(1 for i in idxs
                    if not self._endpoints[i].health.is_drained())
                for idxs in members]

    def rebind(self, slab: int, ep_index: int) -> None:
        """Add a (handoff-validated) endpoint as a member of ``slab`` —
        the runtime re-bind of a slab's endpoint set. Only the replica
        manager calls this, after the fingerprint gate."""
        with self._lock:
            if ep_index not in self._members[slab]:
                self._members[slab].append(ep_index)
                self.rebinds += 1

    def stats(self) -> dict:
        with self._lock:
            members = [list(m) for m in self._members]
            picks = dict(self.picks)
            rebinds = self.rebinds
        per_slab = []
        spread = {}
        for s, idxs in enumerate(members):
            live = sum(1 for i in idxs
                       if not self._endpoints[i].health.is_drained())
            row = {"slab": s,
                   "row_offset": self.slab_meta[s]["row_offset"],
                   "n_points": self.slab_meta[s]["n_points"],
                   "members": [self._endpoints[i].url for i in idxs],
                   "live": live,
                   "picks": {self._endpoints[i].url: picks.get(i, 0)
                             for i in idxs}}
            per_slab.append(row)
            spread.update(row["picks"])
        return {"num_slabs": len(members), "rebinds": rebinds,
                "per_slab": per_slab, "spread": spread}


# ------------------------------------------------------- grouping/validation


def group_routed_hosts(host_urls: list[str], stats: list[dict],
                       fingerprints: dict) -> dict:
    """Group routed hosts into replica slabs and validate the groups.

    Hosts with the same ``(row_offset, n_points)`` are replicas of one
    slab; replicas must carry IDENTICAL routed fingerprints (config +
    shard bounds — they claim the same rows, so any divergence means one
    of them would serve different bytes) and the slab groups must tile
    [0, N) with no gap or overlap (a hole would drop neighbors).
    Pure function of the scraped /stats (testable without HTTP); returns
    ``{"slabs", "host_urls" (slab-major), "bounds_hosts",
    "slab_fingerprints", "n_points"}``.
    """
    groups: dict[tuple, list[int]] = {}
    for i, e in enumerate(stats):
        key = (int(e.get("row_offset", 0)), int(e.get("n_points", 0)))
        groups.setdefault(key, []).append(i)
    offset = 0
    slabs, bounds_hosts, slab_fps, urls_out = [], [], [], []
    for (off, npts), idxs in sorted(groups.items()):
        if off != offset:
            raise ValueError(
                f"routed host slabs do not tile the index: slab at row "
                f"{off} (host {host_urls[idxs[0]]}), expected {offset} — "
                "a gap or overlap would drop or double-count neighbors")
        fp0 = fingerprints[host_urls[idxs[0]]]
        for j in idxs[1:]:
            fpj = fingerprints[host_urls[j]]
            if fpj != fp0:
                diff = sorted(k for k in fp0
                              if fp0.get(k) != fpj.get(k))
                raise ValueError(
                    f"replica mismatch for slab rows [{off}:{off + npts}): "
                    f"host {host_urls[j]} differs from "
                    f"{host_urls[idxs[0]]} on {diff} — replicas must be "
                    "byte-interchangeable (same config, same shard bounds)")
        urls = [host_urls[j] for j in idxs]
        slabs.append({"row_offset": off, "n_points": npts, "urls": urls})
        bounds_hosts.append({"row_offset": off, "n_points": npts,
                             "shards": stats[idxs[0]]["shard_bounds"]})
        slab_fps.append(fp0)
        urls_out.extend(urls)
        offset += npts
    return {"slabs": slabs, "host_urls": urls_out,
            "bounds_hosts": bounds_hosts,
            "slab_fingerprints": slab_fps, "n_points": offset}


# ------------------------------------------------------------ slab transfer


def pull_slab_rows(url: str, *, timeout_s: float = 120.0,
                   wire: str = "d16", begin: int | None = None,
                   end: int | None = None,
                   throttle_bps: float | None = None):
    """Fetch a surviving replica's host-side slab rows
    (``GET /slab_rows``). Returns ``(points f32[n, dim], row_offset)``;
    raises on a torn transfer (short body / frame, fingerprint mismatch)
    so a half-copied or corrupt slab can never be adopted.

    ``wire`` asks for the chunk-streamed codec path (``d16`` delta codec
    or chunked ``f32``); an OLD host ignores the query string and answers
    the legacy single-shot body with no ``X-Knn-Wire`` header — the
    response header, not the request, selects the parse, so mixed pods
    interop with zero config. New-style responses are verified against
    the host's crc32 fingerprint of the raw f32 bytes after decode (the
    d16 transform is lossless; this catches torn/corrupt transport).
    ``begin``/``end`` pull a row sub-range (cold-tier reads);
    ``throttle_bps`` paces the pull to a byte budget (bench use:
    emulated DCN bandwidth — decode overlaps the pacing sleep exactly
    like real transfer overlaps decode)."""
    q = [("wire", wire)] if wire in ("d16", "f32") else []
    if begin is not None:
        q.append(("begin", str(int(begin))))
    if end is not None:
        q.append(("end", str(int(end))))
    qs = ("?" + "&".join(f"{k}={v}" for k, v in q)) if q else ""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url.rstrip("/") + "/slab_rows" + qs,
                                timeout=timeout_s) as r:
        rows = int(r.headers.get("X-Knn-Rows", "-1"))
        dim = int(r.headers.get("X-Knn-Dim", "0"))
        off = int(r.headers.get("X-Knn-Row-Offset", "-1"))
        codec = r.headers.get("X-Knn-Wire")
        if codec is None:
            # legacy host: single raw f32 body (pre-codec binary)
            payload = r.read()
            if (rows < 0 or off < 0 or dim < 1
                    or len(payload) != 4 * rows * dim):
                raise ValueError(
                    f"torn slab transfer from {url}: rows={rows} "
                    f"dim={dim} bytes={len(payload)}")
            return (np.frombuffer(payload, "<f4").reshape(rows, dim)
                    .copy(), off)
        if rows < 0 or off < 0 or dim < 1:
            raise ValueError(f"torn slab transfer from {url}: "
                             f"rows={rows} dim={dim}")
        want_crc = int(r.headers.get("X-Knn-Fingerprint", "0"), 16)
        parts = []
        crc = 0
        wire_bytes = 0
        try:
            for nrows, payload in read_frames(r.read, rows):
                pts = decode_slab_chunk(payload, nrows, dim)
                parts.append(pts)
                crc = zlib.crc32(memoryview(pts).cast("B"), crc)
                wire_bytes += 8 + len(payload)
                if throttle_bps:
                    # pace AFTER decode against the cumulative byte
                    # deadline: decode rides inside the bandwidth gap,
                    # the way real transfer overlaps decode
                    target = t0 + wire_bytes / float(throttle_bps)
                    delay = target - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
        except WireError as e:
            raise ValueError(f"torn slab transfer from {url}: {e}") from e
        r.read()  # drain the terminal chunk so the close is graceful
        if crc != want_crc:
            raise ValueError(
                f"slab fingerprint mismatch from {url}: decoded rows "
                f"crc32 {crc:08x} != advertised {want_crc:08x}")
    out = (np.concatenate(parts, axis=0) if parts
           else np.zeros((0, dim), "<f4"))
    return np.ascontiguousarray(out, "<f4"), off


def _http_adopt(url: str, req: dict, timeout_s: float) -> dict:
    r = urllib.request.Request(
        url.rstrip("/") + "/adopt_slab", data=json.dumps(req).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


# ---------------------------------------------------------- handoff manager


class ReplicaManager:
    """The slab-handoff supervisor, driven from ``HealthMonitor.check_once``.

    ``check_once(now)`` is the whole brain: it first advances in-flight
    adoptions (probing the adopting standby and, once it is ready,
    scraping its /stats and holding its fingerprint against the slab's
    pod-table entry before ``fanout.bind_replica`` brings it into
    rotation), then starts a new handoff for any slab whose live-replica
    count sits below ``handoff_floor`` with no adoption in flight.
    Standbys are single-shot: a bound standby IS a replica from then on
    (supervised by the health monitor like any other), and a failed or
    rejected one stays out with the reason in ``last_error``.
    """

    def __init__(self, fanout, *, slabs: list[dict],
                 slab_fingerprints: list[dict],
                 standbys: list[str] | None = None,
                 handoff_floor: int = 1, adopt_timeout_s: float = 600.0,
                 probe_timeout_s: float = 5.0, probe_fn=None, stats_fn=None,
                 adopt_fn=None, fingerprint_registry: dict | None = None,
                 clock=time.monotonic):
        from mpi_cuda_largescaleknn_torch.serve.health import (
            _http_probe,
            _http_stats,
        )

        self.fanout = fanout
        self.slabs = [dict(s) for s in slabs]
        self.slab_fingerprints = list(slab_fingerprints)
        self.handoff_floor = int(handoff_floor)
        self.adopt_timeout_s = float(adopt_timeout_s)
        #: the monitor's url -> fingerprint table: a bound standby is
        #: registered here, so its own later drain/rejoin cycles get the
        #: same fingerprint gate as an original member
        self.fingerprint_registry = fingerprint_registry
        self._probe = probe_fn or (
            lambda url: _http_probe(url, probe_timeout_s))
        self._stats = stats_fn or (
            lambda url: _http_stats(url, probe_timeout_s))
        self._adopt = adopt_fn or (
            lambda url, req: _http_adopt(url, req, probe_timeout_s))
        self._clock = clock
        self._lock = threading.Lock()
        # standby records and handoff counters are written by the monitor
        # thread and read by /stats scrapes: all access under _lock
        self.standbys: guarded_by("_lock") = [
            {"url": u, "state": "idle", "slab": None, "last_error": None,
             "t0": None} for u in (standbys or [])]
        self.inflight: guarded_by("_lock") = set()
        self.handoffs: guarded_by("_lock") = 0
        self.handoff_failures: guarded_by("_lock") = 0
        self.handoff_rejections: guarded_by("_lock") = 0
        self.handoff_seconds_total: guarded_by("_lock") = 0.0
        self.starved: guarded_by("_lock") = 0

    # ------------------------------------------------------------------ brain

    def check_once(self, now: float | None = None) -> None:
        now = now if now is not None else self._clock()
        with self._lock:
            adopting = [dict(sb) for sb in self.standbys
                        if sb["state"] == "adopting"]
        for sb in adopting:
            self._check_adoption(sb, now)
        live = self.fanout.replicas.live_counts()
        for slab, count in enumerate(live):
            if count >= self.handoff_floor:
                continue
            with self._lock:
                if slab in self.inflight:
                    continue
                idle = next((sb for sb in self.standbys
                             if sb["state"] == "idle"), None)
                if idle is None:
                    self.starved += 1
                    continue
                idle["state"] = "adopting"
                idle["slab"] = slab
                idle["t0"] = now
                idle["last_error"] = None
                url = idle["url"]
                self.inflight.add(slab)
            self._start_handoff(url, slab)

    def _start_handoff(self, standby_url: str, slab: int) -> None:
        """Direct the standby at ``slab``: with ``source_url`` (a live
        member's) when there is one, so the standby pulls the rows from
        it; without, so it reads them again from the file."""
        src = None
        for i in self.fanout.replicas.members(slab):
            ep = self.fanout.endpoints[i]
            if not ep.health.is_drained():
                src = ep.url
                break
        meta = self.slabs[slab]
        req = {"host_id": slab, "num_hosts": len(self.slabs),
               "row_offset": meta["row_offset"],
               "n_points": meta["n_points"]}
        if src is not None:
            req["source_url"] = src
        try:
            self._adopt(standby_url, req)
        except Exception as e:  # noqa: BLE001 - recorded, handoff retried
            self._fail_standby(standby_url, slab,
                               f"adopt request failed: "
                               f"{type(e).__name__}: {e}")

    def _check_adoption(self, sb: dict, now: float) -> None:
        url, slab = sb["url"], sb["slab"]
        ok, info = self._probe(url)
        if ok:
            try:
                stats = self._stats(url)
                fp = host_fingerprint(stats.get("engine", {}), "bounds")
            except Exception as e:  # noqa: BLE001 - recorded, not swallowed
                self._fail_standby(url, slab,
                                   f"adopted-slab stats scrape failed: "
                                   f"{type(e).__name__}: {e}")
                return
            want = self.slab_fingerprints[slab]
            if want is not None and fp != want:
                diff = sorted(k for k in want if fp.get(k) != want.get(k))
                self._fail_standby(
                    url, slab,
                    f"handoff rejected: fingerprint mismatch on {diff} — "
                    "the adopted slab does not serve the rows/config the "
                    "pod table was built from", rejected=True)
                return
            self.fanout.bind_replica(slab, url)
            # register the adoptee's wire caps (the /stats ROOT block) so
            # the fan-out negotiates its codec like any host at startup; a
            # host without caps negotiates f32
            negotiator = getattr(self.fanout, "negotiator", None)
            if negotiator is not None:
                negotiator.set_caps(url, stats.get("wire"))
            if self.fingerprint_registry is not None:
                self.fingerprint_registry[url] = (want if want is not None
                                                  else fp)
            with self._lock:
                for x in self.standbys:
                    if x["url"] == url:
                        x["state"] = "bound"
                self.inflight.discard(slab)
                self.handoffs += 1
                if sb["t0"] is not None:
                    self.handoff_seconds_total += max(0.0, now - sb["t0"])
            return
        if info.get("status") == "adopt-failed":
            self._fail_standby(url, slab,
                               info.get("adopt_error") or "adoption failed")
        elif sb["t0"] is not None and now - sb["t0"] > self.adopt_timeout_s:
            self._fail_standby(url, slab,
                               f"adoption timed out after "
                               f"{self.adopt_timeout_s:.0f}s")
        # else: still materializing or warming — check again next cycle

    def _fail_standby(self, url: str, slab: int, msg: str,
                      rejected: bool = False) -> None:
        with self._lock:
            for x in self.standbys:
                if x["url"] == url:
                    x["state"] = "failed"
                    x["last_error"] = msg
            self.inflight.discard(slab)
            if rejected:
                self.handoff_rejections += 1
            else:
                self.handoff_failures += 1

    def stats(self) -> dict:
        live = self.fanout.replicas.live_counts()
        with self._lock:
            return {
                "handoff_floor": self.handoff_floor,
                "slab_live": list(live),
                "standbys": [dict(sb) for sb in self.standbys],
                "inflight_slabs": sorted(self.inflight),
                "handoffs": self.handoffs,
                "handoff_failures": self.handoff_failures,
                "handoff_rejections": self.handoff_rejections,
                "handoff_seconds_total": round(self.handoff_seconds_total,
                                               3),
                "starved": self.starved,
            }
