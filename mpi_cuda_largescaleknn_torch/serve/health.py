"""Health-driven host lifecycle: healthy -> suspect -> drained -> rejoining.

The port of the JAX package's ``serve/health.py``. The hosts of a routed
pod are independent slab engines, so host loss is a *partial* event: this
module supplies the supervision that turns "a host died" into a state
transition the fan-out routes around:

- ``HostHealth`` is the per-host state machine. Dispatch failures and probe
  failures feed ``note_failure`` (``fail_threshold`` consecutive failures
  drain the host); successes reset to healthy. All timing runs through an
  injectable monotonic ``clock`` so tests drive transitions without sleeps.
- ``Backoff`` is capped exponential delay with DETERMINISTIC jitter: the
  jitter fraction is a hash of (seed, key, attempt), not a shared RNG, so
  concurrent callers cannot perturb each other's schedules and a test can
  predict every delay exactly.
- ``HealthMonitor`` is the background supervisor: it probes each endpoint's
  ``/healthz`` when due (healthy hosts at ``probe_interval_s``; drained
  hosts on the capped-exponential backoff schedule), and drives REJOIN:
  a drained host that answers its probe moves to ``rejoining``, its
  ``/stats`` is scraped and its config/bounds fingerprint compared against
  the pod table captured at front-end startup — only a bitwise-matching
  fingerprint undrains it (a restarted host serving different rows or a
  different k would silently corrupt the fold). Replicate-mode (routing
  off) pods are one SPMD machine, so rejoin there is pod-wide: when the
  pod is broken and EVERY host probes healthy with matching fingerprints
  and a consistent ``next_seq``, the monitor resets the fan-out's sequence
  stream (drain-then-fail with a clean restart path, instead of the old
  restart-everything-and-the-frontend-too wedge).

The monitor's probe/scrape transports are injectable (``probe_fn`` /
``stats_fn``) so the state machine is unit-testable without HTTP; the
defaults use urllib against the real endpoints.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import zlib

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by

STATES = ("healthy", "suspect", "drained", "rejoining")
STATE_CODE = {s: i for i, s in enumerate(STATES)}

#: engine-stats keys that must survive a host restart unchanged for the
#: host to rejoin a ROUTED pod: the result contract (k/dim/radius/score),
#: the slab identity (row_offset/n_points), and the routing bounds the
#: front end's table was built from — a mismatch means the front end's
#: routing decisions no longer describe the host's data.
ROUTED_FINGERPRINT_KEYS = (
    "k", "dim", "max_batch", "score_dtype", "max_radius", "row_offset",
    "n_points", "emit", "bucket_size", "shape_buckets", "canonical_ties",
    "shard_bounds",
)

#: replicate-mode pods additionally pin the launch-plan identity — every
#: host must re-enter the SAME collective program after a restart.
POD_FINGERPRINT_KEYS = ROUTED_FINGERPRINT_KEYS + (
    "merge", "num_shards", "engine", "query_buckets", "sort_queries",
    "process_count", "my_positions",
)


def host_fingerprint(engine_stats: dict, mode: str) -> dict:
    """Canonical identity of a host's serving config + bounds, from its
    /stats ``engine`` block. Both sides of every comparison come through
    the same JSON round trip, so plain ``==`` is exact."""
    keys = (POD_FINGERPRINT_KEYS if mode == "off"
            else ROUTED_FINGERPRINT_KEYS)
    return {k: engine_stats.get(k) for k in keys}


class Backoff:
    """Capped exponential backoff with deterministic jitter.

    ``delay(attempt, key)`` for attempt 1, 2, ... is
    ``min(cap, base * factor**(attempt-1)) * (1 + jitter * u)`` where
    ``u in [0, 1)`` is a hash of (seed, key, attempt) — stateless, so
    concurrent users can't skew each other and tests can predict delays.
    """

    def __init__(self, base_s: float = 0.5, cap_s: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.1, seed: int = 0):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delay(self, attempt: int, key: str = "") -> float:
        d = min(self.cap_s,
                self.base_s * self.factor ** max(0, int(attempt) - 1))
        if self.jitter:
            u = zlib.crc32(f"{self.seed}:{key}:{attempt}".encode()) / 2 ** 32
            d *= 1.0 + self.jitter * u
        return d


class HostHealth:
    """Per-host lifecycle state machine (thread-safe; injectable clock).

    Fed from two directions: the fan-out's dispatch path reports
    per-request outcomes (``note_success`` / ``note_failure``) and the
    monitor reports probe outcomes through the same calls — both sides see
    the same truth. Draining happens HERE (``fail_threshold`` consecutive
    failures); undraining only happens through ``mark_rejoined`` because it
    requires the monitor's fingerprint validation.
    """

    def __init__(self, *, fail_threshold: int = 3,
                 probe_interval_s: float = 5.0,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 jitter: float = 0.1, seed: int = 0,
                 clock=time.monotonic):
        self.fail_threshold = int(fail_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.backoff = Backoff(backoff_base_s, backoff_cap_s,
                               jitter=jitter, seed=seed)
        self._clock = clock
        self._lock = threading.Lock()
        # lifecycle state fed from BOTH the dispatch path and the monitor
        # thread: every access goes through _lock;
        # external readers use snapshot()/is_drained()/drained_seconds()
        self.state: guarded_by("_lock") = "healthy"
        self.consecutive_failures: guarded_by("_lock") = 0
        self.last_error: guarded_by("_lock") = None
        self.last_probe_at: guarded_by("_lock") = None
        self.next_probe_at: guarded_by("_lock") = 0.0  # due immediately
        #: drained-probe counter (backoff exponent)
        self.probe_attempt: guarded_by("_lock") = 0
        self.drained_at: guarded_by("_lock") = None
        self._drained_seconds: guarded_by("_lock") = 0.0
        self.transitions: guarded_by("_lock") = 0

    # ------------------------------------------------------------ transitions

    def _enter(self, state: str) -> None:  # holds _lock
        if state == self.state:
            return
        now = self._clock()
        if self.state == "drained" and state not in ("drained", "rejoining"):
            if self.drained_at is not None:
                self._drained_seconds += now - self.drained_at
                self.drained_at = None
        if state == "drained" and self.drained_at is None:
            self.drained_at = now
            self.probe_attempt = 0
        self.state = state
        self.transitions += 1

    def note_success(self) -> None:
        """A request or probe succeeded."""
        with self._lock:
            if self.state in ("healthy", "suspect"):
                self._enter("healthy")
                self.consecutive_failures = 0

    def note_failure(self, err: str) -> None:
        """A request or probe failed; drains at ``fail_threshold``."""
        with self._lock:
            self.last_error = str(err)
            if self.state in ("healthy", "suspect"):
                self.consecutive_failures += 1
                if self.consecutive_failures >= self.fail_threshold:
                    self._enter("drained")
                else:
                    self._enter("suspect")
            elif self.state == "rejoining":
                self._enter("drained")

    def force_drain(self, err: str) -> None:
        """Drain immediately (replicate-mode pods: one failure IS fatal)."""
        with self._lock:
            self.last_error = str(err)
            self.consecutive_failures = max(self.consecutive_failures,
                                            self.fail_threshold)
            self._enter("drained")

    def mark_rejoining(self) -> None:
        with self._lock:
            if self.state == "drained":
                self._enter("rejoining")

    def mark_rejoined(self) -> None:
        """Fingerprint validated: the host is healthy again."""
        with self._lock:
            # a rejoining host's drained spell ends where the drain began
            if self.drained_at is not None:
                self._drained_seconds += self._clock() - self.drained_at
                self.drained_at = None
            self._enter("healthy")
            self.consecutive_failures = 0
            self.probe_attempt = 0

    def rejoin_failed(self, err: str) -> None:
        with self._lock:
            self.last_error = str(err)
            self._enter("drained")

    # ------------------------------------------------------------- scheduling

    def probe_due(self, now: float | None = None) -> bool:
        with self._lock:
            return (now if now is not None
                    else self._clock()) >= self.next_probe_at

    def schedule_next_probe(self, key: str = "",
                            now: float | None = None) -> float:
        """Set + return the next probe time: steady interval while
        healthy/suspect, capped-exponential backoff while drained."""
        with self._lock:
            now = now if now is not None else self._clock()
            self.last_probe_at = now
            if self.state in ("drained", "rejoining"):
                self.probe_attempt += 1
                delay = self.backoff.delay(self.probe_attempt, key)
            else:
                delay = self.probe_interval_s
            self.next_probe_at = now + delay
            return self.next_probe_at

    # ------------------------------------------------------------------ admin

    def is_drained(self) -> bool:
        with self._lock:
            return self.state in ("drained", "rejoining")

    def drained_seconds(self) -> float:
        with self._lock:
            live = ((self._clock() - self.drained_at)
                    if self.drained_at is not None else 0.0)
            return self._drained_seconds + live

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            # the NEXT drained-probe delay (jitter excluded — the per-host
            # jitter key is the fan-out's url, which this state machine
            # does not know): 0.0 while healthy/suspect. A successful
            # rejoin resets probe_attempt, so a later flap reads the BASE
            # interval here again, never the cap (tests/test_failover.py
            # pins that reset).
            backoff_now = (
                round(min(self.backoff.cap_s,
                          self.backoff.base_s
                          * self.backoff.factor ** self.probe_attempt), 3)
                if self.state in ("drained", "rejoining") else 0.0)
            return {
                "state": self.state,
                "state_code": STATE_CODE[self.state],
                "consecutive_failures": self.consecutive_failures,
                "fail_threshold": self.fail_threshold,
                "backoff_current_s": backoff_now,
                "last_error": self.last_error,
                "last_probe_age_s": (round(now - self.last_probe_at, 3)
                                     if self.last_probe_at is not None
                                     else None),
                "drained_seconds_total": round(
                    self._drained_seconds
                    + ((now - self.drained_at)
                       if self.drained_at is not None else 0.0), 3),
                "transitions": self.transitions,
            }


# ------------------------------------------------------------------ monitor


def _http_probe(url: str, timeout_s: float):
    """GET /healthz -> (ok, info dict). Down IS an answer, never a raise."""
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                    timeout=timeout_s) as r:
            return r.status == 200, json.loads(r.read().decode())
    except Exception as e:  # noqa: BLE001 - any transport failure = down
        return False, {"error": f"{type(e).__name__}: {e}"}


def _http_stats(url: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(url.rstrip("/") + "/stats",
                                timeout=timeout_s) as r:
        return json.loads(r.read().decode())


class HealthMonitor:
    """Background supervisor driving every endpoint's HostHealth.

    ``check_once(now)`` is the whole brain — the thread just calls it on a
    poll loop; tests call it directly with a fake ``now`` and injected
    ``probe_fn`` / ``stats_fn`` transports, so no test ever sleeps.
    """

    def __init__(self, fanout, *, fingerprints: dict | None = None,
                 mode: str = "bounds", probe_timeout_s: float = 2.0,
                 probe_fn=None, stats_fn=None, clock=time.monotonic,
                 poll_s: float = 0.25):
        self.fanout = fanout
        self.fingerprints = dict(fingerprints or {})
        self.mode = mode
        self.probe_timeout_s = float(probe_timeout_s)
        self._probe = probe_fn or (
            lambda url: _http_probe(url, self.probe_timeout_s))
        self._stats = stats_fn or (
            lambda url: _http_stats(url, self.probe_timeout_s))
        self._clock = clock
        self.poll_s = float(poll_s)
        #: slab-handoff supervisor (serve/replica.py ReplicaManager),
        #: attached by build_frontend on routed pods BEFORE start();
        #: driven from check_once so handoffs ride the same cadence (and
        #: the same fake-now test harness) as drain/rejoin
        self.replica_manager = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # monitor counters are read by /stats scrapes while check_once
        # runs on the monitor thread
        self.probes: guarded_by("_lock") = 0
        self.rejoins: guarded_by("_lock") = 0
        self.rejoin_rejections: guarded_by("_lock") = 0
        self.stream_resets: guarded_by("_lock") = 0
        #: bounded transition log (stats/debug)
        self.events: guarded_by("_lock") = []

    # ----------------------------------------------------------------- driver

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="knn-health-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception as e:  # noqa: BLE001 - supervisor must survive
                self._event(f"monitor error: {type(e).__name__}: {e}")

    def _event(self, msg: str) -> None:
        with self._lock:
            self.events.append(msg)
            del self.events[:-50]

    # ------------------------------------------------------------------ brain

    def check_once(self, now: float | None = None) -> None:
        """Probe every endpoint that is due; drive drain/rejoin."""
        now = now if now is not None else self._clock()
        probe_ok: dict[str, tuple[bool, dict]] = {}
        for ep in self.fanout.endpoints:
            h = ep.health
            if not h.probe_due(now):
                continue
            ok, info = self._probe(ep.url)
            with self._lock:
                self.probes += 1
            probe_ok[ep.url] = (ok, info)
            was = h.state
            if h.state in ("healthy", "suspect"):
                if ok:
                    h.note_success()
                else:
                    h.note_failure(info.get("error", "healthz not ok"))
            else:  # drained / rejoining
                if ok:
                    h.mark_rejoining()
                    if (self.mode == "off"
                            and self._fanout_broken() is not None):
                        # the broken replicate stream rejoins pod-wide
                        # (below); the host stays rejoining until the
                        # whole pod resets
                        pass
                    else:
                        # routed hosts — and replicate hosts drained by
                        # probe blips while the stream never broke —
                        # rejoin individually on a fingerprint match
                        self._try_rejoin(ep)
                else:
                    h.rejoin_failed(info.get("error", "healthz not ok"))
            if h.state != was:
                self._event(f"{ep.url}: {was} -> {h.state}")
            h.schedule_next_probe(key=ep.url, now=now)
        if self.mode == "off":
            self._try_pod_reset(probe_ok)
        rm = self.replica_manager
        if rm is not None:
            try:
                rm.check_once(now)
            except Exception as e:  # noqa: BLE001 - supervisor must survive
                self._event(f"handoff error: {type(e).__name__}: {e}")

    def _fanout_broken(self) -> str | None:
        """The fan-out's broken marker through its LOCKED accessor —
        ``broken`` is guarded_by the fan-out's lock, and the monitor
        thread is exactly the kind of cross-thread reader the guard
        exists for (plain fakes in tests may lack the accessor)."""
        fn = getattr(self.fanout, "broken_reason", None)
        return fn() if fn is not None else getattr(self.fanout, "broken",
                                                   None)

    def _try_rejoin(self, ep) -> bool:
        """Routed-mode rejoin: revalidate the host's config/bounds
        fingerprint against the pod table before undraining."""
        try:
            stats = self._stats(ep.url)
            fp = host_fingerprint(stats.get("engine", {}), self.mode)
        except Exception as e:  # noqa: BLE001 - scrape failure = not yet
            ep.health.rejoin_failed(f"rejoin stats scrape failed: "
                                    f"{type(e).__name__}: {e}")
            return False
        want = self.fingerprints.get(ep.url)
        if want is not None and fp != want:
            diff = sorted(k for k in want if fp.get(k) != want.get(k))
            ep.health.rejoin_failed(
                f"rejoin rejected: fingerprint mismatch on {diff} — the "
                "returning host does not serve the slab/config the pod "
                "table was built from")
            with self._lock:
                self.rejoin_rejections += 1
            self._event(f"{ep.url}: rejoin rejected ({diff})")
            return False
        ep.health.mark_rejoined()
        with self._lock:
            self.rejoins += 1
        self._event(f"{ep.url}: rejoined")
        return True

    def _try_pod_reset(self, probe_ok: dict) -> None:
        """Replicate-mode recovery: the pod is one SPMD machine, so rejoin
        is all-or-nothing — when the stream is broken and every host
        answers healthy with a matching fingerprint and ONE consistent
        ``next_seq``, reset the fan-out's sequence stream and undrain
        everyone (the clean-restart path). Paced by the main loop's probe
        schedule: a reset is only attempted when at least one endpoint
        was actually due for a probe this cycle, so a long outage costs
        the drained hosts' capped-exponential cadence, not one full pod
        probe + stats scrape per poll tick."""
        if self._fanout_broken() is None or not probe_ok:
            return
        seqs = []
        for ep in self.fanout.endpoints:
            # reuse this cycle's probe result where one exists
            ok, info = probe_ok.get(ep.url) or self._probe(ep.url)
            if not ok:
                return
            try:
                stats = self._stats(ep.url)
                fp = host_fingerprint(stats.get("engine", {}), "off")
            except Exception:  # noqa: BLE001 - not yet
                return
            want = self.fingerprints.get(ep.url)
            if want is not None and fp != want:
                ep.health.rejoin_failed(
                    "pod reset rejected: fingerprint mismatch")
                with self._lock:
                    self.rejoin_rejections += 1
                return
            seqs.append(int(info.get("next_seq", -1)))
        if len(set(seqs)) != 1 or seqs[0] < 0:
            self._event(f"pod reset blocked: next_seq disagree {seqs}")
            return
        self.fanout.reset_stream(seqs[0])
        for ep in self.fanout.endpoints:
            if ep.health.state != "healthy":
                ep.health.mark_rejoined()
        with self._lock:
            self.stream_resets += 1
        self._event(f"pod stream reset to seq {seqs[0]}")

    def stats(self) -> dict:
        rm = self.replica_manager
        handoff = rm.stats() if rm is not None else None
        with self._lock:
            return {"probes": self.probes, "rejoins": self.rejoins,
                    "rejoin_rejections": self.rejoin_rejections,
                    "stream_resets": self.stream_resets,
                    "running": self.running,
                    "handoff": handoff,
                    "events": list(self.events[-10:])}
