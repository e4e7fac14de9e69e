"""The port's host lifecycle (``serve/health.py``) against the JAX
package's: the same event sequence on a fake clock gives the same
``HostHealth`` states, ``Backoff`` delays and ``snapshot()`` in both, and
``HealthMonitor.check_once`` (injected probe and stats transports, a fake
``now``) drains and rejoins the same hosts, a host only on a matching
fingerprint."""

from __future__ import annotations

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.serve import health as th
from mpi_cuda_largescaleknn_tpu.serve import health as jh


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("cfg", [
    dict(), dict(base_s=0.05, cap_s=2.0, jitter=0.1, seed=0),
    dict(base_s=0.5, cap_s=30.0, factor=3.0, jitter=0.0, seed=7),
    dict(base_s=1.0, cap_s=4.0, factor=2.0, jitter=0.5, seed=123)])
def test_backoff_delays_equal_jax(cfg):
    a, b = th.Backoff(**cfg), jh.Backoff(**cfg)
    for key in ("", "http://127.0.0.1:9000", "host-b"):
        for attempt in range(0, 12):
            assert a.delay(attempt, key) == b.delay(attempt, key)


EVENTS = ("success", "failure", "force_drain", "rejoining", "rejoined",
          "rejoin_failed", "probe", "tick")


def _apply(h, clock, ev, arg):
    if ev == "success":
        h.note_success()
    elif ev == "failure":
        h.note_failure(f"err {arg}")
    elif ev == "force_drain":
        h.force_drain(f"drain {arg}")
    elif ev == "rejoining":
        h.mark_rejoining()
    elif ev == "rejoined":
        h.mark_rejoined()
    elif ev == "rejoin_failed":
        h.rejoin_failed(f"bad {arg}")
    elif ev == "probe":
        return h.schedule_next_probe(key=f"u{arg % 3}")
    else:
        clock.t += arg / 7.0
    return None


@pytest.mark.parametrize("seed", range(6))
def test_host_health_sequences_equal_jax(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(fail_threshold=int(rng.integers(1, 4)),
               probe_interval_s=float(rng.integers(1, 6)),
               backoff_base_s=0.25, backoff_cap_s=8.0, jitter=0.1,
               seed=int(seed))
    clocks = (_Clock(), _Clock())
    hs = (th.HostHealth(clock=clocks[0], **cfg),
          jh.HostHealth(clock=clocks[1], **cfg))
    for _ in range(120):
        ev = EVENTS[int(rng.integers(len(EVENTS)))]
        arg = int(rng.integers(1, 20))
        out = [_apply(h, c, ev, arg) for h, c in zip(hs, clocks)]
        assert out[0] == out[1]
        assert hs[0].snapshot() == hs[1].snapshot()
        assert hs[0].is_drained() == hs[1].is_drained()
        assert hs[0].drained_seconds() == hs[1].drained_seconds()
        assert hs[0].probe_due() == hs[1].probe_due()
    assert th.STATE_CODE == jh.STATE_CODE


def test_host_fingerprint_equal_jax():
    stats = {"k": 5, "dim": 3, "max_batch": 32, "score_dtype": "f32",
             "max_radius": None, "row_offset": 300, "n_points": 300,
             "emit": "candidates", "bucket_size": 64,
             "shape_buckets": [16, 32], "canonical_ties": True,
             "shard_bounds": [{"lo": [0, 0, 0], "hi": [1, 1, 1],
                               "count": 300}],
             "merge": "device", "num_shards": 2, "engine": "tiled",
             "extra": 1}
    for mode in ("bounds", "off"):
        assert th.host_fingerprint(stats, mode) \
            == jh.host_fingerprint(stats, mode)
    assert th.ROUTED_FINGERPRINT_KEYS == jh.ROUTED_FINGERPRINT_KEYS
    assert th.POD_FINGERPRINT_KEYS == jh.POD_FINGERPRINT_KEYS


class _Ep:
    def __init__(self, mod, url, clock):
        self.url = url
        self.health = mod.HostHealth(fail_threshold=2, probe_interval_s=1.0,
                                     backoff_base_s=0.5, backoff_cap_s=4.0,
                                     clock=clock)


class _Fanout:
    def __init__(self, mod, urls, clock):
        self.endpoints = [_Ep(mod, u, clock) for u in urls]


FP = {"k": 5, "dim": 3, "row_offset": 0, "n_points": 300,
      "emit": "candidates"}


def _monitor(mod, script, clock):
    """A two-host monitor whose probes and stats follow ``script``:
    ``script[url]`` is a list of (probe ok, fingerprint offset)."""
    urls = ["http://h0:1", "http://h1:2"]
    fan = _Fanout(mod, urls, clock)
    fps = {u: mod.host_fingerprint(dict(FP, row_offset=300 * i), "bounds")
           for i, u in enumerate(urls)}
    calls = {u: 0 for u in urls}

    def probe(url):
        ok, _ = script[url][min(calls[url], len(script[url]) - 1)]
        calls[url] += 1
        return ok, ({} if ok else {"error": "down"})

    def stats(url):
        _, off = script[url][min(calls[url] - 1, len(script[url]) - 1)]
        i = urls.index(url)
        return {"engine": dict(FP, row_offset=300 * i + off)}

    mon = mod.HealthMonitor(fan, fingerprints=fps, mode="bounds",
                            probe_fn=probe, stats_fn=stats, clock=clock)
    return fan, mon


@pytest.mark.parametrize("drill", ["rejoin_on_match", "reject_mismatch"])
def test_monitor_check_once_equal_jax(drill):
    """Host 1 fails its probes until drained, then answers again: with
    its own fingerprint it rejoins; with a shifted ``row_offset`` (another
    slab) it stays out, in both packages, state for state."""
    off = 0 if drill == "rejoin_on_match" else 7
    script = {"http://h0:1": [(True, 0)],
              "http://h1:2": [(False, 0)] * 3 + [(True, off)] * 6}
    runs = []
    for mod in (th, jh):
        clock = _Clock()
        fan, mon = _monitor(mod, script, clock)
        trace = []
        for step in range(12):
            mon.check_once(now=clock.t)
            trace.append([ep.health.snapshot() for ep in fan.endpoints])
            clock.t += 5.0
        st = mon.stats()
        st.pop("running")
        runs.append((trace, st))
    assert runs[0] == runs[1]
    final = runs[0][0][-1][1]["state"]
    if drill == "rejoin_on_match":
        assert final == "healthy" and runs[0][1]["rejoins"] == 1
    else:
        assert final == "drained" and runs[0][1]["rejoins"] == 0
        assert runs[0][1]["rejoin_rejections"] >= 1
