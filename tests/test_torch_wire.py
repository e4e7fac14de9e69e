"""The port's wire codecs (``serve/wire.py``) against the JAX package's,
byte for byte: q16 candidate bodies and d16 slab chunks for seeded inputs
(NaN, inf and -0.0 values, pad slots, under-full rows, a non-Morton
slab), each side decoding the other's bytes to the same arrays, torn
bodies raising ``WireError`` in both, the negotiation tables, the
``WireStats`` Prometheus lines, and a routed host's ``/route_knn`` and
``/slab_rows`` bodies against a JAX host's over the same points."""

from __future__ import annotations

import threading
import urllib.request

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.serve import wire as tw
from mpi_cuda_largescaleknn_tpu.serve import wire as jw

K = 4


def _rows(m, k, seed=0, n_valid=None, pad=np.inf, scale=4.0):
    """Ascending candidate rows like an engine partial: ids a valid
    prefix, pads a uniform suffix."""
    rng = np.random.default_rng(seed)
    d2 = np.sort(rng.random((m, k)).astype("<f4") * np.float32(scale),
                 axis=1)
    idx = rng.integers(0, 10_000, (m, k)).astype("<i4")
    if n_valid is not None:
        for i, nv in enumerate(n_valid):
            d2[i, nv:] = np.float32(pad)
            idx[i, nv:] = -1
    return d2, idx


def _clustered_rows(m, k, seed):
    """Neighbor ids that cluster (Morton-sorted index) and close d2."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 20, m)
    idx = (base[:, None] + np.sort(rng.integers(0, 64, (m, k)), axis=1)
           ).astype("<i4")
    d2 = np.sort(rng.random((m, k)).astype("<f4") * np.float32(1e-3),
                 axis=1)
    return d2, idx


def _q16_cases():
    d2z, idxz = _rows(16, K, seed=5)
    d2z[:, :2] = 0.0
    d2n, idxn = _rows(8, K, seed=6)
    d2n[:, 0] = -0.0
    return {
        "full": _rows(64, K, seed=1),
        "k1": _rows(32, 1, seed=2),
        "under_full_inf_pads": _rows(8, K, seed=3,
                                     n_valid=[4, 3, 2, 1, 0, 4, 1, 0]),
        "radius_pads": _rows(6, K, seed=4, n_valid=[4, 2, 0, 1, 3, 4],
                             pad=0.25 ** 2),
        "zero_distance_slots": (d2z, idxz),
        "negative_zero": (d2n, idxn),
        "clustered_k100": _clustered_rows(40, 100, seed=7),
        "empty_batch": (np.zeros((0, K), "<f4"), np.zeros((0, K), "<i4")),
        "all_rows_empty": _rows(5, K, seed=8, n_valid=[0] * 5),
    }


Q16 = _q16_cases()


@pytest.mark.parametrize("case", sorted(Q16))
def test_q16_bodies_equal_jax(case):
    d2, idx = Q16[case]
    got = tw.encode_candidates_q16(d2, idx)
    want = jw.encode_candidates_q16(d2, idx)
    assert got == want
    assert got is not None
    m, k = d2.shape
    for body in (got, want):
        a = tw.decode_candidates_q16(body, m, k)
        b = jw.decode_candidates_q16(body, m, k)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _refused():
    d2, idx = _rows(4, K, seed=9)
    nan = d2.copy()
    nan[1, 2] = np.nan
    gap = idx.copy()
    gap[0, 1] = -1  # a pad before a valid slot
    mixed = _rows(4, K, seed=10, n_valid=[2, 2, 4, 4])[0]
    mixed[1, 3] = np.float32(7.0)  # pads of two values
    wide = _rows(2, 256, seed=11)
    return {"nan": (nan, idx), "non_prefix_pads": (d2, gap),
            "non_uniform_pad": (mixed, _rows(4, K, seed=10,
                                             n_valid=[2, 2, 4, 4])[1]),
            "k_over_255": wide}


REFUSED = _refused()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_q16_refusals_equal_jax(case):
    d2, idx = REFUSED[case]
    assert tw.encode_candidates_q16(d2, idx) is None
    assert jw.encode_candidates_q16(d2, idx) is None


def _slab_cases():
    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    rng = np.random.default_rng(20)
    pts = rng.random((700, 3)).astype("<f4")
    morton = np.ascontiguousarray(
        pts[morton_argsort(pts, pts.min(0), pts.max(0))], "<f4")
    special = rng.normal(size=(64, 3)).astype("<f4")
    special[3] = [np.nan, np.inf, -np.inf]
    special[7] = [-0.0, 0.0, -0.0]
    special[9] = [np.float32(3e38), np.float32(-3e38), np.float32(1e-45)]
    crossing = np.stack([np.linspace(-5, 5, 300)] * 3, 1).astype("<f4")
    return {"morton": morton, "not_morton": pts, "one_row": pts[:1],
            "empty": np.zeros((0, 3), "<f4"),
            "nan_inf_negzero": special, "sign_crossing": crossing,
            "d128": rng.normal(size=(50, 128)).astype("<f4")}


SLABS = _slab_cases()


@pytest.mark.parametrize("case", sorted(SLABS))
def test_d16_chunks_equal_jax(case):
    pts = SLABS[case]
    got = tw.encode_slab_chunk(pts)
    assert got == jw.encode_slab_chunk(pts)
    n, dim = pts.shape
    a = tw.decode_slab_chunk(got, n, dim)
    b = jw.decode_slab_chunk(got, n, dim)
    assert a.tobytes() == b.tobytes() == np.ascontiguousarray(
        pts, "<f4").tobytes()
    assert tw.frame_chunk(n, got) == jw.frame_chunk(n, got)


def _torn():
    d2, idx = _rows(16, K, seed=12)
    q = jw.encode_candidates_q16(d2, idx)
    s = jw.encode_slab_chunk(SLABS["morton"])
    return {"q16_truncated": ("q", q[:-3], (16, K)),
            "q16_garbage": ("q", b"\x07" * 40, (16, K)),
            "q16_shape": ("q", q, (15, K)),
            "d16_truncated": ("s", s[:-5], (700, 3)),
            "d16_bad_mode": ("s", b"\x09" + s[1:], (700, 3)),
            "d16_rows": ("s", s, (699, 3))}


TORN = _torn()


@pytest.mark.parametrize("case", sorted(TORN))
def test_torn_bodies_raise_in_both(case):
    kind, body, shape = TORN[case]
    for mod in (tw, jw):
        dec = (mod.decode_candidates_q16 if kind == "q"
               else mod.decode_slab_chunk)
        with pytest.raises(mod.WireError):
            dec(body, *shape)


def _reader(buf):
    pos = [0]

    def read(n):
        got = buf[pos[0]:pos[0] + n]
        pos[0] += len(got)
        return got

    return read


def test_frames_read_alike_and_torn_streams_raise():
    pts = SLABS["morton"]
    stream = b"".join(jw.frame_chunk(len(c), jw.encode_slab_chunk(c))
                      for c in (pts[:300], pts[300:600], pts[600:]))
    got = [(n, p) for n, p in tw.read_frames(_reader(stream), len(pts))]
    want = [(n, p) for n, p in jw.read_frames(_reader(stream), len(pts))]
    assert got == want and [n for n, _ in got] == [300, 300, 100]
    for mod in (tw, jw):
        with pytest.raises(mod.WireError):
            list(mod.read_frames(_reader(stream[:-7]), len(pts)))
        with pytest.raises(mod.WireError):
            list(mod.read_frames(_reader(stream), len(pts) - 1))


def test_negotiation_tables_equal_jax():
    for mode in ("auto", "f32"):
        assert tw.wire_caps(mode) == jw.wire_caps(mode)
    caps = [None, {}, jw.wire_caps(), jw.wire_caps("f32"),
            {"candidates": ["q16"], "slab_rows": []}]
    for mode in ("auto", "f32", "q16", "d16"):
        for c in caps:
            for path in ("candidates", "slab_rows"):
                assert tw.negotiate(mode, c, path) \
                    == jw.negotiate(mode, c, path)
    for mode in ("auto", "f32", "q16"):
        negs = [mod.WireNegotiator(mode) for mod in (tw, jw)]
        for neg in negs:
            neg.set_caps("http://a:1/", jw.wire_caps())
            neg.set_caps("http://b:2", None)
            neg.set_caps("http://c:3", jw.wire_caps("f32"))
        assert negs[0].snapshot() == negs[1].snapshot()
        for url in ("http://a:1", "http://b:2/", "http://c:3", "http://d:4"):
            for path in ("candidates", "slab_rows"):
                assert negs[0].codec_for(url, path) \
                    == negs[1].codec_for(url, path)
    with pytest.raises(ValueError, match="wire mode"):
        tw.WireNegotiator("brotli")


def test_wire_stats_lines_equal_jax():
    stats = [mod.WireStats() for mod in (tw, jw)]
    for st in stats:
        st.add("candidates", "q16", 100, 10)
        st.add("candidates", "f32", 640, 10)
        st.add("candidates", "q16", 51, 7)
        st.add("slab_rows", "d16", 999)
        st.add("slab_rows", "f32", 1200, 100)
    assert stats[0].snapshot() == stats[1].snapshot()
    assert stats[0].prometheus_lines() == stats[1].prometheus_lines()
    assert tw.WireStats().prometheus_lines() == []


# ------------------------------------------------ a routed host on the wire


def _boot(mod, engine, **kw):
    srv = mod.HostSliceServer(("127.0.0.1", 0), engine, routing="bounds",
                              **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv.ready = True
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def wire_hosts():
    """One slab of 256 Morton-sorted points at row offset 256 behind a port
    host (``device="cpu"``) and a JAX host (engine ``tiled``), each with
    ``wire="auto"`` and ``wire="f32"``."""
    from mpi_cuda_largescaleknn_torch.serve import frontend as tf
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        ResidentKnnEngine as TEngine,
    )
    from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
    from mpi_cuda_largescaleknn_tpu.serve import frontend as jf
    from mpi_cuda_largescaleknn_tpu.serve.engine import (
        ResidentKnnEngine as JEngine,
    )

    pts = SLABS["morton"][:256]
    kw = dict(bucket_size=32, max_batch=32, min_batch=8, id_offset=256,
              emit="candidates")
    teng = TEngine(pts, K, num_shards=2, device="cpu", **kw)
    jeng = JEngine(pts, K, mesh=get_mesh(2), engine="tiled", **kw)
    teng.warmup()
    jeng.warmup()
    servers, urls = [], {}
    for name, mod, eng in (("torch", tf, teng), ("jax", jf, jeng)):
        for mode in ("auto", "f32"):
            srv, url = _boot(mod, eng, wire=mode)
            servers.append(srv)
            urls[name, mode] = url
    yield pts, urls
    for srv in servers:
        srv.close()


def _post_route(url, q, wire=None):
    qs = f"?wire={wire}" if wire else ""
    req = urllib.request.Request(
        url + "/route_knn" + qs,
        data=np.ascontiguousarray(q, "<f4").tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers.get("X-Knn-Wire"), r.read()


@pytest.mark.parametrize("host_mode", ["auto", "f32"])
@pytest.mark.parametrize("wire", [None, "q16", "x32"])
def test_route_bodies_equal_jax_host(wire_hosts, host_mode, wire):
    pts, urls = wire_hosts
    rng = np.random.default_rng(50)
    q = (pts[rng.integers(0, len(pts), 12)]
         + rng.normal(scale=1e-3, size=(12, 3)).astype(np.float32))
    got = _post_route(urls["torch", host_mode], q, wire)
    want = _post_route(urls["jax", host_mode], q, wire)
    assert got == want


@pytest.mark.parametrize("wire", ["d16", "f32", "none"])
def test_slab_pulls_equal_jax_host(wire_hosts, wire):
    from mpi_cuda_largescaleknn_torch.serve.replica import pull_slab_rows
    from mpi_cuda_largescaleknn_tpu.serve.replica import (
        pull_slab_rows as jax_pull,
    )

    pts, urls = wire_hosts
    for begin, end in ((None, None), (10, 200)):
        got, off = pull_slab_rows(urls["torch", "auto"], wire=wire,
                                  begin=begin, end=end)
        want, joff = jax_pull(urls["jax", "auto"], wire=wire, begin=begin,
                              end=end)
        assert off == joff
        assert got.tobytes() == want.tobytes()
        sel = pts if begin is None or wire == "none" else pts[begin:end]
        assert got.tobytes() == sel.tobytes()
