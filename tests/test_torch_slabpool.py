"""The port's tiered slab index (``serve/slabpool.py``) against the JAX
package's, on the CPU (``device="cpu"``: the kernels' plain versions),
bitwise.

- ``SlabSource``: slab rows byte-equal to ``read_file_portion`` (the
  port's and the JAX package's) and to the slab split, for ``.float3`` and
  ``.npy``; ``scan_aabbs`` equal to ``slab_aabbs``.
- ``SlabPool`` with fake engines (no card, no sleeps): LRU order, pins
  against eviction and counted overcommit, the host tier's demotion and
  cap, stalls on an injectable clock, prefetch then a stall-free
  ``ensure``, a failed promotion that leaves the pool working, injected
  slow and failed promotions, concurrent ``ensure`` building once.
- ``StreamingKnnEngine`` against the JAX ``StreamingKnnEngine`` (engine
  ``tiled``) over the budget matrix {1 slab, half, all}: distances and ids
  bitwise, ``emit`` ``final`` and ``candidates``, a finite
  ``max_radius``; and against the port's own ``ResidentKnnEngine``. Pins
  released after ``complete`` and after a failed promotion or launch,
  ``compile_count`` flat through eviction churn, a hint announced ahead
  means no stall, the empty batch.
- Serving: the HTTP bodies of a streaming server byte-equal to the JAX
  server's, the ``/metrics`` slab lines named as JAX names them, and the
  batcher's prefetch hints.

The points plant exact coordinate copies across slab boundaries
(distance-0 ties across slabs), held by the canonical (dist2, id) order
on both sides."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.serve import server as t_server
from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
from mpi_cuda_largescaleknn_torch.serve.faults import FaultInjector
from mpi_cuda_largescaleknn_torch.serve.slabpool import (
    SlabPool,
    SlabSource,
    StreamingKnnEngine,
)
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from mpi_cuda_largescaleknn_tpu.serve import server as j_server
from mpi_cuda_largescaleknn_tpu.serve.slabpool import (
    StreamingKnnEngine as JaxStreaming,
)
from tests.oracle import kth_nn_dist, random_points

K = 5
KW = dict(bucket_size=64, max_batch=32, min_batch=16, merge="device")


def _streaming_points():
    """600 rows: [0:295) cluster A, [295:300) exact copies of rows
    [595:600) (cluster-B points inside the A-side slabs: distance-0 ties
    across slabs, and boxes overlapping B that force escalation),
    [300:600) cluster B."""
    a = random_points(295, seed=41, scale=0.4)
    b = random_points(300, seed=42, scale=0.4) + np.float32(0.6)
    return np.concatenate([a, b[-5:], b]).astype(np.float32)


def _probe_batches(pts, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.random((17, 3)).astype(np.float32),
        rng.random((32, 3)).astype(np.float32) * 1.2 - 0.1,
        pts[[0, 150, 295, 296, 299, 595, 599]],  # the planted copies
        np.full((3, 3), 0.5, np.float32),        # the A/B gap
        pts[42:43],
    ]


def _same(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    assert a[0].tobytes() == b[0].tobytes()
    assert np.array_equal(a[1], b[1])


# --------------------------------------------------------------- SlabSource


class TestSlabSource:
    def test_float3_rows_byte_equal_to_read_file_portion(self, tmp_path):
        from mpi_cuda_largescaleknn_torch.io.reader import read_file_portion
        from mpi_cuda_largescaleknn_tpu.io.reader import (
            read_file_portion as j_read,
        )

        pts = _streaming_points()
        path = str(tmp_path / "pts.float3")
        pts.astype("<f4").tofile(path)
        src = SlabSource(path=path, num_slabs=4)
        assert src.n_total == len(pts) and src.dim == 3
        for s in range(4):
            want, begin, n = read_file_portion(path, s, 4)
            jw, jb, _jn = j_read(path, s, 4)
            got = src.read(s)
            assert got.tobytes() == want.tobytes() == jw.tobytes()
            assert src.bounds[s][0] == begin == jb and n == len(pts)

    def test_npy_mmap_rows_byte_equal_to_slab_split(self, tmp_path):
        from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds
        from mpi_cuda_largescaleknn_torch.serve.engine import load_slab_rows
        from mpi_cuda_largescaleknn_tpu.serve.engine import (
            load_slab_rows as j_load,
        )

        pts = _streaming_points()
        path = str(tmp_path / "pts.npy")
        np.save(path, pts)
        src = SlabSource(path=path, num_slabs=3)
        assert src.bounds == slab_bounds(len(pts), 3)
        for s in range(3):
            b, e = src.bounds[s]
            assert src.read(s).tobytes() == pts[b:e].tobytes()
            rows, begin, _n = load_slab_rows(path, s, 3)
            jrows, jbegin, _jn = j_load(path, s, 3)
            assert begin == b == jbegin
            assert rows.tobytes() == src.read(s).tobytes() == jrows.tobytes()

    def test_float3_and_npy_sources_agree(self, tmp_path):
        pts = _streaming_points()
        f3 = str(tmp_path / "pts.float3")
        npy = str(tmp_path / "pts.npy")
        pts.astype("<f4").tofile(f3)
        np.save(npy, pts)
        a = SlabSource(path=f3, num_slabs=5)
        b = SlabSource(path=npy, num_slabs=5)
        c = SlabSource(points=pts, num_slabs=5)
        for s in range(5):
            assert (a.read(s).tobytes() == b.read(s).tobytes()
                    == c.read(s).tobytes())

    def test_scan_aabbs_matches_slab_aabbs(self):
        from mpi_cuda_largescaleknn_torch.models.sharding import slab_aabbs
        from mpi_cuda_largescaleknn_tpu.serve.slabpool import (
            SlabSource as JaxSource,
        )

        pts = _streaming_points()
        src = SlabSource(points=pts, num_slabs=4)
        got = src.scan_aabbs()
        assert got == slab_aabbs(pts, src.bounds)
        assert got == JaxSource(points=pts, num_slabs=4).scan_aabbs()

    def test_rejects_bad_config(self):
        with pytest.raises(ValueError):
            SlabSource(num_slabs=2)  # neither path nor points
        with pytest.raises(ValueError):
            SlabSource(points=np.zeros((4, 3)), num_slabs=0)
        # url= asks the host's /stats first: nothing listening raises
        with pytest.raises(OSError):
            SlabSource(url="http://127.0.0.1:1", num_slabs=2)

    @pytest.mark.parametrize("wire", ["d16", "f32"])
    def test_url_source_reads_equal_jax(self, wire):
        """``url=``: slabs pulled from a routed host serving the whole
        index (row offset 0), byte-equal to the in-memory source and to
        the JAX package's ``SlabSource(url=)``, and a streaming engine
        over it answers like one over the rows."""
        from mpi_cuda_largescaleknn_torch.serve.frontend import (
            HostSliceServer,
        )
        from mpi_cuda_largescaleknn_tpu.serve.slabpool import (
            SlabSource as JaxSource,
        )

        pts = _streaming_points()
        eng = ResidentKnnEngine(pts, K, bucket_size=64, max_batch=32,
                                emit="candidates", device="cpu")
        srv = HostSliceServer(("127.0.0.1", 0), eng, routing="bounds")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        srv.ready = True
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            src = SlabSource(url=url, num_slabs=4, wire=wire)
            jsrc = JaxSource(url=url, num_slabs=4, wire=wire)
            mem = SlabSource(points=pts, num_slabs=4)
            assert (src.n_total, src.dim, src.bounds) == (
                jsrc.n_total, jsrc.dim, jsrc.bounds)
            for s in range(4):
                assert src.read(s).tobytes() == mem.read(s).tobytes() \
                    == jsrc.read(s).tobytes()
            st = StreamingKnnEngine(k=K, source_url=url, source_wire=wire,
                                    num_slabs=4, max_batch=32,
                                    device="cpu")
            q = random_points(9, seed=31)
            want = ResidentKnnEngine(pts, K, max_batch=32,
                                     device="cpu").query(q)
            got = st.query(q)
            assert got[0].tobytes() == want[0].tobytes()
            assert np.array_equal(got[1], want[1])
            st.close()
        finally:
            srv.close()


# ----------------------------------------------------------------- SlabPool


class _FakeEngine:
    def __init__(self, slab, rows, device_bytes):
        self.slab = slab
        self.host_points = rows
        self.device_bytes = device_bytes


class _PoolRig:
    """A SlabPool over fakes: an injectable clock (a counter, no sleeps),
    a time cost a build, and a build log."""

    def __init__(self, n=80, num_slabs=8, slab_bytes=100, build_cost=0.5,
                 fail_slabs=(), **pool_kw):
        self.now = [0.0]
        self.built = []
        self.fail_slabs = set(fail_slabs)
        src = SlabSource(points=np.arange(n * 3, dtype=np.float32)
                         .reshape(n, 3), num_slabs=num_slabs)

        def factory(slab, rows, begin):
            if slab in self.fail_slabs:
                raise RuntimeError(f"build of slab {slab} exploded")
            self.now[0] += build_cost
            self.built.append(slab)
            return _FakeEngine(slab, rows, slab_bytes)

        self.pool = SlabPool(src, factory, clock=lambda: self.now[0],
                             **pool_kw)


class TestSlabPool:
    def test_lru_eviction_order(self):
        p = _PoolRig(device_budget_bytes=200).pool  # 2 slabs
        p.ensure(0), p.ensure(1)
        assert p.resident_slabs() == [0, 1]
        p.ensure(2)  # 0 is the least recently used
        assert p.resident_slabs() == [1, 2]
        p.ensure(1)  # 2 is now
        p.ensure(3)
        assert p.resident_slabs() == [1, 3]
        assert p.stats()["evictions"] == 2
        p.close()

    def test_pin_blocks_eviction_and_overcommit_counted(self):
        p = _PoolRig(device_budget_bytes=200).pool
        p.ensure(0), p.ensure(1)
        p.pin([0])
        p.ensure(2)  # 0 pinned: 1 goes
        assert p.resident_slabs() == [0, 2]
        p.pin([2])
        p.ensure(3)  # both pinned: overcommit, no eviction
        assert p.resident_slabs() == [0, 2, 3]
        s = p.stats()
        assert s["overcommits"] == 1 and s["device_bytes_peak"] == 300
        p.unpin([0]), p.unpin([2])  # the budget holds again at once
        assert len(p.resident_slabs()) == 2
        assert p.stats()["device_bytes_used"] <= 200
        p.close()

    def test_host_tier_demotion_and_cap(self):
        p = _PoolRig(device_budget_bytes=100, host_pool_slabs=3).pool
        p.ensure(0)
        p.ensure(1)  # evicts 0: its rows demote to the host tier
        p.ensure(2)
        s = p.stats()
        assert s["cold_reads"] == 3 and s["host_resident"] == 3
        p.ensure(0)  # still in host RAM: no cold read
        s = p.stats()
        assert s["host_hits"] == 1 and s["cold_reads"] == 3
        for slab in (3, 4, 5):
            p.ensure(slab)
        s = p.stats()
        assert s["host_resident"] <= 3 and s["host_evictions"] > 0
        cold_before = s["cold_reads"]
        p.ensure(1)  # fell out of the host tier: read cold again
        assert p.stats()["cold_reads"] == cold_before + 1
        p.close()

    def test_host_tier_byte_cap(self):
        # 10 rows a slab: 120 bytes; a cap of 300 bytes holds 2 slabs
        p = _PoolRig(device_budget_bytes=100, host_pool_bytes=300).pool
        for slab in range(5):
            p.ensure(slab)
        s = p.stats()
        assert s["host_bytes_used"] <= 300 and s["host_resident"] == 2
        assert s["host_evictions"] >= 3
        p.close()

    def test_stall_accounting_via_injectable_clock(self):
        p = _PoolRig(device_budget_bytes=0, build_cost=0.5).pool
        p.ensure(0)  # a cold promotion: one stall of one build
        s = p.stats()
        assert s["stream_stalls"] == 1
        assert s["stream_stall_seconds"] == pytest.approx(0.5)
        p.ensure(0)  # resident: a device hit
        s = p.stats()
        assert s["stream_stalls"] == 1 and s["device_hits"] == 1
        p.ensure(1, count_stall=False)  # warmup/prefetch: no stall
        assert p.stats()["stream_stalls"] == 1
        p.close()

    def test_prefetch_then_ensure_is_stall_free(self):
        p = _PoolRig(device_budget_bytes=0).pool
        p.prefetch([3, 4])
        assert p.wait_idle(timeout_s=10)
        assert set(p.resident_slabs()) >= {3, 4}
        p.ensure(3), p.ensure(4)
        s = p.stats()
        assert s["stream_stalls"] == 0 and s["device_hits"] == 2
        assert s["prefetch_enqueued"] == 2
        p.close()

    def test_promotion_error_surfaces_and_pool_survives(self):
        p = _PoolRig(fail_slabs={5}).pool
        with pytest.raises(RuntimeError, match="slab 5"):
            p.ensure(5)
        s = p.stats()
        assert s["promotion_errors"] == 1 and "slab 5" in s["last_error"]
        p.prefetch([5, 6])  # the promotion thread survives it too
        assert p.wait_idle(timeout_s=10)
        s = p.stats()
        assert s["prefetch_errors"] == 1 and 6 in p.resident_slabs()
        p.close()

    def test_faults_injected_slow_promotion_counts_a_stall(self):
        inj = FaultInjector()
        inj.set_specs("latency:path=/slab/2,delay_s=0.25")
        rig = _PoolRig(build_cost=0.0, faults=inj)
        p = rig.pool
        # the injected sleep rides the same fake clock: no real sleeping
        p._sleep = lambda s: rig.now.__setitem__(0, rig.now[0] + s)
        p.ensure(1)
        assert p.stats()["stream_stall_seconds"] == pytest.approx(0.0)
        p.ensure(2)
        assert p.stats()["stream_stall_seconds"] == pytest.approx(0.25)
        p.close()

    def test_faults_injected_promotion_failure_raises(self):
        inj = FaultInjector()
        inj.set_specs("error:path=/slab/1,n=1")
        rig = _PoolRig(faults=inj)
        with pytest.raises(RuntimeError, match="injected"):
            rig.pool.ensure(1)
        rig.pool.ensure(1)  # the budget n=1 is spent: the retry lands
        assert 1 in rig.pool.resident_slabs()
        rig.pool.close()

    def test_concurrent_ensure_single_build(self):
        rig = _PoolRig()
        errs = []

        def hit():
            try:
                rig.pool.ensure(2)
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        ts = [threading.Thread(target=hit) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not errs
        assert rig.built.count(2) == 1
        rig.pool.close()


# ------------------------------------------------------- streaming parity


@pytest.fixture(scope="module")
def parity_rig():
    """The JAX streaming engine (``tiled``, two devices), the port's
    streaming engines (``tiled`` and ``pallas_tiled``, two shards) and the
    port's resident engine over the same 600 points, 4 slabs."""
    pts = _streaming_points()
    jax = JaxStreaming(points=pts, num_slabs=4, k=K, mesh=get_mesh(2),
                       engine="tiled", **KW)
    jax.warmup()
    ports = {}
    for eng in ("tiled", "pallas_tiled"):
        ports[eng] = StreamingKnnEngine(points=pts, num_slabs=4, k=K,
                                        num_shards=2, engine=eng,
                                        device="cpu", **KW)
        ports[eng].warmup()
    ref = ResidentKnnEngine(pts, K, num_shards=2, engine="pallas_tiled",
                            device="cpu", **KW)
    ref.warmup()
    yield pts, jax, ports, ref
    jax.close()
    for p in ports.values():
        p.close()


def _budgets(stream, jax=None):
    for slabs in (1, 2, 4):
        stream.slab_pool.set_device_budget(stream.slab_device_bytes * slabs)
        if jax is not None:
            jax.slab_pool.set_device_budget(jax.slab_device_bytes * slabs)
        yield slabs
    stream.slab_pool.set_device_budget(0)
    if jax is not None:
        jax.slab_pool.set_device_budget(0)


class TestStreamingParity:
    @pytest.mark.parametrize("engine", ["tiled", "pallas_tiled"])
    def test_bitwise_parity_with_jax_across_budget_matrix(self, parity_rig,
                                                          engine):
        """Budgets {1 slab, half, all}: the port serves the JAX streaming
        engine's bytes, distances and tie ids."""
        pts, jax, ports, _ref = parity_rig
        stream = ports[engine]
        for slabs in _budgets(stream, jax):
            for q in _probe_batches(pts):
                _same(stream.query(q), jax.query(q))
            assert len(stream.slab_pool.resident_slabs()) <= slabs + 1

    @pytest.mark.parametrize("engine", ["tiled", "pallas_tiled"])
    def test_bitwise_parity_with_resident_engine(self, parity_rig, engine):
        pts, _jax, ports, ref = parity_rig
        stream = ports[engine]
        for _slabs in _budgets(stream):
            for q in _probe_batches(pts, seed=3):
                _same(stream.query(q), ref.query(q))

    def test_deep_cluster_query_routes_away_from_far_slabs(self,
                                                           parity_rig):
        """A query deep inside cluster A never visits the B-side slabs
        (certified away on bounds); gap queries escalate."""
        pts, _jax, ports, _ref = parity_rig
        stream = ports["pallas_tiled"]
        h = stream.dispatch(pts[10:11])
        stream.complete(h)
        assert h.visited[0, 2:].sum() == 0
        before = stream.timers.counter("stream_escalations")
        h2 = stream.dispatch(np.full((2, 3), 0.5, np.float32))
        stream.complete(h2)
        assert h2.visited.sum(axis=1).max() > 1
        assert stream.timers.counter("stream_escalations") > before

    def test_pins_released_after_complete(self, parity_rig):
        pts, _jax, ports, _ref = parity_rig
        ports["pallas_tiled"].query(pts[:8])
        assert ports["pallas_tiled"].slab_pool.stats()["pinned_slabs"] == []

    def test_plans_shared_across_eviction_churn(self, parity_rig):
        """Cycling every slab through a 1-slab budget builds no launch
        plan: ``compile_count`` (the shared cache's) stays flat, as the
        JAX engine's does."""
        pts, jax, ports, _ref = parity_rig
        stream = ports["pallas_tiled"]
        before = stream.stats()["compile_count"]
        assert before == jax.stats()["compile_count"] \
            == len(stream.shape_buckets)
        stream.slab_pool.set_device_budget(stream.slab_device_bytes)
        for q in _probe_batches(pts):
            stream.query(q)
        stats = stream.stats()
        assert stats["compile_count"] == before
        assert stats["slab_pool"]["evictions"] > 0
        stream.slab_pool.set_device_budget(0)

    def test_prefetch_hint_announced_ahead_means_zero_stalls(self,
                                                             parity_rig):
        pts, _jax, ports, _ref = parity_rig
        stream = ports["pallas_tiled"]
        pool = stream.slab_pool
        # 3 slabs: one batch's whole routed set fits (slab 1's box spans
        # both clusters), while parking at one end evicts the other's
        pool.set_device_budget(3 * stream.slab_device_bytes)
        # a promotion takes 50 ms (a plain CPU build takes less than the
        # dispatch's walk to the slab, and would never be waited on)
        inj = FaultInjector()
        inj.set_specs("latency:path=/slab/,delay_s=0.05")
        pool._faults = inj
        try:
            q_a, q_b = pts[10:18], pts[590:598]
            stream.query(q_a)
            pool.wait_idle(timeout_s=30)
            stream.prefetch_hint(q_b)
            assert pool.wait_idle(timeout_s=30)
            before = pool.stats()["stream_stalls"]
            stream.query(q_b)
            assert pool.stats()["stream_stalls"] == before
            stream.query(q_a)  # the un-hinted twin does stall
            pool.wait_idle(timeout_s=30)
            stream.query(q_b)
            assert pool.stats()["stream_stalls"] > before
        finally:
            pool._faults = None
            pool.set_device_budget(0)

    def test_slow_promotion_stalls_but_stays_exact(self, parity_rig):
        pts, jax, ports, _ref = parity_rig
        stream = ports["pallas_tiled"]
        pool = stream.slab_pool
        pool.set_device_budget(stream.slab_device_bytes)
        stream.query(pts[10:18])
        pool.wait_idle(timeout_s=30)
        inj = FaultInjector()
        inj.set_specs("latency:path=/slab/,delay_s=0.2")
        pool._faults = inj
        try:
            before = pool.stats()
            q = pts[590:598]
            _same(stream.query(q), jax.query(q))
            after = pool.stats()
            assert after["stream_stalls"] > before["stream_stalls"]
            assert (after["stream_stall_seconds"]
                    >= before["stream_stall_seconds"] + 0.2)
        finally:
            pool._faults = None
            pool.set_device_budget(0)

    def test_skip_cold_folds_each_candidate_once(self, parity_rig):
        """The recall tier's ``stream_skip_cold``: cold slabs that could
        still beat the k-th distance are skipped (counted), and every
        candidate is folded once. The JAX engine re-folds the last wave's
        rows when a skip leaves nothing to dispatch, so its rows repeat
        ids there: the port is held to the exact answer's bound and to
        distinct ids instead."""
        from mpi_cuda_largescaleknn_torch.serve.recall import RecallPlan

        pts, _jax, ports, ref = parity_rig
        stream = ports["pallas_tiled"]
        pool = stream.slab_pool
        plan = RecallPlan(name="skip", recall_estimated=0.9,
                          stream_skip_cold=True)
        pool.set_device_budget(stream.slab_device_bytes)
        try:
            stream.query(pts[10:12])  # park at the A end
            pool.wait_idle(timeout_s=30)
            before = stream.timers.counter("stream_skipped_promotions")
            q = np.full((3, 3), 0.5, np.float32)
            d, idx = stream.query(q, plan=plan)
            assert stream.timers.counter("stream_skipped_promotions") \
                > before
            for row in idx.tolist():
                assert len(set(row)) == len(row)
            assert (d >= ref.query(q)[0]).all()
        finally:
            pool.wait_idle(timeout_s=30)
            pool.set_device_budget(0)

    def test_empty_batch(self, parity_rig):
        _pts, _jax, ports, _ref = parity_rig
        d, n = ports["pallas_tiled"].query(np.zeros((0, 3), np.float32))
        assert d.shape == (0,) and n.shape == (0, K)


def _sorted_points(n=96, seed=3):
    return np.sort(random_points(n, seed=seed), axis=0)  # slab locality


class TestStreamingFailures:
    def test_dispatch_promotion_failure_releases_pins(self):
        """A failed promotion mid-dispatch raises AND releases the
        batch's pins; once the fault clears the engine serves exactly."""
        pts = _sorted_points()
        stream = StreamingKnnEngine(points=pts, num_slabs=2, k=3,
                                    engine="pallas_tiled", bucket_size=32,
                                    max_batch=16, min_batch=8,
                                    prefetch_depth=0, device="cpu")
        ref = ResidentKnnEngine(pts, 3, engine="pallas_tiled",
                                bucket_size=32, max_batch=16, min_batch=8,
                                device="cpu")
        try:
            stream.slab_pool.set_device_budget(stream.slab_device_bytes)
            stream.query(pts[:4])  # park at the low end
            stream.slab_pool.wait_idle(timeout_s=30)
            inj = FaultInjector()
            inj.set_specs("error:path=/slab/,n=2")
            stream.slab_pool._faults = inj
            with pytest.raises(RuntimeError, match="injected"):
                stream.query(pts[90:94])  # needs the evicted far slab
            assert stream.slab_pool.stats()["pinned_slabs"] == []
            inj.clear()
            _same(stream.query(pts[90:94]), ref.query(pts[90:94]))
        finally:
            stream.close()

    def test_launch_failure_releases_pins(self, monkeypatch):
        """A kernel launch that raises (in the first wave or in an
        escalation wave) fails the batch and releases every pin."""
        from mpi_cuda_largescaleknn_torch.serve import engine as t_engine

        pts = _sorted_points()
        stream = StreamingKnnEngine(points=pts, num_slabs=2, k=3,
                                    engine="pallas_tiled", bucket_size=32,
                                    max_batch=16, min_batch=8,
                                    device="cpu")
        real = t_engine.knn_update_tiled_cuda
        calls = []

        def flaky(*args, **kw):
            calls.append(1)
            if len(calls) >= fail_at[0]:
                raise RuntimeError("kernel launch failed")
            return real(*args, **kw)

        fail_at = [1]
        monkeypatch.setattr(t_engine, "knn_update_tiled_cuda", flaky)
        try:
            q = np.full((4, 3), 0.5, np.float32)  # both slabs' boxes
            with pytest.raises(RuntimeError, match="kernel launch"):
                stream.query(q)
            assert stream.slab_pool.stats()["pinned_slabs"] == []
            # the escalation wave's launch: the first wave lands, a later
            # one raises inside complete
            calls.clear()
            fail_at[0] = 2
            gap = (pts[47:48] + pts[48:49]) / 2  # between the two boxes
            h = stream.dispatch(gap)
            assert h.visited.sum() == 1
            with pytest.raises(RuntimeError, match="kernel launch"):
                stream.complete(h)
            assert stream.slab_pool.stats()["pinned_slabs"] == []
        finally:
            stream.close()

    def test_max_radius_parity(self):
        pts = random_points(96, seed=3)
        kw = dict(bucket_size=32, max_batch=16, min_batch=8,
                  max_radius=0.15)
        jax = JaxStreaming(points=pts, num_slabs=2, k=3, mesh=get_mesh(2),
                           engine="tiled", **kw)
        stream = StreamingKnnEngine(points=pts, num_slabs=2, k=3,
                                    num_shards=2, engine="pallas_tiled",
                                    device="cpu", **kw)
        ref = ResidentKnnEngine(pts, 3, num_shards=2, engine="pallas_tiled",
                                device="cpu", **kw)
        try:
            q = random_points(16, seed=9)
            got = stream.query(q)
            _same(got, jax.query(q))
            _same(got, ref.query(q))
            assert np.isinf(got[0]).any() or (got[0] <= 0.15).all()
        finally:
            jax.close()
            stream.close()

    @pytest.mark.parametrize("merge", ["host", "device"])
    def test_candidates_emit_parity(self, merge):
        """``emit="candidates"``: the folded rows equal the JAX streaming
        engine's and a resident candidates engine's, ids from 1000, under
        both merge placements."""
        pts = random_points(128, seed=5)
        kw = dict(bucket_size=32, max_batch=16, min_batch=8, merge=merge,
                  id_offset=1000, emit="candidates")
        jax = JaxStreaming(points=pts, num_slabs=3, k=4, mesh=get_mesh(2),
                           engine="tiled", **kw)
        stream = StreamingKnnEngine(points=pts, num_slabs=3, k=4,
                                    num_shards=2, engine="pallas_tiled",
                                    device="cpu", **kw)
        ref = ResidentKnnEngine(pts, 4, num_shards=2, engine="pallas_tiled",
                                device="cpu", **kw)
        try:
            q = random_points(12, seed=11)
            got = stream.complete_candidates(stream.dispatch(q))
            _same(got, jax.complete_candidates(jax.dispatch(q)))
            _same(got, ref.complete_candidates(ref.dispatch(q)))
            assert got[1].min() >= 1000
            with pytest.raises(RuntimeError, match="complete_candidates"):
                stream.complete(stream.dispatch(q))
            with pytest.raises(RuntimeError, match="complete_candidates"):
                ref.complete(ref.dispatch(q))
        finally:
            jax.close()
            stream.close()


# -------------------------------------------------------- serving surface


def _start(mod, engine, **kw):
    srv = mod.build_server(engine, port=0, max_delay_s=0.002, **kw)
    srv.ready = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _request(srv, path, body=None, ctype="application/json"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}{path}", data=body,
        headers={} if body is None else {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _metric_names(text: str, prefixes) -> set:
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")
            and line.startswith(prefixes)}


class TestStreamingServing:
    def test_stats_and_metrics_surface(self, parity_rig):
        _pts, jax, ports, _ref = parity_rig
        stream = ports["pallas_tiled"]
        stats = stream.stats()
        pool = stats["slab_pool"]
        assert set(stats) == set(jax.stats())
        assert set(pool) - {"device_bytes_peak"} \
            == set(jax.stats()["slab_pool"])
        assert stats["device_bytes"] == (stream.slab_device_bytes
                                         * pool["device_resident"])
        srv = t_server.build_server(stream, port=0)
        jsrv = j_server.build_server(jax, port=0)
        try:
            text = t_server._Handler._prometheus(srv)
            jtext = j_server._Handler._prometheus(jsrv)
            for line in ('knn_slab_pool_resident{tier="device"}',
                         'knn_slab_pool_resident{tier="host"}',
                         "knn_slab_promotions_total",
                         "knn_slab_evictions_total",
                         "knn_stream_stall_seconds_total",
                         'knn_slab_pool_hits_total{tier="device"}',
                         "knn_slab_pool_cold_reads_total"):
                assert line in text, line
            pre = ("knn_slab", "knn_stream")
            assert _metric_names(text, pre) == _metric_names(jtext, pre)
            assert _metric_names(text, pre)
        finally:
            srv.close()
            jsrv.close()

    def test_http_bodies_byte_equal_to_jax(self, parity_rig):
        """A streaming server of each package at a 2-slab budget, the
        same requests in the same order: JSON with neighbors, binary,
        zero rows, an over-wide batch; bodies byte-equal, distances the
        exact answer."""
        pts, jax, ports, _ref = parity_rig
        stream = ports["pallas_tiled"]
        stream.slab_pool.set_device_budget(stream.slab_device_bytes * 2)
        jax.slab_pool.set_device_budget(jax.slab_device_bytes * 2)
        pair = (_start(j_server, jax, pipeline_depth=2),
                _start(t_server, stream, pipeline_depth=2))
        try:
            rng = np.random.default_rng(0)
            q = rng.random((24, 3)).astype(np.float32)
            reqs = [
                ("/knn", json.dumps({"queries": q.tolist(),
                                     "neighbors": True}).encode(),
                 "application/json"),
                ("/knn", json.dumps({"queries": pts[290:300].tolist(),
                                     "neighbors": True}).encode(),
                 "application/json"),
                ("/knn?neighbors=1", q.astype("<f4").tobytes(),
                 "application/octet-stream"),
                ("/knn", json.dumps({"queries": []}).encode(),
                 "application/json"),
                ("/knn", json.dumps({"queries": rng.random((40, 3))
                                     .tolist()}).encode(),
                 "application/json"),
            ]
            bodies = []
            for path, body, ctype in reqs:
                jr, pr = (_request(s, path, body, ctype) for s in pair)
                assert pr == jr, (path, jr, pr)
                bodies.append(pr)
            assert [b[0] for b in bodies] == [200, 200, 200, 200, 413]
            got = np.asarray(json.loads(bodies[0][2])["dists"], np.float32)
            assert got.tobytes() == kth_nn_dist(q, pts, K).tobytes()
        finally:
            for srv in pair:
                srv.close()
            stream.slab_pool.set_device_budget(0)
            jax.slab_pool.set_device_budget(0)


class TestBatcherPrefetchHint:
    def test_queued_rows_announced_after_dispatch(self):
        """``_announce_prefetch`` forwards the queued rows, capped at
        ``max_batch`` whole requests, to the query_fn's
        ``prefetch_hint``."""
        import time as _time

        from mpi_cuda_largescaleknn_torch.serve.batcher import (
            DynamicBatcher,
            _Request,
        )

        hinted = []

        class _Fn:
            dim = 3

            def dispatch(self, q):
                return np.asarray(q)

            def complete(self, handle):
                n = len(handle)
                return np.zeros(n, np.float32), np.zeros((n, 2), np.int32)

            def prefetch_hint(self, q):
                hinted.append(np.asarray(q).copy())

        b = DynamicBatcher(_Fn(), max_batch=4, max_delay_s=60.0,
                           pipeline_depth=2)
        try:
            assert b._prefetch_fn is not None
            now = _time.monotonic()
            with b._cond:
                for i in range(3):  # 6 rows queued > max_batch 4
                    b._queue.append(_Request(
                        queries=np.full((2, 3), i, np.float32),
                        deadline=None, enqueued=now))
            b._announce_prefetch()
            assert len(hinted) == 1
            assert hinted[0].shape == (4, 3)
            assert np.array_equal(hinted[0][:2],
                                  np.zeros((2, 3), np.float32))
            with b._cond:
                b._queue.clear()
            b._announce_prefetch()  # empty queue: no announcement
            assert len(hinted) == 1
            assert b.stats()["prefetch_hint_errors"] == 0
        finally:
            with b._cond:
                b._queue.clear()
                b._cond.notify_all()
            b.shutdown()

    def test_hint_errors_counted_not_fatal(self):
        from mpi_cuda_largescaleknn_torch.serve.batcher import DynamicBatcher

        release = threading.Event()

        class _Fn:
            dim = 3

            def dispatch(self, q):
                return np.asarray(q)

            def complete(self, handle):
                release.wait(10)
                n = len(handle)
                return (np.zeros(n, np.float32),
                        np.zeros((n, 2), np.int32))

            def prefetch_hint(self, q):
                raise RuntimeError("hint exploded")

        b = DynamicBatcher(_Fn(), max_batch=8, max_delay_s=0.001,
                           pipeline_depth=2)
        try:
            out = []
            ts = [threading.Thread(
                target=lambda i=i: out.append(
                    b.submit(np.full((2, 3), i, np.float32))))
                for i in range(4)]
            for t in ts:
                t.start()
            release.set()
            for t in ts:
                t.join(timeout=10)
            assert len(out) == 4  # every batch still answered
        finally:
            b.shutdown()
