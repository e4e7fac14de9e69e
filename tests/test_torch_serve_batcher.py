"""The port's micro-batcher and admission layer (``serve/batcher.py``,
``serve/admission.py``): coalescing and demux, the max-batch flush,
deadlines in the queue, error propagation, order at pipeline depths 1 and
2, the stall-aware flush, backpressure, the one counted degradation from
the traversal kernel's plain version to its twin on the CPU, replayed on
the port's engine, and a kernel failure on the card, which raises."""

import threading
import time

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch.serve.admission import (
    AdmissionController,
    DeadlineExceeded,
    GracefulQueryFn,
    OverloadError,
)
from mpi_cuda_largescaleknn_torch.serve.batcher import DynamicBatcher
from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
from tests.oracle import assert_dist_equal, kth_nn_dist, random_points

K = 8


@pytest.fixture(scope="module")
def index_points():
    return random_points(1500, seed=7)


@pytest.fixture(scope="module")
def engine(index_points):
    eng = ResidentKnnEngine(index_points, K, num_shards=4, engine="tiled",
                            bucket_size=32, max_batch=128, min_batch=16,
                            device="cpu")
    eng.warmup()
    return eng


def _submit_all(b, qs, timeout_s=60):
    out = [None] * len(qs)
    errs = [None] * len(qs)

    def call(i):
        try:
            out[i] = b.submit(qs[i], timeout_s=timeout_s)
        except Exception as e:  # noqa: BLE001 - asserted by callers
            errs[i] = e

    ths = [threading.Thread(target=call, args=(i,)) for i in range(len(qs))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ths)
    return out, errs


def test_coalesces_and_demuxes():
    seen = []

    def query_fn(q):
        seen.append(len(q))
        return q[:, 0].copy(), np.arange(len(q), dtype=np.int32)[:, None]

    b = DynamicBatcher(query_fn, max_batch=64, max_delay_s=0.02)
    try:
        qs = [random_points(n, seed=n) for n in (3, 5, 7, 2)]
        out, errs = _submit_all(b, qs, timeout_s=10)
        assert all(e is None for e in errs), errs
        for q, (d, _) in zip(qs, out):
            np.testing.assert_array_equal(d, q[:, 0])
        assert len(seen) < len(qs)
        assert sum(seen) == sum(len(q) for q in qs)
    finally:
        b.shutdown()


def test_flushes_on_max_batch():
    b = DynamicBatcher(lambda q: (q[:, 0].copy(),
                                  np.zeros((len(q), 1), np.int32)),
                       max_batch=8, max_delay_s=30.0)
    try:
        t0 = time.monotonic()
        out, errs = _submit_all(b, [random_points(4, seed=i)
                                    for i in (0, 1)], timeout_s=10)
        assert time.monotonic() - t0 < 5.0
        assert all(e is None for e in errs) and all(out)
        assert b.stats()["flush_full"] >= 1
    finally:
        b.shutdown()


def test_deadline_expires_in_queue():
    def slow_fn(q):
        time.sleep(0.15)
        return q[:, 0].copy(), np.zeros((len(q), 1), np.int32)

    b = DynamicBatcher(slow_fn, max_batch=4, max_delay_s=0.001)
    try:
        t1 = threading.Thread(target=lambda: b.submit(
            random_points(2, seed=1), timeout_s=10))
        t1.start()
        time.sleep(0.05)
        with pytest.raises(DeadlineExceeded):
            b.submit(random_points(2, seed=2), timeout_s=0.02)
        t1.join(timeout=10)
        assert b.stats()["rows_expired"] == 2
    finally:
        b.shutdown()


def test_errors_propagate():
    def bad_fn(q):
        raise RuntimeError("engine exploded")

    b = DynamicBatcher(bad_fn, max_batch=4, max_delay_s=0.001)
    try:
        with pytest.raises(RuntimeError, match="engine exploded"):
            b.submit(random_points(2, seed=1), timeout_s=5)
    finally:
        b.shutdown()


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_exact_and_in_order_at_depth(engine, index_points, depth):
    """Through the port's engine, every caller gets its own rows, exact,
    at depth 1 and 2, and the same bytes as a direct query; no plan is
    built beyond warmup."""
    warm = engine.compile_count
    b = DynamicBatcher(GracefulQueryFn(engine), max_batch=engine.max_batch,
                       max_delay_s=0.002, pipeline_depth=depth,
                       timers=engine.timers,
                       min_batch=engine.shape_buckets[0])
    try:
        assert b.pipelined == (depth > 1)
        sizes = (3, 17, 30, 9, 64, 5, 40, 12, 1, 100)
        qs = [random_points(n, seed=300 + n) for n in sizes]
        out, errs = _submit_all(b, qs)
        assert all(e is None for e in errs), errs
        for q, (d, nbrs) in zip(qs, out):
            assert_dist_equal(d, kth_nn_dist(q, index_points, K))
            want_d, want_n = engine.query(q)
            assert d.tobytes() == want_d.tobytes()
            np.testing.assert_array_equal(nbrs, want_n)
        assert b.inflight_batches() == 0 and b.inflight_rows() == 0
    finally:
        b.shutdown()
    assert engine.compile_count == warm


def test_dispatch_complete_equals_query(engine):
    q = random_points(23, seed=41)
    want_d, want_n = engine.query(q)
    h1 = engine.dispatch(q)
    h2 = engine.dispatch(q[:5])
    got_d, got_n = engine.complete(h1)
    np.testing.assert_array_equal(want_d, got_d)
    np.testing.assert_array_equal(want_n, got_n)
    np.testing.assert_array_equal(engine.complete(h2)[0], want_d[:5])


def test_order_preserved_under_concurrent_flushes():
    class SlowEcho:
        def dispatch(self, q):
            return q

        def complete(self, q):
            time.sleep(0.005)
            return q[:, 0].copy(), np.arange(len(q), dtype=np.int32)[:, None]

    b = DynamicBatcher(SlowEcho(), max_batch=32, max_delay_s=0.001,
                       pipeline_depth=2)
    try:
        qs = []
        for i in range(24):
            q = random_points(1 + (i % 5), seed=500 + i)
            q[:, 0] = i
            qs.append(q)
        out, errs = _submit_all(b, qs, timeout_s=30)
        assert all(e is None for e in errs), errs
        for i, (d, _) in enumerate(out):
            np.testing.assert_array_equal(d, np.full(len(qs[i]), i,
                                                     np.float32))
    finally:
        b.shutdown()


class _FailingKernel:
    """The port's engine whose traversal kernel fails: at completion
    (``where="complete"``, as an asynchronous fault shows at the event) or
    at dispatch. Everything else is the engine's own."""

    def __init__(self, eng, where):
        self.eng = eng
        self.where = where
        self.dispatches = 0
        self.completes = 0

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def dispatch(self, q, **kw):
        self.dispatches += 1
        if self.where == "dispatch" and self.eng.engine_name == "pallas_tiled":
            raise RuntimeError("knn_tiled kernel launch failed: CUDA error 1")
        return self.eng.dispatch(q, **kw)

    def complete(self, h):
        self.completes += 1
        if self.where == "complete" and h.engine_name == "pallas_tiled":
            time.sleep(0.002)
            raise RuntimeError("knn_tiled kernel fault at the event")
        return self.eng.complete(h)

    def query(self, q, **kw):
        return self.complete(self.dispatch(q, **kw))


@pytest.mark.parametrize("where", ["complete", "dispatch"])
def test_degradation_is_counted_and_replayed(index_points, where):
    """A kernel failure with batches in flight: one counted swap to the
    twin, every request replayed to the exact answer, the pipeline drained,
    ``stats()["degraded_reason"]`` set, and still serving after it."""
    eng = ResidentKnnEngine(index_points, K, num_shards=2,
                            engine="pallas_tiled", bucket_size=32,
                            max_batch=32, min_batch=16, device="cpu")
    fake = _FailingKernel(eng, where)
    g = GracefulQueryFn(fake)
    b = DynamicBatcher(g, max_batch=32, max_delay_s=0.001, pipeline_depth=2)
    try:
        qs = [random_points(4, seed=600 + i) for i in range(10)]
        out, errs = _submit_all(b, qs, timeout_s=60)
        assert all(e is None for e in errs), errs
        for q, (d, _) in zip(qs, out):
            assert_dist_equal(d, kth_nn_dist(q, index_points, K))
        assert eng.engine_name == "tiled" and not eng.can_degrade()
        assert "kernel" in eng.stats()["degraded_reason"]
        assert g.failures >= 1
        assert b.inflight_batches() == 0 and b.inflight_rows() == 0
        q = random_points(3, seed=999)
        d, _ = b.submit(q, timeout_s=30)
        assert_dist_equal(d, kth_nn_dist(q, index_points, K))
    finally:
        b.shutdown()


@pytest.mark.parametrize("where", ["complete", "dispatch"])
def test_kernel_failure_on_the_card_raises_and_is_not_replayed(
        index_points, where, monkeypatch):
    """On the card the engine cannot degrade: a kernel failure fails its
    batch's request, nothing is replayed, and the engine stays
    ``pallas_tiled`` with no ``degraded_reason``. The engine is built on
    the CPU and then placed on the card by name, which is all that
    ``can_degrade`` and ``degrade`` read."""
    eng = ResidentKnnEngine(index_points, K, engine="pallas_tiled",
                            bucket_size=32, max_batch=32, min_batch=16,
                            device="cpu")
    monkeypatch.setattr(eng, "device", torch.device("cuda", 0))
    assert not eng.can_degrade()
    with pytest.raises(RuntimeError, match="no fallback on cuda"):
        eng.degrade("RuntimeError: kernel launch failed")
    fake = _FailingKernel(eng, where)
    g = GracefulQueryFn(fake)
    b = DynamicBatcher(g, max_batch=32, max_delay_s=0.001, pipeline_depth=2)
    try:
        for i in range(3):
            with pytest.raises(RuntimeError, match="knn_tiled kernel"):
                b.submit(random_points(4, seed=700 + i), timeout_s=30)
        assert fake.dispatches == 3
        assert fake.completes == (3 if where == "complete" else 0)
        assert g.failures == 3
        assert eng.engine_name == "pallas_tiled"
        assert eng.stats()["degraded_reason"] is None
        assert b.inflight_batches() == 0 and b.inflight_rows() == 0
    finally:
        b.shutdown()


def test_non_degradable_engine_reraises():
    class FakeEngine:
        engine_name = "tiled"

        def can_degrade(self):
            return False

        def query(self, q):
            raise RuntimeError("no fallback from here")

    with pytest.raises(RuntimeError, match="no fallback"):
        GracefulQueryFn(FakeEngine())(random_points(2, seed=1))


def test_stall_aware_flush_keeps_rows_queued_while_pipe_full():
    class GatedEcho:
        def __init__(self):
            self.release = threading.Semaphore(0)

        def dispatch(self, q):
            return q

        def complete(self, q):
            self.release.acquire()
            return q[:, 0].copy(), np.zeros((len(q), 1), np.int32)

    eng = GatedEcho()
    b = DynamicBatcher(eng, max_batch=8, max_delay_s=0.001,
                       pipeline_depth=2, min_batch=8)
    try:
        qs = [random_points(8, seed=800 + i) for i in range(4)]
        for i, q in enumerate(qs):
            q[:, 0] = i
        results = [None] * 4
        ths = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, b.submit(qs[i], timeout_s=30))) for i in range(4)]
        for t in ths:
            t.start()
        deadline = time.monotonic() + 5
        while b.inflight_batches() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.inflight_batches() == 2
        time.sleep(0.1)
        assert b.stats()["batches"] == 2
        assert b.queue_depth_rows() == 16
        for _ in range(4):
            eng.release.release()
        for t in ths:
            t.join(timeout=30)
        st = b.stats()
        assert st["dispatch_stalls"] >= 1 and st["dispatch_stall_seconds"] > 0
        for i, got in enumerate(results):
            np.testing.assert_array_equal(got[0], np.full(8, i, np.float32))
    finally:
        eng.release.release()
        b.shutdown(wait=False)


def test_admission_rejects_beyond_cap_and_releases():
    a = AdmissionController(max_queue_rows=10)
    a.admit(8)
    with pytest.raises(OverloadError):
        a.admit(3)
    a.admit(2)
    a.release(8)
    a.release(2)
    assert a.inflight_rows() == 0
    assert a.stats()["rejected"] == 1
    with pytest.raises(ValueError):
        with a.admitted_rows(10):
            raise ValueError("boom")
    assert a.inflight_rows() == 0
