"""The port's multi-index tenancy (``serve/tenancy.py``) against the JAX
package's, on the CPU (``device="cpu"``: the kernels' plain versions).

- ``TenantSpec`` / ``TenantRegistry``: names that ride in URLs, sorted
  enumeration, ``UnknownTenantError`` (the 404).
- ``TenantQuotas`` over an ``AdmissionController``: per-tenant caps over
  one global row budget, the tenant's reservation rolled back when the
  GLOBAL cap rejects, 0 = unsliced, Retry-After on the ``OverloadError``.
- A shared ``SlabPool`` with fake engines: (tenant, slab) keys routed to
  each tenant's source, per-tenant accounting, a re-touched tenant's page
  surviving another tenant's churn, pins and prefetch on tuple keys.
- ``MultiTenantEngine``: each tenant's answers bitwise equal to the JAX
  ``MultiTenantEngine``'s (engine ``tiled``) and to the port's own
  single-tenant streaming engine over the same points, across device
  budgets; three tenants warm through ONE plan cache.
- HTTP: a multi-tenant server of each package, the same requests in the
  same order, response bodies byte-equal (``/v1/<t>/knn`` in JSON and
  binary, the ``tenant`` field, the ``X-Knn-Tenant`` header, legacy
  ``/knn``, the unknown tenant's 404, the quota's 429); the tenant
  ``/stats`` namespace and route; the ``{tenant=}`` metric names equal to
  JAX's; and a single-index server showing none of it."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_cuda_largescaleknn_torch.serve import server as t_server
from mpi_cuda_largescaleknn_torch.serve.admission import (
    AdmissionController,
    OverloadError,
)
from mpi_cuda_largescaleknn_torch.serve.slabpool import (
    SlabPool,
    SlabSource,
    StreamingKnnEngine,
)
from mpi_cuda_largescaleknn_torch.serve.tenancy import (
    MultiTenantEngine,
    TenantQuotas,
    TenantRegistry,
    TenantSpec,
    UnknownTenantError,
)
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from mpi_cuda_largescaleknn_tpu.serve import server as j_server
from mpi_cuda_largescaleknn_tpu.serve.tenancy import (
    MultiTenantEngine as JaxMultiTenant,
)
from mpi_cuda_largescaleknn_tpu.serve.tenancy import (
    TenantSpec as JaxSpec,
)
from tests.oracle import random_points

K = 5
KW = dict(bucket_size=64, max_batch=32, min_batch=16, merge="device")
NAMES = ["t0", "t1", "t2"]


def _tenant_points(i: int, n: int = 240):
    """Each tenant its own cloud (seed and size: different sizes exercise
    the shared pad-shape class)."""
    return random_points(n + 30 * i, seed=100 + i, scale=0.5)


def _same(a, b):
    assert a[0].tobytes() == b[0].tobytes()
    assert np.array_equal(a[1], b[1])


# ------------------------------------------------------ spec + registry


class TestTenantSpecAndRegistry:
    def test_spec_rejects_url_hostile_names(self):
        with pytest.raises(ValueError, match="bad tenant name"):
            TenantSpec("", points=np.zeros((4, 3)))
        with pytest.raises(ValueError, match="bad tenant name"):
            TenantSpec("a/b", points=np.zeros((4, 3)))

    def test_registry_roundtrip_and_sorted_names(self):
        reg = TenantRegistry()
        reg.add("zeta", "engine-z")
        reg.add("alpha", "engine-a")
        assert reg.get("alpha") == "engine-a"
        assert reg.names() == ["alpha", "zeta"]
        assert "zeta" in reg and "nope" not in reg
        assert len(reg) == 2

    def test_unknown_tenant_raises_keyerror_subclass(self):
        with pytest.raises(UnknownTenantError):
            TenantRegistry().get("stranger")
        assert issubclass(UnknownTenantError, KeyError)


# -------------------------------------------------------------- quotas


class TestTenantQuotas:
    def _quotas(self, global_rows=100, **kw):
        ctrl = AdmissionController(max_queue_rows=global_rows)
        return ctrl, TenantQuotas(ctrl, **kw)

    def test_over_quota_rejects_with_retry_after(self):
        _ctrl, q = self._quotas(quotas={"a": 10}, retry_after_s=0.25)
        q.admit("a", 8)
        with pytest.raises(OverloadError, match="over quota") as e:
            q.admit("a", 8)  # 8 + 8 > 10
        assert e.value.retry_after_s == pytest.approx(0.25)
        assert q.stats()["tenants"]["a"]["rejected"] == 1
        assert q.stats()["tenants"]["a"]["inflight_rows"] == 8
        q.release("a", 8)
        assert q.stats()["tenants"]["a"]["inflight_rows"] == 0

    def test_zero_quota_means_unsliced_global_cap_only(self):
        _ctrl, q = self._quotas(global_rows=20)
        q.admit("free", 20)
        with pytest.raises(OverloadError, match="queue full"):
            q.admit("free", 1)
        q.release("free", 20)

    def test_global_reject_rolls_back_tenant_reservation(self):
        ctrl, q = self._quotas(global_rows=10, quotas={"a": 50})
        ctrl.admit(8)
        with pytest.raises(OverloadError):
            q.admit("a", 8)  # under its quota, over the GLOBAL cap
        assert q.stats()["tenants"]["a"]["inflight_rows"] == 0
        q.admit("a", 2)
        q.release("a", 2)
        ctrl.release(8)

    def test_one_tenant_cannot_starve_another(self):
        _ctrl, q = self._quotas(global_rows=100, default_quota_rows=60)
        q.admit("hog", 60)
        with pytest.raises(OverloadError, match="over quota"):
            q.admit("hog", 1)
        q.admit("quiet", 40)
        q.release("hog", 60)
        q.release("quiet", 40)

    def test_set_quota_and_context_manager(self):
        ctrl, q = self._quotas()
        q.set_quota("a", 5)
        assert q.quota("a") == 5 and q.quota("b") == 0
        with q.admitted_rows("a", 5):
            assert q.stats()["tenants"]["a"]["inflight_rows"] == 5
        assert q.stats()["tenants"]["a"]["inflight_rows"] == 0
        assert ctrl.inflight_rows() == 0


# ----------------------------------------------- shared pool (fake engines)


class _FakeEngine:
    def __init__(self, key, rows, device_bytes):
        self.key = key
        self.host_points = rows
        self.device_bytes = device_bytes


class _TenantPoolRig:
    """A multi-tenant SlabPool over fakes: two tenants, a counter clock,
    a (tenant, slab) build log."""

    def __init__(self, slab_bytes=100, build_cost=0.5, **pool_kw):
        self.now = [0.0]
        self.built = []
        self.pool = SlabPool(clock=lambda: self.now[0], **pool_kw)

        def mk_factory(tenant):
            def factory(slab, rows, begin):
                self.now[0] += build_cost
                self.built.append((tenant, slab))
                return _FakeEngine((tenant, slab), rows, slab_bytes)
            return factory

        for i, tenant in enumerate(("hot", "cold")):
            n = 40 + 8 * i
            src = SlabSource(points=np.arange(n * 3, dtype=np.float32)
                             .reshape(n, 3), num_slabs=4)
            self.pool.register(tenant, src, mk_factory(tenant))
            setattr(self, f"{tenant}_src", src)


class TestSharedPoolTenancy:
    def test_tuple_keys_route_to_each_tenants_source(self):
        rig = _TenantPoolRig()
        e_hot = rig.pool.ensure(("hot", 0))
        e_cold = rig.pool.ensure(("cold", 0))
        assert e_hot.key == ("hot", 0) and e_cold.key == ("cold", 0)
        assert e_hot.host_points.tobytes() == rig.hot_src.read(0).tobytes()
        assert (e_cold.host_points.tobytes()
                == rig.cold_src.read(0).tobytes())
        assert rig.built == [("hot", 0), ("cold", 0)]
        rig.pool.close()

    def test_per_tenant_accounting_in_stats(self):
        p = _TenantPoolRig(device_budget_bytes=200).pool  # 2 slabs
        p.ensure(("hot", 0))
        p.ensure(("hot", 0))
        p.ensure(("cold", 0))
        p.ensure(("cold", 1))  # evicts hot/0
        s = p.stats()
        assert s["num_slabs"] == 8
        t = s["tenants"]
        assert t["hot"]["promotions"] == 1 and t["hot"]["device_hits"] == 1
        assert t["hot"]["evictions"] == 1 and t["hot"]["device_resident"] == 0
        assert t["cold"]["promotions"] == 2 and t["cold"]["evictions"] == 0
        assert t["cold"]["device_resident"] == 2
        stalls, secs = p.stall_totals()
        h = p.stall_totals(tenant="hot")
        c = p.stall_totals(tenant="cold")
        assert h[0] + c[0] == stalls
        assert h[1] + c[1] == pytest.approx(secs)
        p.close()

    def test_eviction_fairness_hot_pages_survive_cold_churn(self):
        rig = _TenantPoolRig(device_budget_bytes=300)  # 3 slabs
        p = rig.pool
        p.ensure(("hot", 0))
        for slab in (0, 1, 2, 3, 0, 1, 2, 3):
            rig.now[0] += 1.0
            p.ensure(("cold", slab))
            rig.now[0] += 1.0
            p.ensure(("hot", 0))
        assert ("hot", 0) in p.resident_slabs()
        t = p.stats()["tenants"]
        assert t["hot"]["promotions"] == 1 and t["hot"]["evictions"] == 0
        assert t["cold"]["evictions"] >= 4
        p.close()

    def test_pins_and_prefetch_use_tuple_keys(self):
        p = _TenantPoolRig(device_budget_bytes=100).pool  # 1 slab
        p.pin([("hot", 2)])
        p.ensure(("hot", 2))
        p.ensure(("cold", 3))  # the pinned page overcommits
        assert ("hot", 2) in p.resident_slabs()
        assert p.stats()["overcommits"] == 1
        p.unpin([("hot", 2)])
        p.prefetch([("cold", 1)])
        assert p.wait_idle(timeout_s=10)
        assert p.stats()["tenants"]["cold"]["prefetch_enqueued"] == 1
        p.close()


# ------------------------------------------------------ multi-tenant engine


@pytest.fixture(scope="module")
def tenancy_rig():
    """Three tenants behind one pool in each package, and the port's
    single-tenant streaming twin of each."""
    points = {n: _tenant_points(i) for i, n in enumerate(NAMES)}
    jax = JaxMultiTenant(
        [JaxSpec(n, points=points[n], num_slabs=3) for n in NAMES],
        k=K, mesh=get_mesh(2), prefetch_depth=0, engine="tiled", **KW)
    jax.warmup()
    port = MultiTenantEngine(
        [TenantSpec(n, points=points[n], num_slabs=3) for n in NAMES],
        k=K, num_shards=2, prefetch_depth=0, engine="pallas_tiled",
        device="cpu", **KW)
    warm = port.warmup()
    twins = {n: StreamingKnnEngine(points=points[n], num_slabs=3, k=K,
                                   num_shards=2, prefetch_depth=0,
                                   engine="pallas_tiled", device="cpu", **KW)
             for n in NAMES}
    for t in twins.values():
        t.warmup()
    yield points, jax, port, warm, twins
    for t in twins.values():
        t.close()
    jax.close()
    port.close()


def _probes(pts, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((9, 3)).astype(np.float32), pts[:1], pts[31:48]]


class TestMultiTenantEngine:
    def test_per_tenant_bitwise_parity_across_budgets(self, tenancy_rig):
        """Every tenant through the shared pool: the JAX multi-tenant
        engine's bytes and the port's single-tenant twin's, at budgets {1
        slab, 4 slabs, everything}."""
        points, jax, port, _warm, twins = tenancy_rig
        for budget_slabs in (1, 4, 0):  # 0 = unbounded
            port.slab_pool.set_device_budget(
                port.slab_device_bytes * budget_slabs)
            jax.slab_pool.set_device_budget(
                jax.slab_device_bytes * budget_slabs)
            for i, n in enumerate(NAMES):
                for q in _probes(points[n], seed=7 + i):
                    got = port.query(q, tenant=n)
                    _same(got, jax.query(q, tenant=n))
                    _same(got, twins[n].query(q))
        port.slab_pool.set_device_budget(0)
        jax.slab_pool.set_device_budget(0)

    def test_compile_count_flat_across_tenants(self, tenancy_rig):
        points, jax, port, warm, twins = tenancy_rig
        single = twins[NAMES[0]].stats()["compile_count"]
        assert 0 < warm["compile_count"] <= single
        assert warm["compile_count"] == jax.stats()["compile_count"]
        before = port.stats()["compile_count"]
        for n in NAMES:
            port.query(points[n][:5], tenant=n)
        assert port.stats()["compile_count"] == before

    def test_resolve_and_unknown_tenant(self, tenancy_rig):
        points, _jax, port, _warm, _twins = tenancy_rig
        assert port.default_tenant == NAMES[0]
        name, eng = port.resolve(None)
        assert name == NAMES[0] and eng.n_points == len(points[NAMES[0]])
        with pytest.raises(UnknownTenantError):
            port.resolve("stranger")
        with pytest.raises(UnknownTenantError):
            port.query(points[NAMES[0]][:2], tenant="stranger")

    def test_dispatch_handle_carries_tenant_namespace(self, tenancy_rig):
        points, _jax, port, _warm, twins = tenancy_rig
        q = points[NAMES[2]][:4]
        h = port.dispatch(q, tenant=NAMES[2])
        assert h.tenant == NAMES[2] and h.n == 4
        _same(port.complete(h), twins[NAMES[2]].query(q))

    def test_stats_carry_per_tenant_namespace(self, tenancy_rig):
        points, jax, port, _warm, _twins = tenancy_rig
        s = port.stats()
        assert s["n_points"] == sum(len(points[n]) for n in NAMES)
        assert s["default_tenant"] == NAMES[0]
        assert sorted(s["tenants"]) == NAMES
        for n in NAMES:
            t = s["tenants"][n]
            assert t["n_points"] == len(points[n])
            assert t["num_slabs"] == 3 and t["k"] == K
        assert set(s) == set(jax.stats())


# ------------------------------------------------------------ HTTP surface


def _start(mod, engine):
    srv = mod.build_server(engine, port=0, max_delay_s=0.002)
    srv.ready = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def servers(tenancy_rig):
    _points, jax, port, _warm, _twins = tenancy_rig
    pair = (_start(j_server, jax), _start(t_server, port))
    yield pair
    for srv in pair:
        srv.close()


def _request(srv, path, body=None, ctype="application/json", headers=()):
    """(status, content type, Retry-After, X-Knn-Tenant, body bytes)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}{path}", data=body,
        headers=dict(({} if body is None else {"Content-Type": ctype}),
                     **dict(headers)))
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            h, status, out = resp.headers, resp.status, resp.read()
    except urllib.error.HTTPError as e:
        h, status, out = e.headers, e.code, e.read()
    return (status, h["Content-Type"], h["Retry-After"], h["X-Knn-Tenant"],
            out)


def _both(servers, path, body=None, ctype="application/json", headers=()):
    jr, pr = (_request(s, path, body, ctype, headers) for s in servers)
    assert pr == jr, (path, jr, pr)
    return pr


def _json(q, **kw):
    return json.dumps(dict(queries=np.asarray(q).tolist(), **kw)).encode()


BIN = "application/octet-stream"


class TestTenancyHTTP:
    def test_v1_route_serves_that_tenants_index(self, tenancy_rig,
                                                servers):
        points, _jax, _port, _warm, twins = tenancy_rig
        for n in NAMES:
            q = points[n][:6]
            r = _both(servers, f"/v1/{n}/knn", _json(q, neighbors=True))
            assert r[0] == 200
            resp = json.loads(r[4])
            dt, nt = twins[n].query(q)
            assert np.asarray(resp["dists"], np.float32).tobytes() \
                == dt.tobytes()
            assert np.array_equal(np.asarray(resp["neighbors"]), nt)
            assert resp["tenant"] == n
            r = _both(servers, f"/v1/{n}/knn", q.astype("<f4").tobytes(),
                      BIN)
            assert r[0] == 200 and r[3] == n and r[4] == dt.tobytes()

    def test_legacy_route_is_the_default_tenant_bytes(self, tenancy_rig,
                                                      servers):
        points, _jax, _port, _warm, _twins = tenancy_rig
        q = points[NAMES[0]][:5]
        legacy = _both(servers, "/knn", _json(q, neighbors=True))
        explicit = _both(servers, f"/v1/{NAMES[0]}/knn",
                         _json(q, neighbors=True))
        assert legacy == explicit

    def test_header_and_json_field_route_like_the_url(self, tenancy_rig,
                                                      servers):
        points, _jax, _port, _warm, _twins = tenancy_rig
        n = NAMES[2]
        q = points[n][:4]
        via_url = _both(servers, f"/v1/{n}/knn", _json(q, neighbors=True))
        via_field = _both(servers, "/knn", _json(q, neighbors=True,
                                                  tenant=n))
        via_header = _both(servers, "/knn", _json(q, neighbors=True),
                           headers={"X-Knn-Tenant": n})
        assert via_field == via_url == via_header
        # the URL wins over the field; binary rides the header
        via_both = _both(servers, f"/v1/{n}/knn",
                         _json(q, neighbors=True, tenant=NAMES[1]))
        assert via_both == via_url
        _both(servers, "/knn", q.astype("<f4").tobytes(), BIN,
              headers={"X-Knn-Tenant": n})

    def test_unknown_tenant_404_lists_tenants(self, tenancy_rig, servers):
        points, _jax, _port, _warm, _twins = tenancy_rig
        q = points[NAMES[0]][:2]
        r = _both(servers, "/v1/stranger/knn", _json(q))
        assert r[0] == 404
        body = json.loads(r[4])
        assert "no such tenant" in body["error"]
        assert body["tenants"] == NAMES
        assert _both(servers, "/knn", _json(q, tenant="stranger"))[0] == 404

    def test_quota_429_with_retry_after(self, tenancy_rig, servers):
        points, _jax, _port, _warm, _twins = tenancy_rig
        n = NAMES[1]
        for srv in servers:
            srv.quotas.set_quota(n, 3)
        try:
            r = _both(servers, f"/v1/{n}/knn", _json(points[n][:8]))
            assert r[0] == 429 and float(r[2]) > 0
            assert "over quota" in json.loads(r[4])["error"]
            # other tenants are untouched, and n serves under its cap
            assert _both(servers, f"/v1/{NAMES[0]}/knn",
                         _json(points[NAMES[0]][:8]))[0] == 200
            assert _both(servers, f"/v1/{n}/knn",
                         _json(points[n][:3]))[0] == 200
        finally:
            for srv in servers:
                srv.quotas.set_quota(n, 0)
        for srv in servers:
            st = json.loads(_request(srv, f"/v1/{n}/stats")[4])
            assert st["quota"]["rejected"] >= 1

    def test_stats_has_per_tenant_namespace(self, servers):
        stats = json.loads(_request(servers[1], "/stats")[4])
        jstats = json.loads(_request(servers[0], "/stats")[4])
        assert sorted(stats["tenants"]) == NAMES
        assert set(stats) == set(jstats)
        for n in NAMES:
            block = stats["tenants"][n]
            assert set(block) == set(jstats["tenants"][n])
            assert "request_latency" in block["server"]
            assert set(block["quota"]) >= {"quota_rows", "inflight_rows",
                                           "rejected"}

    def test_per_tenant_stats_route(self, tenancy_rig, servers):
        points, _jax, _port, _warm, _twins = tenancy_rig
        st = json.loads(_request(servers[1], f"/v1/{NAMES[1]}/stats")[4])
        assert st["tenant"] == NAMES[1]
        assert st["engine"]["n_points"] == len(points[NAMES[1]])
        r = _both(servers, "/v1/stranger/stats")
        assert r[0] == 404 and json.loads(r[4])["tenants"] == NAMES

    def test_metrics_carry_tenant_labels(self, tenancy_rig, servers):
        points, _jax, _port, _warm, _twins = tenancy_rig
        for n in NAMES:
            _both(servers, f"/v1/{n}/knn", _json(points[n][:2]))
        m = _request(servers[1], "/metrics")[4].decode()
        jm = _request(servers[0], "/metrics")[4].decode()
        for n in NAMES:
            assert f'knn_requests_total{{tenant="{n}"}}' in m
            assert f'knn_slab_pool_tenant_resident{{tenant="{n}"' in m
            assert f'knn_tenant_quota_rows{{tenant="{n}"}}' in m
        assert 'knn_slab_tenant_promotions_total{tenant="' in m
        assert "\nknn_requests_total " in "\n" + m

        def labelled(text):
            return {line.split(" ")[0] for line in text.splitlines()
                    if 'tenant="' in line
                    or line.startswith(("knn_slab", "knn_stream"))}

        assert labelled(m) == labelled(jm)

    def test_single_index_server_shows_no_tenant_surface(self,
                                                         tenancy_rig):
        points, _jax, _port, _warm, twins = tenancy_rig
        srv = _start(t_server, twins[NAMES[0]])
        try:
            q = _json(points[NAMES[0]][:3])
            assert _request(srv, "/knn", q)[0] == 200
            assert _request(srv, f"/v1/{NAMES[0]}/knn", q)[0] == 404
            assert "tenants" not in json.loads(_request(srv, "/stats")[4])
            assert srv.quotas is None
            assert '{tenant="' not in _request(srv, "/metrics")[4].decode()
        finally:
            srv.close()


# ------------------------------------------------------------ serving CLI


def _run_cli(argv):
    """``serve_main.main(argv)`` in a thread: (server, thread, rc list)."""
    import queue

    from mpi_cuda_largescaleknn_torch.cli import serve_main

    ready, rc = queue.Queue(), []
    th = threading.Thread(target=lambda: rc.append(serve_main.main(
        argv, ready=ready.put)), daemon=True)
    th.start()
    return ready.get(timeout=300), th, rc


def _stop(srv, th, rc):
    srv.shutdown()
    th.join(timeout=60)
    assert not th.is_alive() and rc == [0]


def test_serve_main_streams_slabs(tmp_path):
    """``--num-slabs 4 --device-slab-budget`` of one slab: answers equal
    the port's resident engine over the same file, the pool churns."""
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine

    pts = np.sort(random_points(800, seed=12), axis=0)
    path = tmp_path / "pts.float3"
    pts.tofile(path)
    probe = StreamingKnnEngine(str(path), num_slabs=4, k=K, device="cpu",
                               engine="pallas_tiled", max_batch=64)
    budget = probe.slab_device_bytes
    probe.close()
    srv, th, rc = _run_cli([str(path), "-k", str(K), "--port", "0",
                            "--device", "cpu", "--max-batch", "64",
                            "--num-slabs", "4", "--device-slab-budget",
                            str(budget), "--host-pool-slabs", "2",
                            "--prefetch-depth", "0"])
    try:
        ref = ResidentKnnEngine(pts, K, device="cpu", max_batch=64)
        for seed in (1, 2):
            q = random_points(20, seed=seed)
            r = _request(srv, "/knn", _json(q, neighbors=True))
            resp = json.loads(r[4])
            dr, nr = ref.query(q)
            assert np.asarray(resp["dists"], np.float32).tobytes() \
                == dr.tobytes()
            assert np.array_equal(np.asarray(resp["neighbors"]), nr)
        pool = srv.engine.stats()["slab_pool"]
        assert pool["device_budget_bytes"] == budget
        assert pool["promotions"] > 1 and pool["evictions"] > 0
        m = _request(srv, "/metrics")[4].decode()
        assert "knn_slab_promotions_total" in m and 'tenant="' not in m
    finally:
        _stop(srv, th, rc)


def test_serve_main_serves_tenants(tmp_path):
    """Two ``--tenant NAME=PATH`` flags (a ``.float3`` and a ``.npy``),
    ``--num-slabs 2``, ``--tenant-quota-rows``: each tenant's answers its
    own streaming twin's bytes, legacy ``/knn`` the first tenant's, the
    quota a 429."""
    paths = {}
    for i, (n, ext) in enumerate((("a", "float3"), ("b", "npy"))):
        pts = _tenant_points(i, n=300)
        paths[n] = tmp_path / f"{n}.{ext}"
        if ext == "npy":
            np.save(paths[n], pts)
        else:
            pts.tofile(paths[n])
    srv, th, rc = _run_cli(["-k", str(K), "--port", "0", "--device", "cpu",
                            "--max-batch", "32", "--num-slabs", "2",
                            "--tenant", f"a={paths['a']}",
                            "--tenant", f"b={paths['b']}",
                            "--tenant-quota-rows", "16"])
    try:
        assert srv.tenants.names() == ["a", "b"]
        q = random_points(10, seed=5)
        for n in ("a", "b"):
            twin = StreamingKnnEngine(str(paths[n]), num_slabs=2, k=K,
                                      device="cpu", max_batch=32)
            r = _request(srv, f"/v1/{n}/knn", _json(q, neighbors=True))
            resp = json.loads(r[4])
            _same((np.asarray(resp["dists"], np.float32),
                   np.asarray(resp["neighbors"], np.int32)), twin.query(q))
            twin.close()
        legacy = _request(srv, "/knn", _json(q, neighbors=True))
        assert legacy == _request(srv, "/v1/a/knn", _json(q, neighbors=True))
        r = _request(srv, "/v1/b/knn", _json(random_points(20, seed=6)))
        assert r[0] == 429 and float(r[2]) > 0
        r = _request(srv, "/v1/c/knn", _json(q))
        assert r[0] == 404 and json.loads(r[4])["tenants"] == ["a", "b"]
    finally:
        _stop(srv, th, rc)
