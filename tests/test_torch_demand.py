"""The port's flat ring and pre-partitioned pipeline against the JAX package
on the CPU: ``ring_knn(engine="pallas")`` at R=1 and R=4, ``demand_knn``
through ``PrePartitionedKNN`` at R=4 and R=8 for both engine families, and
the pre-partitioned CLI's rank files. Distances bitwise, ids equal on real
rows, and the demand stats ``rounds``, ``kernels_run`` and
``rotations_run`` equal. The demand rounds' order at R=4 and R=5, stepwise
and chunked: each heap's folds those of a per-shard replay that reads the
radius after every fold, and no radius read between two folds of one
direction. The JAX side runs its Pallas kernels in interpret
mode under explicit engine names (its ``auto`` means the XLA twin off a
TPU)."""

import json
import math

import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import kth_neighbor_distances as torch_knn
from mpi_cuda_largescaleknn_torch.cli import partition_main as torch_part_cli
from mpi_cuda_largescaleknn_torch.cli import (
    prepartitioned_main as torch_pre_cli,
)
from mpi_cuda_largescaleknn_torch.cli import unordered_main as torch_cli
from mpi_cuda_largescaleknn_torch.core.config import KnnConfig as TConfig
from mpi_cuda_largescaleknn_torch.core.types import (
    CandidateState,
    aabb_box_distance,
    aabb_of_points,
)
from mpi_cuda_largescaleknn_torch.models.prepartitioned import (
    PrePartitionedKNN as TPre,
)
from mpi_cuda_largescaleknn_torch.models.sharding import pad_and_flatten
from mpi_cuda_largescaleknn_torch.ops.candidates import current_worst_radius
from mpi_cuda_largescaleknn_torch.parallel import demand as tdemand
from mpi_cuda_largescaleknn_torch.parallel.ring import ring_knn as t_ring
from mpi_cuda_largescaleknn_tpu.cli import prepartitioned_main as jax_pre_cli
from mpi_cuda_largescaleknn_tpu.cli import unordered_main as jax_cli
from mpi_cuda_largescaleknn_tpu.core import types as jtypes
from mpi_cuda_largescaleknn_tpu.core.config import KnnConfig as JConfig
from mpi_cuda_largescaleknn_tpu.models.prepartitioned import (
    PrePartitionedKNN as JPre,
)
from mpi_cuda_largescaleknn_tpu.ops import candidates as jcand
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from mpi_cuda_largescaleknn_tpu.parallel.ring import ring_knn as j_ring
from tests.oracle import kth_nn_dist, random_points
from tests.test_torch_ops import assert_bitwise

TILES = {"query_tile": 64, "point_tile": 128}


@pytest.fixture(autouse=True)
def one_fold_segment(monkeypatch):
    # k >= 32 ids: the Pallas multi-segment fold breaks lane order on exact
    # ties (ROADMAP.md Queue 3); the port keeps lane order
    monkeypatch.setenv("LSK_FOLD_SEGS", "1")


def separated(num, n_each, gap, seed):
    """Clusters side by side: cluster i spans [i*gap, i*gap + 1] in x."""
    out = []
    for i in range(num):
        p = random_points(n_each, seed=seed + i)
        p[:, 0] += i * gap
        out.append(p)
    return out


@pytest.mark.parametrize("num_shards,k,radius", [
    (1, 8, math.inf), (1, 40, 0.3), (4, 8, math.inf), (4, 5, 0.08)])
def test_flat_ring_matches_jax(num_shards, k, radius):
    pts = random_points(410, seed=num_shards + k)
    bounds = [(410 * r // num_shards, 410 * (r + 1) // num_shards)
              for r in range(num_shards)]
    flat, ids, counts, npad = pad_and_flatten(
        [pts[b:e] for b, e in bounds], [b for b, _ in bounds], 3)
    want_d, want_c, want_s = j_ring(flat, ids, k, get_mesh(num_shards),
                                    max_radius=radius, engine="pallas",
                                    return_candidates=True,
                                    return_stats=True, **TILES)
    got_d, got_c, got_s = t_ring(flat, ids, k, num_shards,
                                 max_radius=radius, engine="pallas",
                                 device="cpu", return_candidates=True,
                                 return_stats=True, **TILES)
    real = ids >= 0
    assert_bitwise(got_d.numpy()[real], np.asarray(want_d)[real])
    assert_bitwise(got_c.dist2.numpy()[real], np.asarray(want_c.dist2)[real])
    assert_bitwise(got_c.idx.numpy()[real], np.asarray(want_c.idx)[real])
    assert got_s == {k_: want_s[k_] for k_ in got_s}


@pytest.mark.parametrize("num_shards", [1, 3])
def test_flat_engine_gives_the_traversal_distances(num_shards):
    pts = random_points(350, seed=num_shards)
    tiled = torch_knn(pts, 6, num_shards=num_shards, bucket_size=16,
                      device="cpu")
    flat = torch_knn(pts, 6, num_shards=num_shards, engine="pallas",
                     device="cpu", **TILES)
    assert_bitwise(flat, tiled)


def test_unordered_cli_flat_engine_is_byte_identical(tmp_path):
    pts = random_points(300, seed=31)
    src = tmp_path / "pts.float3"
    pts.tofile(src)
    common = [str(src), "-k", "7", "--engine", "pallas", "--shards", "4",
              "--query-tile", "64", "--point-tile", "128"]
    assert jax_cli.main(common + ["-o", str(tmp_path / "j.float"),
                                  "--write-indices",
                                  str(tmp_path / "j.int32")]) == 0
    assert torch_cli.main(common + ["-o", str(tmp_path / "t.float"),
                                    "--write-indices",
                                    str(tmp_path / "t.int32"),
                                    "--device", "cpu"]) == 0
    for ext in ("float", "int32"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def layout(name, num_shards):
    """(partitions, k, max_radius) for one named pre-partitioned layout."""
    if name == "overlapping":
        return [random_points(48, seed=10 + i)
                for i in range(num_shards)], 8, math.inf
    if name == "disjoint":
        return separated(num_shards, 40, 10.0, 0), 4, math.inf
    if name == "adjacent":
        return separated(num_shards, 60, 0.85, 60), 8, math.inf
    if name == "uneven_empty":
        sizes = [50, 0, 75, 10, 33, 0, 1, 64][:num_shards]
        return [random_points(n, seed=20 + i)
                for i, n in enumerate(sizes)], 5, math.inf
    if name == "radius":
        return separated(num_shards, 36, 5.0, 40), 30, 0.25
    if name == "twins":
        # shards 2m and 2m+1 share a box, pairs 0.5 apart: a shard's
        # backward visit turns on the radius its forward fold left
        parts = [random_points(48, seed=90 + i) for i in range(num_shards)]
        for i, p in enumerate(parts):
            p[:, 0] += (i // 2) * 1.5
        return parts, 8, math.inf
    raise ValueError(name)


LAYOUTS = ["overlapping", "disjoint", "adjacent", "uneven_empty", "radius",
           "twins"]


@pytest.mark.parametrize("engine", ["pallas_tiled", "pallas"])
@pytest.mark.parametrize("num_shards", [4, 8])
@pytest.mark.parametrize("name", LAYOUTS)
def test_demand_matches_jax(name, num_shards, engine):
    parts, k, radius = layout(name, num_shards)
    jm = JPre(JConfig(k=k, max_radius=radius, engine=engine, bucket_size=16,
                      **TILES), mesh=get_mesh(num_shards))
    want_d, want_i = jm.run(parts, return_neighbors=True)
    tm = TPre(TConfig(k=k, max_radius=radius, engine=engine, bucket_size=16,
                      num_shards=0, device="cpu", **TILES))
    got_d, got_i = tm.run(parts, return_neighbors=True)
    for g, w in zip(got_d, want_d):
        assert_bitwise(g, np.asarray(w))
    for g, w in zip(got_i, want_i):
        assert_bitwise(g, np.asarray(w))
    assert tm.last_stats == {key: jm.last_stats[key] for key in
                             ("rounds", "kernels_run", "rotations_run")}
    allp = np.concatenate(parts)
    np.testing.assert_allclose(np.concatenate(got_d),
                               kth_nn_dist(allp, allp, k, radius),
                               rtol=5e-7, atol=1e-37)


class RoundSpy:
    """Wraps the demand ring's pieces for one run: for each query side
    (the run, or each chunk) its context, residents and starting rows,
    and one event log in launch order of each round's start ("round", r),
    each fold ("fold", shard, source shard, skip_self) and each shard's
    radius read ("radius", shard)."""

    def __init__(self, monkeypatch):
        self.sides = []
        real_make = tdemand._make_demand_fns
        real_fold = tdemand.knn_update_tiled_cuda
        real_radius = tdemand.current_worst_radius

        def make(*args, **kwargs):
            shard_init, query_init, rows_fn, round_fn, final_fn = \
                real_make(*args, **kwargs)

            def query_init_spy(resident, *a, **kw):
                ctx = query_init(resident, *a, **kw)
                self.sides.append({"ctx": ctx, "resident": resident,
                                   "log": []})
                return ctx

            def rows_spy(ctx):
                self.sides[-1]["rows"] = rows_fn(ctx)
                return self.sides[-1]["rows"]

            def round_spy(ctx, ring, heaps, rnd, counts):
                self.sides[-1]["log"].append(("round", rnd))
                return round_fn(ctx, ring, heaps, rnd, counts)
            return shard_init, query_init_spy, rows_spy, round_spy, final_fn

        def fold(state, q, p, **kw):
            side = self.sides[-1]
            side["log"].append(("fold", _index(side["ctx"].stationary, q),
                                _index(side["resident"], p),
                                kw["skip_self"]))
            self.self_group = kw["self_group"]
            return real_fold(state, q, p, **kw)

        def radius(state, valid):
            side = self.sides[-1]
            side["log"].append(("radius",
                                _index(side["ctx"].heap_valid, valid)))
            return real_radius(state, valid)

        self.fold, self.radius = real_fold, real_radius
        monkeypatch.setattr(tdemand, "_make_demand_fns", make)
        monkeypatch.setattr(tdemand, "knn_update_tiled_cuda", fold)
        monkeypatch.setattr(tdemand, "current_worst_radius", radius)

    def replay(self, side, warm):
        """Each heap's folds (source shard, skip_self) as a loop over the
        shards one at a time gives them, reading a shard's radius after
        each of its folds, for as many rounds as the side ran."""
        ctx, num = side["ctx"], len(side["rows"])
        rounds = sum(e[0] == "round" for e in side["log"])
        out = []
        for j, heap in enumerate(side["rows"]):
            seq = []

            def visit(heap, src, skip):
                seq.append((src, skip))
                heap = self.fold(heap, ctx.stationary[j],
                                 side["resident"][src], skip_self=skip,
                                 self_group=self.self_group)
                return heap, self.radius(heap, ctx.heap_valid[j]).item()
            rad = self.radius(heap, ctx.heap_valid[j]).item()
            for r in range(rounds):
                src_f, src_b = (j - r) % num, (j + r) % num
                if ctx.box_dist[j, src_f] < rad:
                    heap, rad = visit(heap, src_f, warm and r == 0)
                if src_b != src_f and ctx.box_dist[j, src_b] < rad:
                    heap, rad = visit(heap, src_b, False)
            out.append(seq)
        return out


def _index(items, item) -> int:
    return next(i for i, x in enumerate(items) if x is item)


def _rounds_of(log):
    """The log cut at each round's start: [[event, ...], ...]."""
    out = []
    for event in log:
        if event[0] == "round":
            out.append([])
        else:
            out[-1].append(event)
    return out


@pytest.mark.parametrize("chunk", [0, 24], ids=["stepwise", "chunked"])
@pytest.mark.parametrize("num_shards", [5, 4])
@pytest.mark.parametrize("name", LAYOUTS)
def test_demand_folds_each_direction_back_to_back(monkeypatch, name,
                                                  num_shards, chunk):
    # every heap sees the folds of a loop that reads its radius after each
    # fold, while a round reads no radius between two folds of a direction
    parts, k, radius = layout(name, num_shards)
    spy = RoundSpy(monkeypatch)
    cfg = dict(k=k, max_radius=radius, engine="pallas_tiled", bucket_size=16,
               query_chunk=chunk, **TILES)
    tm = TPre(TConfig(num_shards=0, device="cpu", **cfg))
    got_d, got_i = tm.run(parts, return_neighbors=True)
    assert len(spy.sides) == len(tm.last_stats.get("rounds_per_chunk", [0]))
    waits = 0
    for side in spy.sides:
        log = side["log"]
        folds = [[] for _ in range(num_shards)]
        for e in log:
            if e[0] == "fold":
                folds[e[1]].append(e[2:])
        assert folds == spy.replay(side, warm=chunk == 0)
        for r, events in enumerate(_rounds_of(log)):
            kinds = ["radius" if e[0] == "radius" else
                     "fwd" if e[2] == (e[1] - r) % num_shards else "bwd"
                     for e in events]
            for kind in ("fwd", "bwd"):
                at = [i for i, x in enumerate(kinds) if x == kind]
                assert not at or kinds[at[0]:at[-1] + 1] == [kind] * len(at)
            # a read is a run of radius events: at most the entry radii,
            # then one after each direction's folds
            runs = sum(x == "radius" and (i == 0 or kinds[i - 1] != x)
                       for i, x in enumerate(kinds))
            assert runs <= (3 if r == 0 else 2), kinds
            waits += runs
    assert tm.timers.counters["demand_radius_reads"] == waits
    jm = JPre(JConfig(**cfg), mesh=get_mesh(num_shards))
    want_d, want_i = jm.run(parts, return_neighbors=True)
    for g, w in zip(got_d, want_d):
        assert_bitwise(g, np.asarray(w))
    for g, w in zip(got_i, want_i):
        assert_bitwise(g, np.asarray(w))
    assert tm.last_stats == {key: jm.last_stats[key]
                             for key in tm.last_stats}


@pytest.mark.parametrize("engine,rotations", [("auto", 0), ("pallas", 2)])
def test_demand_early_exit_on_disjoint_clusters(engine, rotations):
    # every heap is full after its own shard and every other box is beyond
    # its radius: one round, one kernel per shard. The warm-started tiled
    # engine enters round 0 with a finite radius and rotates nothing; the
    # flat engine enters it with empty rows (radius inf), so both
    # directions count as rotated
    parts = separated(8, 100, 10.0, 0)
    model = TPre(TConfig(k=4, engine=engine, bucket_size=16, num_shards=8,
                         device="cpu"))
    model.run(parts)
    assert model.last_stats == {"rounds": 1, "kernels_run": [1] * 8,
                                "rotations_run": [rotations] * 8}


def test_demand_gates_rotations_on_adjacent_clusters():
    # the JAX package's own expectation (tests/test_demand.py): each shard
    # needs its +-1 neighbours only, so both directions rotate in round 0
    # and neither in round 1
    parts = separated(8, 200, 0.85, 60)
    model = TPre(TConfig(k=8, bucket_size=16, num_shards=0, device="cpu"))
    model.run(parts)
    st = model.last_stats
    assert st["rounds"] == 2 and st["rotations_run"] == [2] * 8, st
    assert all(2 <= n <= 3 for n in st["kernels_run"]), st


def test_partition_count_must_match_the_shard_count(tmp_path):
    with pytest.raises(ValueError, match="does not match"):
        TPre(TConfig(k=2, num_shards=4, device="cpu")).run(
            [random_points(10)] * 3)
    lst = tmp_path / "files.txt"
    names = []
    for r in range(3):
        random_points(20, seed=r).tofile(tmp_path / f"p{r}.float3")
        names.append(str(tmp_path / f"p{r}.float3"))
    lst.write_text("\n".join(names) + "\n")
    with pytest.raises(RuntimeError, match="does not match"):
        torch_pre_cli.main([str(lst), "-k", "2", "-o", str(tmp_path / "o"),
                            "--shards", "2", "--device", "cpu"])


@pytest.mark.parametrize("engine", ["pallas_tiled", "pallas"])
def test_prepartitioned_cli_rank_files_match_jax(tmp_path, engine, capsys):
    src = tmp_path / "pts.float3"
    random_points(500, seed=41).tofile(src)
    assert torch_part_cli.main([str(src), "-n", "4", "-o",
                                str(tmp_path / "p")]) == 0
    lst = str(tmp_path / "p.txt")
    common = ["-k", "6", "--engine", engine, "--bucket-size", "16",
              "--query-tile", "64", "--point-tile", "128"]
    assert jax_pre_cli.main([lst, "-o", str(tmp_path / "j"),
                             "--write-indices", str(tmp_path / "ji")]
                            + common) == 0
    capsys.readouterr()
    assert torch_pre_cli.main([lst, "-o", str(tmp_path / "t"),
                               "--write-indices", str(tmp_path / "ti"),
                               "--device", "cpu", "--selfcheck", "60",
                               "--timings"] + common) == 0
    captured = capsys.readouterr()
    assert "selfcheck OK (60 samples)" in captured.out
    report = json.loads(captured.err.strip().splitlines()[-1])
    assert {"pad", "demand_ring", "extract", "rounds", "kernels_run",
            "rotations_run", "knn_tiled_launches", "knn_bf_launches",
            "run_seconds", "queries_per_second",
            "peak_device_bytes"} <= set(report)
    assert 1 <= report["rounds"] <= 3 and len(report["kernels_run"]) == 4
    for r in range(4):
        for out, ext in (("t", "float"), ("ti", "int32")):
            got = (tmp_path / f"{out}_{r:06d}.{ext}").read_bytes()
            want = (tmp_path / f"j{out[1:]}_{r:06d}.{ext}").read_bytes()
            assert got == want, (r, ext)


def test_cli_tiles_do_not_change_the_output(tmp_path):
    src = tmp_path / "pts.float3"
    random_points(260, seed=43).tofile(src)
    assert torch_part_cli.main([str(src), "-n", "3", "-o",
                                str(tmp_path / "p")]) == 0
    outs = set()
    for q_tile, p_tile in (("2048", "2048"), ("1", "7"), ("50", "33")):
        tag = f"q{q_tile}p{p_tile}"
        common = ["-k", "5", "--engine", "pallas", "--device", "cpu",
                  "--query-tile", q_tile, "--point-tile", p_tile]
        assert torch_pre_cli.main([str(tmp_path / "p.txt"), "-o",
                                   str(tmp_path / tag)] + common) == 0
        assert torch_cli.main([str(src), "-o", str(tmp_path / f"{tag}.float"),
                               "--shards", "2"] + common) == 0
        outs.add(b"".join((tmp_path / f"{tag}_{r:06d}.float").read_bytes()
                          for r in range(3))
                 + (tmp_path / f"{tag}.float").read_bytes())
    assert len(outs) == 1


def test_prepartitioned_ids_follow_the_partition_order():
    parts = [random_points(30, seed=1), random_points(0, seed=2),
             random_points(45, seed=3)]
    model = TPre(TConfig(k=3, bucket_size=16, num_shards=0, device="cpu"))
    dists, idx = model.run(parts, return_neighbors=True)
    allp = np.concatenate(parts)
    for part, d, ix in zip(parts, dists, idx):
        assert ix.shape == (len(part), 3)
        if len(part):
            got = np.sqrt(((part[:, None, :] - allp[ix]) ** 2).sum(-1))
            np.testing.assert_allclose(got[:, -1], d, rtol=1e-6)


def test_bounds_and_radius_match_jax():
    rng = np.random.default_rng(3)
    lo = rng.random((6, 3), dtype=np.float32) * 5
    hi = lo + rng.random((6, 3), dtype=np.float32) * 3
    lo[2], hi[2] = np.inf, -np.inf                      # an empty box
    want = jtypes.aabb_box_distance(lo[:, None], hi[:, None], lo[None],
                                    hi[None])
    got = aabb_box_distance(torch.from_numpy(lo[:, None]),
                            torch.from_numpy(hi[:, None]),
                            torch.from_numpy(lo[None]),
                            torch.from_numpy(hi[None]))
    assert_bitwise(got.numpy(), np.asarray(want))
    assert np.all(np.isinf(got.numpy()[2])) and got[0, 0] == 0.0

    pts = rng.random((40, 3), dtype=np.float32)
    pts[30:] = 1e30
    wbox = jtypes.aabb_of_points(pts)
    tbox = aabb_of_points(torch.from_numpy(pts))
    assert_bitwise(tbox.lower.numpy(), np.asarray(wbox.lower))
    assert_bitwise(tbox.upper.numpy(), np.asarray(wbox.upper))

    d2 = np.sort(rng.random((40, 5), dtype=np.float32) * 7, axis=1)
    valid = np.arange(40) < 30
    for mask in (None, valid, np.zeros(40, bool)):
        want = jcand.current_worst_radius(
            jtypes.CandidateState(d2, np.zeros((40, 5), np.int32)), mask)
        got = current_worst_radius(
            CandidateState(torch.from_numpy(d2), torch.zeros(40, 5)),
            None if mask is None else torch.from_numpy(mask))
        assert_bitwise(got.numpy(), np.asarray(want))


def test_gathered_bounds_cover_each_shard():
    pts = [torch.from_numpy(random_points(20, seed=s)) for s in range(3)]
    lower, upper = tdemand.gathered_bounds_fn(pts)
    assert lower.shape == (3, 3)
    for r, p in enumerate(pts):
        assert torch.equal(lower[r], p.amin(0))
        assert torch.equal(upper[r], p.amax(0))
