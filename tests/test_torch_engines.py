"""The JAX package's three XLA engines in the port against the JAX
package on the CPU: ``knn_update_tiled`` (``tiled``, the traversal's twin)
with its tile and fold counts, ``knn_update_bruteforce`` (``bruteforce``),
and every pipeline with ``engine`` in {tiled, bruteforce, tree}:
``UnorderedKNN`` at R=1 and R=4, ``PrePartitionedKNN`` on 4 parts, both
CLIs, a chunked run and a stepwise cut-and-resume. Distances bitwise, ids
equal, the work counters equal; rows of padding queries are not compared
(both packages fill them with garbage that ``scatter_back`` and the
slab trim drop). The data is dyadic (multiples of 1/64, so exact ties are
frequent and every squared distance is exact: the JAX package's tree
engine is contracted into fused multiply-adds on XLA:CPU,
``tests/test_torch_tree.py``); bf16 takes tie-free standard-normal
points."""

import importlib
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_largescaleknn_torch import convert
from mpi_cuda_largescaleknn_torch import kth_neighbor_distances as torch_knn
from mpi_cuda_largescaleknn_torch.cli import partition_main as torch_part_cli
from mpi_cuda_largescaleknn_torch.cli import (
    prepartitioned_main as torch_pre_cli,
)
from mpi_cuda_largescaleknn_torch.cli import unordered_main as torch_cli
from mpi_cuda_largescaleknn_torch.core import config as tconfig
from mpi_cuda_largescaleknn_torch.models.prepartitioned import (
    PrePartitionedKNN as TPre,
)
from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN as TUn
from mpi_cuda_largescaleknn_torch.ops import brute_force as tbf
from mpi_cuda_largescaleknn_torch.ops import candidates as tcand
from mpi_cuda_largescaleknn_torch.ops import partition as tpart
from mpi_cuda_largescaleknn_torch.ops import tiled as ttiled
from mpi_cuda_largescaleknn_torch.parallel import demand as tdemand
from mpi_cuda_largescaleknn_torch.parallel import ring as tring
from mpi_cuda_largescaleknn_tpu.cli import prepartitioned_main as jax_pre_cli
from mpi_cuda_largescaleknn_tpu.cli import unordered_main as jax_cli
from mpi_cuda_largescaleknn_tpu.core.config import KnnConfig as JConfig
from mpi_cuda_largescaleknn_tpu.models.prepartitioned import (
    PrePartitionedKNN as JPre,
)
from mpi_cuda_largescaleknn_tpu.models.unordered import UnorderedKNN as JUn
from mpi_cuda_largescaleknn_tpu.parallel import demand as jdemand
from mpi_cuda_largescaleknn_tpu.parallel import ring as jring
from mpi_cuda_largescaleknn_tpu.parallel.mesh import get_mesh
from tests.test_torch_chunked import assert_rows_match, sharded
from tests.test_torch_knn_tiled import assert_rows_equal
from tests.test_torch_ops import assert_bitwise, points

# the JAX package's ops/__init__.py re-exports functions under these
# module names
jbf = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.brute_force")
jcand = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.candidates")
jpart = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.partition")
jtiled = importlib.import_module("mpi_cuda_largescaleknn_tpu.ops.tiled")

NEW_ENGINES = ["tiled", "bruteforce", "tree"]
TILES = {"query_tile": 64, "point_tile": 96}


def dyadic(n: int, seed: int, dim: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (n, dim)) / 64).astype(np.float32)


def test_config_accepts_all_six_engines():
    assert set(tconfig.ENGINES) == {"auto", "tiled", "pallas_tiled",
                                    "bruteforce", "tree", "pallas"}
    for engine in tconfig.ENGINES:
        tconfig.KnnConfig(k=4, engine=engine).validate()
        JConfig(k=4, engine=engine).validate()
        assert tring.resolve_engine(engine) == (
            "pallas_tiled" if engine == "auto" else engine)


@pytest.mark.parametrize("engine,want", [("tiled", 128),
                                         ("pallas_tiled", 256),
                                         ("bruteforce", 512), ("tree", 512),
                                         ("pallas", 512)])
def test_auto_geometry_per_engine_matches_jax(engine, want):
    assert tring.resolve_bucket_size(0, engine) == want
    assert jring.resolve_bucket_size(0, engine) == want
    assert tring.resolve_bucket_size(64, engine) == 64
    for npad in (100, 5000):
        bs = tring.resolve_bucket_size(0, engine)
        assert tring._effective_group(0, npad, bs, engine) == \
            jring._effective_group(0, npad, bs, engine)


def test_tree_refuses_bf16_and_other_d():
    pts = points("normal", 64, seed=2, dim=16)
    for engine in ("tree", "pallas"):
        with pytest.raises(ValueError, match="no score_dtype='bf16' path"):
            torch_knn(pts, 4, engine=engine, score_dtype="bf16",
                      device="cpu")
    with pytest.raises(ValueError, match="D=3"):
        torch_knn(pts, 4, engine="tree", device="cpu")
    with pytest.raises(ValueError, match="D=3"):
        TPre(tconfig.KnnConfig(k=3, engine="tree", num_shards=0,
                               device="cpu")).run(
            [pts[:30], pts[30:]])


def test_new_engines_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the card is here")
    for engine in NEW_ENGINES:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_knn(dyadic(40, 1), 3, engine=engine)


TILED_CASES = {
    # name: (kind, n, k, bucket, group, warm/skip_self, V, chunk, canonical,
    #        score_dtype, with_stats, prune_shrink, visit_frac)
    "k8": ("dyadic", 600, 8, 16, 1, False, 8, None, False, "f32", True,
           1.0, 1.0),
    "k8_canonical": ("dyadic", 600, 8, 16, 1, False, 8, None, True, "f32",
                     "full", 1.0, 1.0),
    "k33_canonical_v3_chunk4": ("dyadic", 640, 33, 16, 1, False, 3, 4,
                                True, "f32", "full", 1.0, 1.0),
    "k1_v1_chunk2": ("dyadic", 500, 1, 16, 1, False, 1, 2, False, "f32",
                     "full", 1.0, 1.0),
    "k8_skip_self_g1": ("dyadic", 600, 8, 16, 1, True, 8, None, False,
                        "f32", True, 1.0, 1.0),
    "k8_skip_self_g2": ("dyadic", 600, 8, 16, 2, True, 8, 4, False, "f32",
                        "full", 1.0, 1.0),
    "k33_skip_self_g2_canonical": ("dyadic", 640, 33, 16, 2, True, 1, None,
                                   True, "f32", "full", 1.0, 1.0),
    "k8_radius_rows": ("uniform", 500, 8, 16, 1, False, 8, None, False,
                       "f32", "full", 1.0, 1.0),
    "k8_prune_shrink": ("uniform", 600, 8, 16, 1, False, 2, None, False,
                        "f32", "full", 0.5, 1.0),
    "k8_visit_frac": ("uniform", 600, 8, 16, 1, False, 2, None, False,
                      "f32", "full", 1.0, 0.4),
    "d16_bf16": ("normal", 500, 8, 32, 1, False, 8, None, False, "bf16",
                 "full", 1.0, 1.0),
    "d128_bf16_canonical_g2": ("normal", 400, 8, 32, 2, True, 2, 2, True,
                               "bf16", "full", 1.0, 1.0),
    "d16_bf16_skip_rescore": ("normal", 500, 8, 32, 1, False, 8, None, False,
                              "bf16", "full", 1.0, 1.0),
    "d128_f32": ("normal", 400, 8, 32, 1, False, 8, None, False, "f32",
                 "full", 1.0, 1.0),
}


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_knn_update_tiled_matches_jax(case):
    (kind, n, k, bs, group, warm, v, chunk, canonical, sd, with_stats,
     shrink, frac) = TILED_CASES[case]
    dim = {"dyadic": 3, "uniform": 3}.get(kind, 16 if "d16" in case else 128)
    pts = (dyadic(n, n + k) if kind == "dyadic" else
           points(kind, n, seed=n + k, dim=dim))
    skip_rescore = "skip_rescore" in case
    jq = jpart.partition_points(jnp.asarray(pts), bucket_size=bs)
    jpc = jpart.coarsen_buckets(jq, group)
    rows = jq.num_buckets * jq.bucket_size
    if warm:
        jstate = jtiled.warm_start_self(jpc, k)
    elif case == "k8_radius_rows":
        radius = np.random.default_rng(1).random(rows).astype(np.float32)
        jstate = jcand.init_candidates(rows, k, jnp.asarray(radius * 0.1))
    else:
        jstate = jcand.init_candidates(rows, k)
    kw = dict(chunk_buckets=chunk, visits_per_step=v, with_stats=with_stats,
              self_group=group, canonical_ties=canonical, score_dtype=sd,
              prune_shrink=shrink, visit_frac=frac,
              skip_rescore=skip_rescore)
    want = jtiled.knn_update_tiled(
        jstate, jq, jpc, skip_self=jnp.int32(1) if warm else None, **kw)
    got = ttiled.knn_update_tiled(
        convert.candidate_state(jstate), convert.bucketed_points(jq),
        convert.bucketed_points(jpc), skip_self=warm, **kw)
    if skip_rescore:
        # raw matmul-form scores reach the rows: the two packages
        # accumulate them in different orders (tests/test_torch_mxu.py),
        # so only the visit schedule's counts are held equal, and the
        # distances to the tolerance of test_score_tile_matches_jax
        np.testing.assert_allclose(got[0].dist2.numpy(),
                                   np.asarray(want[0].dist2),
                                   rtol=2.0 ** -13, atol=1e-3)
    else:
        assert_rows_equal(got[0], want[0], jq.ids)
    assert [int(c) for c in got[1:]] == [int(c) for c in want[1:]]
    assert all(isinstance(c, int) for c in got[1:])


def test_knn_update_tiled_counts_folds_and_refuses_bad_knobs():
    pts = dyadic(300, 3)
    tq = tpart.partition_points(torch.from_numpy(pts), bucket_size=16)
    st = tcand.init_candidates(tq.ids.numel(), 4)
    before = ttiled.knn_update_tiled.folds
    _, tiles, folds = ttiled.knn_update_tiled(st, tq, tq, with_stats="full")
    assert ttiled.knn_update_tiled.folds - before == folds > 0
    assert tiles <= tq.num_buckets * ttiled.tile_schedule_slots(
        tq.num_buckets)
    for kw in ({"prune_shrink": 0.0}, {"prune_shrink": 1.5},
               {"visit_frac": 0.0}, {"chunk_buckets": 3},
               {"score_dtype": "fp8"}):
        with pytest.raises(ValueError):
            ttiled.knn_update_tiled(st, tq, tq, **kw)


@pytest.mark.parametrize("n_p", [1, 300])
def test_tile_schedule_slots_matches_jax(n_p):
    for v in (1, 3, 8, 1000):
        assert ttiled.tile_schedule_slots(n_p, v) == \
            jtiled.tile_schedule_slots(n_p, v)
    for s, t in ((16, 128), (256, 2048), (8, 8)):
        assert ttiled._default_chunk(n_p, s, t) == \
            jtiled._default_chunk(n_p, s, t)


@pytest.mark.parametrize("sd,dim,k,tiles", [
    ("f32", 3, 1, (64, 96)), ("f32", 3, 8, (77, 50)),
    ("f32", 3, 33, (2048, 2048)), ("f32", 16, 8, (64, 96)),
    ("bf16", 16, 8, (64, 96)), ("bf16", 128, 33, (100, 70))])
def test_knn_update_bruteforce_matches_jax(sd, dim, k, tiles):
    """Query and point tiles that do not divide Q = 250 or N = 430, and
    point ids that are not positions."""
    pts = (dyadic(430, k, dim) if sd == "f32" else
           points("normal", 430, seed=k, dim=dim))
    q = pts[:250]
    ids = (np.arange(430, dtype=np.int32) * 3 + 11)
    qt, pt = tiles
    jst = jcand.init_candidates(250, k, 4.0 if k == 8 else math.inf)
    want = jbf.knn_update_bruteforce(jst, jnp.asarray(q), jnp.asarray(pts),
                                     jnp.asarray(ids), query_tile=qt,
                                     point_tile=pt, score_dtype=sd)
    got = tbf.knn_update_bruteforce(convert.candidate_state(jst),
                                    torch.from_numpy(q),
                                    torch.from_numpy(pts),
                                    torch.from_numpy(ids), query_tile=qt,
                                    point_tile=pt, score_dtype=sd)
    assert_bitwise(got.dist2.numpy(), np.asarray(want.dist2))
    assert_bitwise(got.idx.numpy(), np.asarray(want.idx))
    dist = tbf.pairwise_dist2(torch.from_numpy(q[:5]), torch.from_numpy(pts))
    assert_bitwise(dist.numpy(), np.asarray(jbf.pairwise_dist2(
        jnp.asarray(q[:5]), jnp.asarray(pts))))


def unordered_both(engine, pts, k, num_shards, **extra):
    cfg = dict(k=k, engine=engine, bucket_size=16, **TILES, **extra)
    jm = JUn(JConfig(**cfg), mesh=get_mesh(num_shards))
    want_d, want_i = jm.run(pts, return_neighbors=True)
    tm = TUn(tconfig.KnnConfig(num_shards=num_shards, device="cpu", **cfg))
    got_d, got_i = tm.run(pts, return_neighbors=True)
    return (got_d, got_i, tm.last_stats), (want_d, want_i, jm.last_stats)


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_unordered_pipeline_matches_jax(engine, num_shards):
    pts = dyadic(420, seed=num_shards)
    (got_d, got_i, got_s), (want_d, want_i, want_s) = unordered_both(
        engine, pts, 7, num_shards, max_radius=3.0)
    assert_bitwise(got_d, np.asarray(want_d))
    assert_bitwise(got_i, np.asarray(want_i))
    assert got_s == want_s
    if engine == "tree":
        assert got_s["note"] == "tree engine work is pruned and not counted"
    else:
        assert got_s["pair_evals"] > 0


@pytest.mark.parametrize("engine", ["tiled", "bruteforce"])
def test_unordered_pipeline_bf16_matches_jax(engine):
    pts = points("normal", 300, seed=5, dim=16)
    (got_d, got_i, got_s), (want_d, want_i, want_s) = unordered_both(
        engine, pts, 6, 2, score_dtype="bf16")
    assert_bitwise(got_d, np.asarray(want_d))
    assert_bitwise(got_i, np.asarray(want_i))
    assert got_s == want_s


@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_prepartitioned_pipeline_matches_jax(engine):
    rng = np.random.default_rng(7)
    parts = []
    for i in range(4):
        p = dyadic(int(rng.integers(40, 90)), seed=20 + i)
        p[:, 0] = p[:, 0] / 4 + 2.0 * i      # side by side in x
        parts.append(p)
    cfg = dict(k=6, engine=engine, bucket_size=16, **TILES)
    jm = JPre(JConfig(**cfg), mesh=get_mesh(4))
    want_d, want_i = jm.run(parts, return_neighbors=True)
    tm = TPre(tconfig.KnnConfig(num_shards=0, device="cpu", **cfg))
    got_d, got_i = tm.run(parts, return_neighbors=True)
    for g, w in zip(got_d, want_d):
        assert_bitwise(g, np.asarray(w))
    for g, w in zip(got_i, want_i):
        assert_bitwise(g, np.asarray(w))
    assert tm.last_stats == {key: jm.last_stats[key] for key in
                             ("rounds", "kernels_run", "rotations_run")}
    assert 1 <= tm.last_stats["rounds"] <= 3


@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_cli_files_match_jax(tmp_path, engine):
    """Both CLIs with ``--engine``: output and id files byte-equal."""
    src = tmp_path / "in.float3"
    dyadic(300, seed=14).tofile(src)
    assert torch_part_cli.main([str(src), "-n", "4", "-o",
                                str(tmp_path / "part")]) == 0
    common = ["-k", "5", "--engine", engine, "--bucket-size", "16",
              "--query-tile", "64", "--point-tile", "96"]
    for name, cli_j, cli_t, inp, out, extra in (
            ("u", jax_cli, torch_cli, src, "{}.float", ["--shards", "4"]),
            ("p", jax_pre_cli, torch_pre_cli, tmp_path / "part.txt", "{}",
             [])):
        for side, cli, dev in (("j", cli_j, []),
                               ("t", cli_t, ["--device", "cpu"])):
            tag = tmp_path / f"{name}{side}"
            assert cli.main([str(inp), "-o", out.format(tag),
                             "--write-indices", f"{tag}i"] + common + extra
                            + dev) == 0
        outs = [sorted(tmp_path.glob(f"{name}{side}*")) for side in "jt"]
        assert [p.name[2:] for p in outs[0]] == [p.name[2:] for p in outs[1]]
        for want, got in zip(*outs):
            assert got.read_bytes() == want.read_bytes(), got.name
        assert len(outs[0]) == (2 if name == "u" else 8)


@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_chunked_ring_matches_jax(engine):
    flat, ids = sharded(dyadic(330, seed=31), 4)
    kw = dict(chunk_rows=30, engine=engine, bucket_size=16,
              return_candidates=True, return_stats=True, **TILES)
    want_d, want_c, want_s = jring.ring_knn_chunked(flat, ids, 6,
                                                    get_mesh(4), **kw)
    got_d, got_c, got_s = tring.ring_knn_chunked(flat, ids, 6, 4,
                                                 device="cpu", **kw)
    assert_rows_match(got_d, got_c, want_d, want_c, ids)
    assert got_s == want_s


@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_stepwise_cut_and_resume(tmp_path, engine):
    """``ring_knn_stepwise`` and ``demand_knn_stepwise`` cut after one
    round and resumed: the uncut run's rows, which are the JAX
    package's."""
    flat, ids = sharded(dyadic(360, seed=11), 4)
    kw = dict(engine=engine, bucket_size=16, return_candidates=True, **TILES)
    want_d, want_c = jring.ring_knn_stepwise(flat, ids, 6, get_mesh(4), **kw)
    full_d, full_c, full_s = tring.ring_knn_stepwise(
        flat, ids, 6, 4, device="cpu", return_stats=True, **kw)
    assert_rows_match(full_d, full_c, want_d, want_c, ids)
    cdir = str(tmp_path / "ring")
    tring.ring_knn_stepwise(flat, ids, 6, 4, device="cpu", checkpoint_dir=cdir,
                            max_rounds=1, **kw)
    assert os.path.exists(os.path.join(cdir, "ring_state.npz"))
    res_d, res_c, res_s = tring.ring_knn_stepwise(
        flat, ids, 6, 4, device="cpu", checkpoint_dir=cdir,
        return_stats=True, **kw)
    assert torch.equal(res_d, full_d) and torch.equal(res_c.idx, full_c.idx)
    assert not os.path.exists(os.path.join(cdir, "ring_state.npz"))

    kw = dict(engine=engine, bucket_size=16, return_stats=True, **TILES)
    want = jdemand.demand_knn_stepwise(flat, ids, 6, get_mesh(4), **kw)
    got = tdemand.demand_knn_stepwise(flat, ids, 6, 4, device="cpu", **kw)
    assert_rows_match(got[0], got[1], want[0], want[1], ids)
    assert got[2]["kernels_run"] == np.asarray(
        want[2]["kernels_run"]).tolist()
    assert got[2]["rounds"] >= 2          # so max_rounds=1 cuts the run
    cdir = str(tmp_path / "demand")
    tdemand.demand_knn_stepwise(flat, ids, 6, 4, device="cpu",
                                checkpoint_dir=cdir, max_rounds=1, **kw)
    res = tdemand.demand_knn_stepwise(flat, ids, 6, 4, device="cpu",
                                      checkpoint_dir=cdir, **kw)
    assert torch.equal(res[0], got[0]) and torch.equal(res[1].idx,
                                                       got[1].idx)
    assert res[2] == got[2]
