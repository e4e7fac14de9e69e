"""The benchmark cell of the source's pre-partitioned job
(``selfjoin-3d-k500-prepart``): the partition layout of
``knnbench/pipelines/prepartitioned.py``, ``PrePartitionedKNN.run`` on it
against the plain reference on every row (k below and above the D=3 slots'
limit, where the card takes the wide fold), the demand ring's counters
against a count replayed from the partitions' boxes with the reference's
radii, the cell's files and readers, and whole CPU runs of the cell shrunk
through its ``config_params``, sound and with a planted fault. CPU only;
nothing of JAX is imported here."""

import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from knnbench import data, reference, spec  # noqa: E402
from knnbench.run import execute  # noqa: E402
from mpi_cuda_largescaleknn_torch.core.config import KnnConfig  # noqa: E402
from mpi_cuda_largescaleknn_torch.models.prepartitioned import (  # noqa: E402
    PrePartitionedKNN,
)
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import d3_slots  # noqa: E402

CPU = torch.device("cpu")
CELL = "selfjoin-3d-k500-prepart"
PIPE = spec.pipeline("prepartitioned")
NEW_READERS = ("prepart.knn_tiled_d3_wide_roofline",
               "stage.traverse_s.prepart", "demand.folds_per_shard.prepart",
               "demand.radius_reads_per_job.prepart")


def small(ranks=8, npr=500, overlap=0.5):
    cfg = dict(spec.load_cell(CELL).config)
    cfg.update(ranks=ranks, points_per_rank=npr, points_total=ranks * npr,
               overlap=overlap)
    return cfg


def ragged_parts(seed, ranks=8, sizes=(400, 600)):
    """The layout's partitions at 600 points, each cut to a size drawn in
    ``sizes``."""
    parts = PIPE.host_parts(small(ranks, 600), CPU, seed, "job", 0)
    rng = np.random.default_rng(seed)
    return [p[:int(rng.integers(sizes[0], sizes[1] + 1))] for p in parts]


@pytest.mark.parametrize("ranks, overlap", [(8, 0.5), (64, 0.5), (5, 0.0)])
def test_layout_boxes_overlap_and_union(ranks, overlap):
    npr = 300
    cfg = small(ranks, npr, overlap)
    union = PIPE.draw_union(cfg, CPU, 11, "job", 3)
    assert union.shape == (ranks * npr, 3) and union.dtype == torch.float32
    # one seeded draw, mapped partition by partition in partition order
    raw = torch.rand((ranks * npr, 3),
                     generator=data.generator(CPU, 11, "job", 3))
    assert torch.equal(union[:, 1:], raw[:, 1:])
    parts = PIPE.host_parts(cfg, CPU, 11, "job", 3)
    assert len(parts) == ranks
    assert np.array_equal(np.concatenate(parts), union.numpy())
    width = 1.0 / ((ranks - 1) * (1 - overlap) + 1)
    for i, p in enumerate(parts):
        lo, hi, w = PIPE.partition_box(i, ranks, overlap)
        assert w == pytest.approx(width)
        assert lo == pytest.approx(i * width * (1 - overlap))
        assert hi == pytest.approx(lo + width)
        assert lo - 1e-6 <= p[:, 0].min() and p[:, 0].max() <= hi + 1e-6
        assert p[:, 0].max() - p[:, 0].min() > 0.9 * width
        assert p[:, 1:].min() >= 0 and p[:, 1:].max() < 1
    assert PIPE.partition_box(0, ranks, overlap)[0] == 0
    assert PIPE.partition_box(ranks - 1, ranks, overlap)[1] == \
        pytest.approx(1.0)
    # each partition's box overlaps its neighbour's by o of its width
    lo0, hi0, _ = PIPE.partition_box(0, ranks, overlap)
    lo1, _, _ = PIPE.partition_box(1, ranks, overlap)
    assert hi0 - lo1 == pytest.approx(overlap * width)
    inside = np.mean(parts[0][:, 0] >= lo1)
    assert inside == pytest.approx(overlap, abs=0.1)


def test_cell_is_the_sources_config_4():
    cfg = spec.load_cell(CELL).config
    assert (cfg["ranks"], cfg["points_per_rank"], cfg["k"]) == (64, 65536,
                                                                500)
    assert cfg["points_total"] == 2**22 and cfg["overlap"] == 0.5
    lo, hi, width = PIPE.partition_box(1, 64, 0.5)
    assert width == pytest.approx(2 / 65) and lo == pytest.approx(1 / 65)
    # the card takes the wide fold at the cell's k
    assert d3_slots(cfg["k"]) == 0


@pytest.mark.parametrize("k", [40, 200])
def test_prepartitioned_run_matches_the_reference_on_every_row(k):
    parts = ragged_parts(7)
    model = PrePartitionedKNN(KnnConfig(k=k, num_shards=0, device="cpu"))
    out = model.run(parts)
    assert [len(o) for o in out] == [len(p) for p in parts]
    union = torch.from_numpy(np.concatenate(parts))
    want = reference.kth_distances(union, union, k)
    got = np.concatenate(out).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # k=200 is where the card takes the wide fold; the CPU runs its twin
    assert (d3_slots(k) == 0) == (k > 128)


def _replay(parts, k):
    """The demand ring's schedule replayed from the partitions' boxes,
    with each shard's worst radius from the reference over the shards it
    has folded: (rounds, folds a shard, radius reads, arrivals pruned). A
    read is one wait on the card for a batch of shards: every shard's
    entry radius in the first round, then in each round the radii of the
    shards that folded forward, and of those that folded backward."""
    r_ = len(parts)
    lo = np.stack([p.min(0) for p in parts]).astype(np.float64)
    hi = np.stack([p.max(0) for p in parts]).astype(np.float64)
    gap = np.maximum(0, np.maximum(lo[:, None] - hi[None],
                                   lo[None] - hi[:, None]))
    box = np.sqrt((gap ** 2).sum(-1))            # [shard j, shard s]
    total = r_ // 2 + 1
    bwd_total = total - 1 if r_ % 2 == 0 else total
    off = (np.arange(r_)[:, None] - np.arange(r_)[None]) % r_
    arrival = np.minimum(off, r_ - off)
    seen = [set() for _ in range(r_)]

    def worst(j):
        if not seen[j]:
            return np.inf  # the warm start's rows: only the own bucket
        pts = torch.from_numpy(np.concatenate([parts[s] for s in
                                               sorted(seen[j])]))
        return reference.kth_distances(pts, torch.from_numpy(parts[j]),
                                       k).max()

    folds = np.zeros(r_, int)
    pruned = rnd = 0
    reads = 1
    held = (True, True)
    while True:
        entry = [worst(j) for j in range(r_)]
        need_f = any(((off[j] > rnd) & (off[j] < total)
                      & (box[j] < entry[j])).any() for j in range(r_))
        offb = (-off) % r_
        need_b = any(((offb[j] > rnd) & (offb[j] < bwd_total)
                      & (box[j] < entry[j])).any() for j in range(r_))
        keep = any_f = any_b = False
        for j in range(r_):
            src_f, src_b = (j - rnd) % r_, (j + rnd) % r_
            visit_f = box[j, src_f] < entry[j]
            rad = entry[j]
            if visit_f:
                seen[j].add(src_f)
                rad = worst(j)
            visit_b = src_b != src_f and box[j, src_b] < rad
            if visit_b:
                seen[j].add(src_b)
                rad = worst(j)
            any_f |= bool(visit_f)
            any_b |= bool(visit_b)
            folds[j] += int(visit_f) + int(visit_b)
            pruned += (int(held[0]) + int(held[1] and src_b != src_f)
                       - int(visit_f) - int(visit_b))
            keep |= bool(((arrival[j] > rnd) & (box[j] < rad)).any())
        reads += int(any_f) + int(any_b)
        held = (need_f, need_b)
        rnd += 1
        if not keep or rnd >= total:
            return rnd, folds.tolist(), reads, pruned


@pytest.mark.parametrize("ranks, npr, k", [(16, 200, 10), (13, 250, 12)])
def test_demand_counters_match_a_replay_from_the_boxes(ranks, npr, k):
    parts = PIPE.host_parts(small(ranks, npr), CPU, 5, "job", 0)
    model = PrePartitionedKNN(KnnConfig(k=k, num_shards=0, device="cpu"))
    model.run(parts)
    rounds, folds, reads, pruned = _replay(parts, k)
    stats = model.last_stats
    assert (stats["rounds"], stats["kernels_run"]) == (rounds, folds)
    counters = model.timers.counters
    assert counters["demand_radius_reads"] == reads <= 1 + 2 * rounds
    assert counters["demand_folds_pruned"] == pruned
    # the layout prunes and exits early at these sizes
    assert pruned > 0 and rounds < ranks // 2 + 1
    assert model.timers.phases["radius"].calls == reads
    for stage in ("upload", "partition", "init", "traverse", "final",
                  "box_order"):
        assert model.timers.phases[stage].seconds > 0, stage


def test_the_cell_resolves_to_its_pipeline_with_every_key_read():
    cell = spec.load_cell(CELL)
    assert spec.driver_of(cell.config, cell.traffic) == "prepartitioned"
    config_reads, mix_reads = PIPE.READS
    assert set(cell.config) - spec.ABOUT - {"pipeline"} == config_reads
    assert set(cell.traffic) - spec.ABOUT == mix_reads
    assert {m["name"] for m in cell.end_to_end} == {
        "selfjoin_points_per_s", "peak_device_mib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        *NEW_READERS, "device.idle_share.selfjoin"}
    assert cell.chips == 1
    assert cell.check == {"kth_rel_err_max": 3e-4, "answers_bad": 0}


def test_the_bf16_control_reads_not_correct():
    cell = spec.load_cell(CELL)
    cell.config.update(ranks=8, points_per_rank=500, points_total=4000,
                       k=200)
    got = PIPE.control(cell, 2**31 + 7, samples=64, device=CPU)
    assert got["kth_rel_err_max"]["value"] > got["kth_rel_err_max"]["limit"]
    # the reference itself, rounded to f32 as the port answers, is correct
    assert PIPE.control(cell, 2**31 + 7, "f64", samples=64, device=CPU)[
        "kth_rel_err_max"]["value"] < 1e-6


@pytest.mark.parametrize("bad, why", [
    ({"points_total": 100}, "points_total"), ({"overlap": 1.0}, "overlap"),
    ({"overlap": -0.1}, "overlap"),
    ({"points": {"kind": "uniform", "dim": 4}}, "float3")])
def test_the_pipeline_refuses_sizes_that_disagree(bad, why):
    cell = spec.load_cell(CELL)
    with pytest.raises(ValueError, match=why):
        PIPE.check(CELL, dict(cell.config, **bad), cell.traffic)


def _record(**demand):
    summary = {"window_s": 4.0, "busy_s": 1.0, "idle_gaps": [],
               "kernels": {"(anonymous namespace)::knn_tiled_d3_wide_kernel"
                           "(int const*)": 0.5, "other": 2.0}}
    return {"jobs": 4, "ranks": 64, "points_per_job": 2**22, "dim": 3,
            "k": 500, "stages": {"traverse": 6.0}, "trace": summary,
            "traced_jobs": 2, "demand": {"rounds": 26, "folds": 2560,
                                         **demand}}


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_read_a_record_and_not_the_empty_one(name):
    from knnbench import roofline

    read = spec.metric_reader(name)
    assert read({"jobs": 0, "trace": None, "stages": {},
                 "batcher": {}}) is None
    want = {"stage.traverse_s.prepart": 1.5,
            "demand.folds_per_shard.prepart": 10.0,
            "demand.radius_reads_per_job.prepart": 1100.0,
            "prepart.knn_tiled_d3_wide_roofline": 100.0 * 2 * roofline
            .least_seconds(roofline.selfjoin_work(2**22, 3, 500))[0] / 0.5}
    assert read(_record(demand_radius_reads=4400)) == pytest.approx(
        want[name])
    if name == "demand.radius_reads_per_job.prepart":
        # the parent's port keeps no such counter
        assert read(_record()) is None


def _checkout(dest: Path, **config) -> Path:
    """A checkout of the benchmark's files at ``dest``, the cell shrunk
    through its ``config_params``."""
    kb = dest / "knnbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "pipelines"):
        shutil.copytree(ROOT / "knnbench" / sub, kb / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    path = kb / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["config_params"] = config
    path.write_text(json.dumps(cell))
    return dest


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "swapped"])
def test_a_shrunk_run_of_the_cell_is_correct_and_catches_a_fault(
        tmp_path, monkeypatch, fault):
    root = _checkout(tmp_path, ranks=8, points_per_rank=400,
                     points_total=3200, k=40)
    if fault:
        orig = PrePartitionedKNN.run

        def swapped(self, partitions, return_neighbors=False):
            out = orig(self, partitions)
            return [out[1], out[0], *out[2:]]
        monkeypatch.setattr(PrePartitionedKNN, "run", swapped)
    out = execute(CELL, 2**31 + 101, 0.3, False, CPU, time.perf_counter(),
                  root=root)
    assert set(out["metrics"]) == {"selfjoin_points_per_s",
                                   "peak_device_mib", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    if fault:
        assert not out["correct"]
        assert out["checks"]["kth_rel_err_max"]["value"] > 1e-3
    else:
        assert out["correct"], out["checks"]
        assert out["checks"]["kth_rel_err_max"]["value"] < 1e-6
        assert list(out["setup_parts"]) == [
            "imports", "port_and_device", "warmup_points", "warmup_job"]


@pytest.mark.parametrize("name, why", [("absent", "no file"),
                                       ("jobs", "built-in")])
def test_a_pipeline_without_a_file_is_refused_beside_a_real_one(tmp_path,
                                                                name, why):
    root = _checkout(tmp_path)
    assert spec.load_cell(CELL, root).config["pipeline"] == "prepartitioned"
    path = root / "knnbench" / "configs" / "prepart3d_k500_64.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    pipeline=name)))
    with pytest.raises(ValueError, match=why):
        spec.load_cell(CELL, root)
