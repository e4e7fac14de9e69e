"""Bounds-pruned early-exit ring of the pre-partitioned pipeline, on one card.

The port of the JAX package's ``parallel/demand.py`` ``demand_knn`` (the
fused loop), itself the re-design of the reference's per-round
nearest-peer matching (``computeMyPeer``, global exit when every pick is
-1). Shards travel the same bidirectional ring as ``parallel/ring.py``, and
each shard folds an arriving shard only while that shard's bounding box is
strictly closer than the shard's current worst k-th distance:

- shard s reaches shard i in round ``min((i - s) % R, (s - i) % R)``;
- round r folds the forward arrival ``(i - r) % R`` if its box is closer
  than the round-entry radius, then the backward arrival ``(i + r) % R``
  (not in a duplicate round) against the radius refreshed after the
  forward fold; round 0's forward fold is the own shard, which the tiled
  engine has warm-started and folds with ``skip_self``;
- the host reads the radii in batches, one wait on the card each: every
  shard's forward fold is launched, then the refreshed radii of the shards
  that folded are read at once, and so for the backward folds; a round's
  entry radii are those the last round ended with (a rotation never
  touches the heaps), so only a ring's first round reads them. Each shard
  decides on its own radius alone, so the folds are those of a loop that
  reads after every fold;
- a direction's rotation counts as run in a round while some shard still
  needs a future delivery from it, judged on the round-entry radius (radii
  only shrink, so once off it stays off and no later visit was starved);
- the loop ends when no shard needs any shard that has not arrived yet.

The copies travel on ``parallel/mesh.py``'s ``ShardRing``, a direction
rotating only in the rounds its need says: in one process the R shards
are virtual (a Python loop on one device, a rotation a shift by index);
with a ``Mesh`` over a ``torch.distributed`` group (``demand_knn``'s
``mesh=``) each process holds its own positions, the shards' boxes are
gathered from every process, both need flags are OR-ed over the group in
one all-reduce a round, and the loop ends on the group's predicate, so
every process enters every collective as often as the others. Per shard
the stats are ``[kernels_run, rotations_run]``, equal in both forms.
Every engine of ``parallel/ring.py`` runs: ``auto`` / ``pallas_tiled``
(the traversal kernel, ``csrc/knn_tiled.cu``, warm-started), ``tiled``
(its XLA twin, cold) and the flat ``pallas``, ``bruteforce`` and ``tree``
(the kd-tree of each shard built at shard init), all scoring in f32. Two
loops share the per-round pieces of ``_make_demand_fns``:
``demand_knn_stepwise`` (checkpoint and resume between rounds, one
process; every round is read on the host anyway, so ``demand_knn``, JAX's
fused loop, is it without a checkpoint) and ``demand_knn_chunked`` (the
query side streamed in chunks, one process, as in JAX).

Tracing (``timers=``, an ``obs.timers.PhaseTimers``): the stages
``upload``, ``partition``, ``init``, ``traverse`` and ``final`` (each
ended by a synchronisation; ``chunks`` in the chunked loop); inside the
rounds the host phase ``radius`` (each batched read of the shards' worst
radii, one wait on the card however many shards it carries) and the device
span ``box_order`` (the ``pallas_tiled`` folds' box order, settled by the
stage); and the counters ``demand_radius_reads`` (those waits: at most 1 +
2 x rounds a ring) and ``demand_folds_pruned`` (the
arrivals a shard held in a round that the box test skipped). The returned
stats stay ``rounds``, ``kernels_run`` and ``rotations_run``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from mpi_cuda_largescaleknn_torch.core.types import (
    PAD_SENTINEL,
    CandidateState,
    aabb_box_distance,
    aabb_of_points,
)
from mpi_cuda_largescaleknn_torch.ops.candidates import (
    current_worst_radius,
    init_candidates,
)
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
    knn_update_tiled_cuda,
    warm_start_self_cuda,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    coarsen_buckets,
    partition_points,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import knn_update_tiled
from mpi_cuda_largescaleknn_torch.parallel.mesh import Mesh, ShardRing
from mpi_cuda_largescaleknn_torch.parallel.ring import (
    TILED_ENGINES,
    _effective_group,
    _resolve_mesh,
    _sharded_input,
    by_position,
    chunk_slabs,
    final_rows,
    flat_fold_fn,
    flat_resident,
    host_rows,
    load_round,
    resolve_bucket_size,
    resolve_engine,
    ring_total_rounds,
    save_round,
    timed_stage,
)
from mpi_cuda_largescaleknn_torch.utils import checkpoint as ckpt
from mpi_cuda_largescaleknn_torch.utils.math import cdiv


def gathered_bounds_fn(slab_pts: list[torch.Tensor]):
    """Per-shard AABB of the real points, stacked: (lower f32[R, D],
    upper f32[R, D]) — what the reference Allgathers as 6-float boxes."""
    boxes = [aabb_of_points(p, p[:, 0] < PAD_SENTINEL / 2) for p in slab_pts]
    return (torch.stack([b.lower for b in boxes]),
            torch.stack([b.upper for b in boxes]))


class DemandCtx(NamedTuple):
    """What the rounds read and never write, for this process's shards
    (row j is position ``mesh.positions[j]``)."""

    stationary: list   # per shard: BucketedPoints (tiled) or f32[rows, D]
    resident: list     # per shard: coarsened BucketedPoints or (pts, ids)
    box_dist: torch.Tensor       # f32[n, R] on the host: the queries of
                                 # shard j to the box of shard s
    arrival_round: torch.Tensor  # i64[n, R]: round shard s reaches j
    heap_valid: list   # per shard: bool[rows] of real queries


def _make_demand_fns(k, max_radius, engine, query_tile, point_tile,
                     mesh: Mesh, *, warm_start=False, point_group=1,
                     timers=None):
    """The per-round pieces of the stepwise and chunked demand loops over
    ``mesh``'s positions: (shard_init_fn, query_init_fn, rows_fn,
    round_fn, final_fn).

    - shard_init_fn(slabs, qs) -> (resident, all_lower, all_upper): the
      point side of this process's shards (``qs`` coarsened by
      ``point_group`` for the tiled engines; ``flat_resident`` of the
      slabs for the flat ones) and every shard's box f32[R, D], gathered
      over the mesh. ``slabs`` are per shard (points f32[Npad, D], ids
      i32[Npad]), ``qs`` their partitions (None for the flat engines).
    - query_init_fn(resident, qslabs, qqs, all_lower, all_upper,
      q_bounds=None) -> ctx: the query side, which may be a chunk of every
      slab; its prune distances use the query side's boxes, ``q_bounds``
      where the caller has them (a self-join's are ``all_lower`` and
      ``all_upper``), else the chunk's own (tighter) ones.
    - rows_fn(ctx) -> rows: each shard's starting rows, warm-started with
      their own bucket where ``warm_start``, else cold.
    - round_fn(ctx, ring, heaps, rnd, counts) -> (heaps, counts,
      keep_going): folds the copies ``ring`` (a ``ShardRing``) holds, a
      direction's folds back to back, then rotates each direction some
      shard still needs, and keeps the radii it ended with as
      ``ring.radii``, the next round's entry radii; ``counts`` is
      the per-shard list of [kernels run, direction-rotations run];
      ``keep_going`` says whether any shard of the mesh still needs a
      shard that has not arrived yet.
    - final_fn(ctx, heaps, n) -> (dists f32[len(heaps)*n],
      CandidateState) in slab-row order.

    ``timers`` (an ``obs.timers.PhaseTimers``) times each host read of
    the shards' worst radii (one wait on the card, however many shards it
    carries: a ring's first round reads every shard's, then a round reads
    those of the shards that folded forward, and those that folded
    backward) as the phase ``radius`` and counts it in
    ``demand_radius_reads``, times the ``pallas_tiled`` folds' box order
    as the device span ``box_order``, and counts in
    ``demand_folds_pruned`` the arrivals a shard held in a round that the
    box test skipped (a direction that stopped rotating holds none).
    """
    num_shards = mesh.num_shards
    mine = torch.tensor(mesh.positions)
    use_tiled = engine in TILED_ENGINES
    warm_start = warm_start and engine == "pallas_tiled"
    if use_tiled:
        tiled_update = (knn_update_tiled if engine == "tiled" else
                        functools.partial(knn_update_tiled_cuda,
                                          timers=timers))
    else:
        flat_fold = flat_fold_fn(engine, query_tile, point_tile)
    total = ring_total_rounds(num_shards)
    # forward delivers offsets 1..R//2; backward the same except the dup
    # round of even R, which is forward-only
    bwd_total = total - 1 if num_shards % 2 == 0 else total
    shards = torch.arange(num_shards)

    def shard_init_fn(slabs, qs):
        lower, upper = gathered_bounds_fn([p for p, _ in slabs])
        dim = lower.shape[1]
        boxes = mesh.gather_positions(torch.cat([lower, upper], 1))
        all_lower, all_upper = boxes[:, :dim], boxes[:, dim:]
        # the resident side is a group-coarsened view of the partition
        resident = ([coarsen_buckets(q, point_group) for q in qs]
                    if use_tiled else
                    [flat_resident(engine, p, i) for p, i in slabs])
        return resident, all_lower, all_upper

    def query_init_fn(resident, qslabs, qqs, all_lower, all_upper,
                      q_bounds=None):
        q_lower, q_upper = q_bounds or gathered_bounds_fn(
            [p for p, _ in qslabs])
        box_dist = aabb_box_distance(q_lower[:, None], q_upper[:, None],
                                     all_lower[None], all_upper[None]).cpu()
        off = (mine[:, None] - shards[None, :]) % num_shards
        arrival = torch.minimum(off, num_shards - off)
        if use_tiled:
            valid = [(q.ids >= 0).reshape(-1) for q in qqs]
            stationary = list(qqs)
        else:
            valid = [p[:, 0] < PAD_SENTINEL / 2 for p, _ in qslabs]
            stationary = [p for p, _ in qslabs]
        return DemandCtx(stationary, resident, box_dist, arrival, valid)

    def rows_fn(ctx):
        if warm_start:
            # rows come back in fine order: the coarsening is a view
            return [warm_start_self_cuda(pc, k, max_radius)
                    for pc in ctx.resident]
        return [init_candidates(v.numel(), k, max_radius, device=v.device)
                for v in ctx.heap_valid]

    def read_radii(ctx, heaps, rad, js) -> None:
        # the worst radii of the shards js into rad: one host wait on the
        # card, however many shards it carries
        if not js:
            return
        if timers is not None:
            timers.count("demand_radius_reads")
        with (contextlib.nullcontext() if timers is None
              else timers.phase("radius")):
            got = torch.stack([current_worst_radius(heaps[j],
                                                    ctx.heap_valid[j])
                               for j in js]).tolist()
        for j, r in zip(js, got):
            rad[j] = r

    def fold(ctx, heap, j, shard, skip_self=False):
        if not use_tiled:
            return flat_fold(heap, ctx.stationary[j], shard)
        return tiled_update(heap, ctx.stationary[j], shard,
                            skip_self=skip_self, self_group=point_group)

    def round_fn(ctx, ring, heaps, rnd, counts):
        heaps, counts = list(heaps), [list(c) for c in counts]
        here = range(len(heaps))
        # the copies this round holds: round 0's own shard, then each
        # direction's arrival while it rotates
        held_f, held_b = getattr(ring, "held", (True, True))
        # the radii the last round ended with: a rotation never touches the
        # heaps, so only a ring's first round reads them
        entry = getattr(ring, "radii", None)
        if entry is None:
            entry = [0.0] * len(heaps)
            read_radii(ctx, heaps, entry, here)
        need_f = need_b = False
        for j, i in enumerate(mesh.positions):
            near = ctx.box_dist[j] < entry[j]
            off_f = (i - shards) % num_shards
            off_b = (shards - i) % num_shards
            need_f |= bool(((off_f > rnd) & (off_f < total) & near).any())
            need_b |= bool(((off_b > rnd) & (off_b < bwd_total)
                            & near).any())
        # one all-reduce for both directions, on the round-entry radii
        need_f, need_b = mesh.any(need_f, need_b)
        # each phase launches every shard's fold with no read between them;
        # a direction that did not rotate holds a stale copy, never
        # visited: radii only shrink, so its need stayed off
        src_f = [(i - rnd) % num_shards for i in mesh.positions]
        src_b = [(i + rnd) % num_shards for i in mesh.positions]
        rad = list(entry)
        visit_f = [bool(ctx.box_dist[j, src_f[j]] < entry[j]) for j in here]
        for j in here:
            if visit_f[j]:
                heaps[j] = fold(ctx, heaps[j], j, ring.fwd[j].parts,
                                skip_self=warm_start and rnd == 0)
        read_radii(ctx, heaps, rad, [j for j in here if visit_f[j]])
        visit_b = [src_b[j] != src_f[j]
                   and bool(ctx.box_dist[j, src_b[j]] < rad[j]) for j in here]
        for j in here:
            if visit_b[j]:
                heaps[j] = fold(ctx, heaps[j], j, ring.bwd[j].parts)
        read_radii(ctx, heaps, rad, [j for j in here if visit_b[j]])
        pruned = 0
        keep_going = False
        for j in here:
            counts[j][0] += int(visit_f[j]) + int(visit_b[j])
            counts[j][1] += int(need_f) + int(need_b)
            pruned += (int(held_f) + int(held_b and src_b[j] != src_f[j])
                       - int(visit_f[j]) - int(visit_b[j]))
            keep_going |= bool(((ctx.arrival_round[j] > rnd)
                                & (ctx.box_dist[j] < rad[j])).any())
        if need_f or need_b:
            ring.rotate(need_f, need_b)
        ring.held = (need_f, need_b)
        ring.radii = rad
        if timers is not None:
            timers.count("demand_folds_pruned", pruned)
        # the loop ends on the mesh's predicate: every process enters
        # every collective as often
        return heaps, counts, mesh.any(keep_going)[0]

    def final_fn(ctx, heaps, n):
        return final_rows(ctx.stationary if use_tiled else None, heaps, n,
                          True)

    return shard_init_fn, query_init_fn, rows_fn, round_fn, final_fn


def _demand_setup(points_sharded, ids_sharded, num_shards, engine,
                  bucket_size, point_group, device, mesh=None, timers=None):
    """(engine, bucket size, point group, mesh, points, ids, slabs) of a
    demand loop: this process's slabs on the mesh's device (every shard
    on ``device`` without a mesh; None = the card), their upload timed as
    the stage ``upload`` of ``timers``."""
    engine = resolve_engine(engine)
    bucket_size = resolve_bucket_size(bucket_size, engine)
    mesh = _resolve_mesh(mesh, num_shards, device)
    n_mine = len(mesh.positions)
    with timed_stage(timers, "upload", mesh.device):
        pts, ids, slabs = _sharded_input(points_sharded, ids_sharded,
                                         n_mine, mesh.device)
    npad = pts.shape[0] // n_mine
    point_group = _effective_group(point_group, npad, bucket_size, engine)
    return engine, bucket_size, point_group, mesh, pts, ids, slabs


def _partitions(engine, slabs, bucket_size):
    if engine not in TILED_ENGINES:
        return None
    return [partition_points(p, i, bucket_size=bucket_size)
            for p, i in slabs]


def _demand_stats(rounds, counts) -> dict:
    return {"rounds": rounds, "kernels_run": [int(c[0]) for c in counts],
            "rotations_run": [int(c[1]) for c in counts]}


def demand_knn(points_sharded, ids_sharded, k: int, num_shards: int, *,
               max_radius: float = float("inf"), engine: str = "auto",
               query_tile: int = 2048, point_tile: int = 2048,
               bucket_size: int = 0, point_group: int = 0, device=None,
               mesh: Mesh | None = None, return_stats: bool = False,
               timers=None):
    """Bounds-pruned kNN over ``num_shards`` pre-partitioned shards on
    ``device`` (None = the card; without CUDA that raises).

    Same data contract as ``ring_knn`` (shard-major, sentinel-padded rows
    f32[R*Npad, D] with ids i32[R*Npad]). Returns f32[R*Npad] distances and
    the CandidateState in that row order, plus, with ``return_stats``, a
    dict of ``rounds`` (rounds run) and the per-shard lists
    ``kernels_run`` and ``rotations_run``. With ``mesh`` (a process
    group) the input is this process's block, the rows come back as
    ``{position: rows}`` and the per-shard lists are its positions'.
    ``timers`` times the stages ``upload`` (the padded input onto the
    device), ``partition`` (tiled engines), ``init`` (bounds, schedule,
    warm start, the kd-trees), ``traverse`` and ``final``, each ended by a
    device synchronisation; inside ``traverse`` the host phase ``radius``
    (each batched read of the shards' worst radii, a wait on the card) and
    the device span ``box_order`` (the ``pallas_tiled`` folds' box order);
    and the counters ``demand_radius_reads`` and ``demand_folds_pruned``
    (``_make_demand_fns``). It is ``demand_knn_stepwise`` without a
    checkpoint.
    """
    return demand_knn_stepwise(
        points_sharded, ids_sharded, k, num_shards, max_radius=max_radius,
        engine=engine, query_tile=query_tile, point_tile=point_tile,
        bucket_size=bucket_size, point_group=point_group, device=device,
        mesh=mesh, return_stats=return_stats, timers=timers)


def demand_knn_stepwise(points_sharded, ids_sharded, k: int,
                        num_shards: int, *, max_radius: float = float("inf"),
                        engine: str = "auto", query_tile: int = 2048,
                        point_tile: int = 2048, bucket_size: int = 0,
                        point_group: int = 0, device=None,
                        mesh: Mesh | None = None,
                        checkpoint_dir: str | None = None,
                        checkpoint_every: int = 1,
                        max_rounds: int | None = None,
                        return_stats: bool = False, timers=None):
    """``demand_knn`` with a checkpoint between rounds. The early-exit
    predicate is read on the host after each round; every
    ``checkpoint_every`` rounds, and when ``max_rounds`` cuts the run,
    (round, the rotating pair, every shard's rows, the per-shard
    [kernels, rotations] counts) go to ``checkpoint_dir``; the bounds,
    schedule and partitions are recomputed on resume, and the saved rows
    take the warm start's place. A run that completed (early exit, or
    every shard met) saves nothing and clears its checkpoint. Returns what
    ``demand_knn`` returns; the counts add up over the interrupted runs.
    Checkpoints are single-process: with a ``mesh`` ``checkpoint_dir``
    raises ValueError. ``timers`` times what ``demand_knn``'s does;
    ``init`` covers a checkpoint's load and ``traverse`` its writes."""
    grouped = mesh is not None
    if grouped and checkpoint_dir:
        raise ValueError("--checkpoint-dir is not supported in multi-host "
                         "mode")
    engine, bucket_size, point_group, mesh, pts, _ids, slabs = \
        _demand_setup(points_sharded, ids_sharded, num_shards, engine,
                      bucket_size, point_group, device, mesh, timers)
    n_mine = len(mesh.positions)
    npad = pts.shape[0] // n_mine
    fp = None
    if checkpoint_dir:
        fp = ckpt.fingerprint(
            n=int(pts.shape[0]), k=int(k), shards=num_shards, engine=engine,
            max_radius=float(max_radius), bucket_size=bucket_size,
            **({"point_group": point_group} if point_group > 1 else {}),
            query_tile=query_tile, point_tile=point_tile,
            kind="demand-bidir-rg",
            data=ckpt.data_digest(points_sharded, ids_sharded))
    shard_init_fn, query_init_fn, rows_fn, round_fn, final_fn = \
        _make_demand_fns(k, max_radius, engine, query_tile, point_tile,
                         mesh, warm_start=True, point_group=point_group,
                         timers=timers)

    with timed_stage(timers if engine in TILED_ENGINES else None,
                     "partition", pts.device):
        qs = _partitions(engine, slabs, bucket_size)
    counts = [[0, 0] for _ in range(n_mine)]
    start = 0
    with timed_stage(timers, "init", pts.device):
        resident, all_lower, all_upper = shard_init_fn(slabs, qs)
        # a self-join: the query side's boxes are the shards' own
        mine = slice(mesh.positions[0], mesh.positions[-1] + 1)
        ctx = query_init_fn(resident, slabs, qs, all_lower, all_upper,
                            q_bounds=(all_lower[mine], all_upper[mine]))
        # a resumed run's rows come from the checkpoint (saved after at
        # least one round, so round 0's skip_self never meets them)
        got = (load_round(checkpoint_dir, fp, num_shards, pts.device)
               if checkpoint_dir else None)
        if got is not None:
            start, heaps, (saved_counts,) = got
            counts = saved_counts.cpu().tolist()
        else:
            heaps = rows_fn(ctx)

    total = ring_total_rounds(num_shards)
    stop = total if max_rounds is None else min(max_rounds, total)
    rounds_done = start
    # completed: nothing left to do (early exit, or every shard met), as
    # opposed to cut by max_rounds
    completed = start >= total
    finished = start >= stop
    ring = ShardRing(mesh, resident, start)
    with timed_stage(timers, "traverse", pts.device):
        while not finished:
            heaps, counts, keep_going = round_fn(ctx, ring, heaps,
                                                 rounds_done, counts)
            rounds_done += 1
            completed = not keep_going or rounds_done >= total
            finished = completed or rounds_done >= stop
            if checkpoint_dir and not completed and (
                    rounds_done % checkpoint_every == 0 or finished):
                save_round(checkpoint_dir, rounds_done, heaps, fp,
                           (torch.tensor(counts, dtype=torch.int32),))
    with timed_stage(timers, "final", pts.device):
        dists, cands = final_fn(ctx, heaps, npad)
    if checkpoint_dir and completed:
        ckpt.clear(checkpoint_dir)
    if grouped:
        dists, cands = by_position(mesh, dists, cands, npad)
    if return_stats:
        return dists, cands, _demand_stats(rounds_done, counts)
    return dists, cands


def demand_knn_chunked(points_sharded, ids_sharded, k: int,
                       num_shards: int, *, chunk_rows: int,
                       max_radius: float = float("inf"),
                       engine: str = "auto", query_tile: int = 2048,
                       point_tile: int = 2048, bucket_size: int = 0,
                       point_group: int = 0, device=None,
                       checkpoint_dir: str | None = None,
                       checkpoint_every: int = 1,
                       return_candidates: bool = False,
                       return_stats: bool = False, timers=None):
    """``demand_knn`` with the query side streamed in chunks of
    ``chunk_rows`` rows a shard: every shard's whole point side stays
    resident (coarsened by the point group), rows are held for one chunk
    at a time. Each chunk runs its own early-exit loop from a pristine
    pair, cold (no warm start), with prune distances from each shard's
    chunk box. With ``checkpoint_dir``, the finished chunks' results are
    saved every ``checkpoint_every`` chunks (never after the last) and a
    relaunch resumes at the first unfinished chunk.

    Returns f32[R*Npad] distances and the CandidateState (None unless
    ``return_candidates``) as tensors on the host, plus, with
    ``return_stats``, ``rounds`` (a list: the rounds of each chunk) and
    ``kernels_run`` and ``rotations_run`` summed over the chunks.
    ``timers`` times ``upload``, ``partition`` (the resident sides) and
    ``chunks``, and inside ``chunks`` what ``demand_knn``'s times inside
    ``traverse``, with its counters."""
    engine, bucket_size, point_group, mesh, pts, ids, slabs = \
        _demand_setup(points_sharded, ids_sharded, num_shards, engine,
                      bucket_size, point_group, device, timers=timers)
    dev = pts.device
    npad = pts.shape[0] // num_shards
    dim = pts.shape[1]
    n_chunks = max(1, cdiv(npad, chunk_rows))
    total = ring_total_rounds(num_shards)
    shard_init_fn, query_init_fn, rows_fn, round_fn, final_fn = \
        _make_demand_fns(k, max_radius, engine, query_tile, point_tile,
                         mesh, point_group=point_group, timers=timers)
    with timed_stage(timers, "partition", dev):
        resident, all_lower, all_upper = shard_init_fn(
            slabs, _partitions(engine, slabs, bucket_size))

    out_d, out_hd2, out_idx = host_rows(num_shards, npad, k,
                                        return_candidates)
    rounds_per_chunk: list[int] = []
    nrun_total = torch.zeros((num_shards, 2), dtype=torch.int64)

    fp = None
    start_chunk = 0
    if checkpoint_dir:
        fp = ckpt.fingerprint(
            n=int(pts.shape[0]), k=int(k), shards=num_shards,
            engine=engine, max_radius=float(max_radius),
            bucket_size=bucket_size, chunk_rows=chunk_rows,
            query_tile=query_tile, point_tile=point_tile,
            kind="demand-chunked-rg", candidates=bool(return_candidates),
            data=ckpt.data_digest(points_sharded, ids_sharded))
        got = ckpt.load_ring_state(checkpoint_dir, fp)
        if got is not None:
            start_chunk, arrs = got
            out_d = torch.from_numpy(arrs["out_d"])
            rounds_per_chunk = arrs["rounds_per_chunk"].tolist()
            nrun_total = torch.from_numpy(arrs["nrun_total"])
            if return_candidates:
                out_hd2 = torch.from_numpy(arrs["out_hd2"])
                out_idx = torch.from_numpy(arrs["out_idx"])

    pts3 = pts.view(num_shards, npad, dim)
    ids2 = ids.view(num_shards, npad)
    with timed_stage(timers, "chunks", dev):
        for c in range(start_chunk, n_chunks):
            lo, hi, qp, qi = chunk_slabs(pts3, ids2, c, chunk_rows)
            qslabs = [(qp[s], qi[s]) for s in range(num_shards)]
            ctx = query_init_fn(
                resident, qslabs, _partitions(engine, qslabs, bucket_size),
                all_lower, all_upper)
            heaps = rows_fn(ctx)
            counts = [[0, 0] for _ in range(num_shards)]
            rounds = 0
            ring = ShardRing(mesh, resident)  # a pristine pair a chunk
            while rounds < total:
                heaps, counts, keep_going = round_fn(ctx, ring, heaps,
                                                     rounds, counts)
                rounds += 1
                if not keep_going:
                    break
            rounds_per_chunk.append(rounds)
            nrun_total += torch.tensor(counts, dtype=torch.int64)
            d, cands = final_fn(ctx, heaps, chunk_rows)
            n = hi - lo
            out_d[:, lo:hi] = d.view(num_shards, chunk_rows)[:, :n].cpu()
            if return_candidates:
                out_hd2[:, lo:hi] = cands.dist2.view(
                    num_shards, chunk_rows, k)[:, :n].cpu()
                out_idx[:, lo:hi] = cands.idx.view(
                    num_shards, chunk_rows, k)[:, :n].cpu()
            # never after the last chunk: the clear below follows, and a
            # completed run's checkpoint must not outlive it
            if checkpoint_dir and (c + 1) % checkpoint_every == 0 \
                    and c + 1 < n_chunks:
                arrs = {"out_d": out_d,
                        "rounds_per_chunk": torch.tensor(rounds_per_chunk,
                                                         dtype=torch.int64),
                        "nrun_total": nrun_total}
                if return_candidates:
                    arrs.update(out_hd2=out_hd2, out_idx=out_idx)
                ckpt.save_ring_state(checkpoint_dir, c + 1, arrs, fp)
    if checkpoint_dir:
        ckpt.clear(checkpoint_dir)
    dists = out_d.view(-1)
    cands = (CandidateState(out_hd2.view(-1, k), out_idx.view(-1, k))
             if return_candidates else None)
    if return_stats:
        return dists, cands, {"rounds": rounds_per_chunk,
                              "kernels_run": nrun_total[:, 0].tolist(),
                              "rotations_run": nrun_total[:, 1].tolist()}
    return dists, cands
