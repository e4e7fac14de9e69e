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
- a direction's rotation counts as run in a round while some shard still
  needs a future delivery from it, judged on the round-entry radius (radii
  only shrink, so once off it stays off and no later visit was starved);
- the loop ends when no shard needs any shard that has not arrived yet.

Here the R shards are virtual — a Python loop on one card — so nothing
rotates: a visit folds the arriving shard directly, and the rotations are
counted exactly as the JAX predicate counts them. Per shard the stats are
``[kernels_run, rotations_run]``. Both engine families run: ``auto`` /
``pallas_tiled`` (the traversal kernel, ``csrc/knn_tiled.cu``) and
``pallas`` (the flat brute force, ``csrc/knn_bf.cu``). The chunked and
stepwise variants are ROADMAP.md Queue 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpi_cuda_largescaleknn_torch.core.types import (
    PAD_SENTINEL,
    aabb_box_distance,
    aabb_of_points,
)
from mpi_cuda_largescaleknn_torch.ops.candidates import (
    current_worst_radius,
    init_candidates,
)
from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import knn_update_tiled_cuda
from mpi_cuda_largescaleknn_torch.ops.partition import (
    coarsen_buckets,
    partition_points,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self
from mpi_cuda_largescaleknn_torch.parallel.ring import (
    _effective_group,
    final_rows,
    resolve_bucket_size,
    resolve_engine,
    ring_total_rounds,
    timed_stage,
)


def gathered_bounds_fn(slab_pts: list[torch.Tensor]):
    """Per-shard AABB of the real points, stacked: (lower f32[R, D],
    upper f32[R, D]) — what the reference Allgathers as 6-float boxes."""
    boxes = [aabb_of_points(p, p[:, 0] < PAD_SENTINEL / 2) for p in slab_pts]
    return (torch.stack([b.lower for b in boxes]),
            torch.stack([b.upper for b in boxes]))


class DemandCtx(NamedTuple):
    """What the rounds read and never write."""

    stationary: list   # per shard: BucketedPoints (tiled) or f32[Npad, D]
    resident: list     # per shard: coarsened BucketedPoints or (pts, ids)
    box_dist: torch.Tensor       # f32[R, R] on the host: shard i to box s
    arrival_round: torch.Tensor  # i64[R, R]: round shard s reaches i
    heap_valid: list   # per shard: bool[rows] of real queries


def _make_demand_fns(k, max_radius, engine, query_tile, point_tile,
                     num_shards, point_group=1):
    """The per-round pieces of the demand loop: (init_fn, round_fn,
    final_fn).

    - init_fn(slabs, qs) -> (ctx, heaps): ``slabs`` is the list of (points
      f32[Npad, D], ids i32[Npad]) per shard, ``qs`` their partitions
      (tiled engine, whose rows are warm-started with their own bucket;
      None for the flat one).
    - round_fn(ctx, heaps, rnd, counts) -> (heaps, counts, keep_going):
      ``counts`` is the per-shard list of [kernels run, direction-rotations
      run]; ``keep_going`` says whether any shard still needs a shard that
      has not arrived yet.
    - final_fn(ctx, heaps, npad) -> (dists f32[R*Npad], CandidateState) in
      slab-row order.
    """
    use_tiled = engine == "pallas_tiled"
    total = ring_total_rounds(num_shards)
    # forward delivers offsets 1..R//2; backward the same except the dup
    # round of even R, which is forward-only
    bwd_total = total - 1 if num_shards % 2 == 0 else total
    shards = torch.arange(num_shards)

    def init_fn(slabs, qs):
        all_lower, all_upper = gathered_bounds_fn([p for p, _ in slabs])
        box_dist = aabb_box_distance(all_lower[:, None], all_upper[:, None],
                                     all_lower[None], all_upper[None]).cpu()
        off = (shards[:, None] - shards[None, :]) % num_shards
        arrival = torch.minimum(off, num_shards - off)
        if use_tiled:
            # the resident side is a group-coarsened view of the same
            # partition; warm-started rows come back in fine order
            resident = [coarsen_buckets(q, point_group) for q in qs]
            heaps = [warm_start_self(pc, k, max_radius) for pc in resident]
            valid = [(q.ids >= 0).reshape(-1) for q in qs]
            stationary = list(qs)
        else:
            resident = list(slabs)
            heaps = [init_candidates(p.shape[0], k, max_radius,
                                     device=p.device) for p, _ in slabs]
            valid = [p[:, 0] < PAD_SENTINEL / 2 for p, _ in slabs]
            stationary = [p for p, _ in slabs]
        return DemandCtx(stationary, resident, box_dist, arrival,
                         valid), heaps

    def radius(ctx, heap, i) -> float:
        return current_worst_radius(heap, ctx.heap_valid[i]).item()

    def fold(ctx, heap, i, src, skip_self=False):
        if use_tiled:
            return knn_update_tiled_cuda(heap, ctx.stationary[i],
                                         ctx.resident[src],
                                         skip_self=skip_self,
                                         self_group=point_group)
        return knn_update_bf_cuda(heap, ctx.stationary[i],
                                  *ctx.resident[src], query_tile=query_tile,
                                  point_tile=point_tile)

    def round_fn(ctx, heaps, rnd, counts):
        heaps, counts = list(heaps), [list(c) for c in counts]
        entry = [radius(ctx, heaps[i], i) for i in range(num_shards)]
        need_f = need_b = False
        for i in range(num_shards):
            near = ctx.box_dist[i] < entry[i]
            off_f = (i - shards) % num_shards
            off_b = (shards - i) % num_shards
            need_f |= bool(((off_f > rnd) & (off_f < total) & near).any())
            need_b |= bool(((off_b > rnd) & (off_b < bwd_total)
                            & near).any())
        keep_going = False
        for i in range(num_shards):
            src_f = (i - rnd) % num_shards
            src_b = (i + rnd) % num_shards
            visit_f = bool(ctx.box_dist[i, src_f] < entry[i])
            rad = entry[i]
            if visit_f:
                heaps[i] = fold(ctx, heaps[i], i, src_f,
                                skip_self=use_tiled and rnd == 0)
                rad = radius(ctx, heaps[i], i)
            visit_b = src_b != src_f and bool(ctx.box_dist[i, src_b] < rad)
            if visit_b:
                heaps[i] = fold(ctx, heaps[i], i, src_b)
                rad = radius(ctx, heaps[i], i)
            counts[i][0] += int(visit_f) + int(visit_b)
            counts[i][1] += int(need_f) + int(need_b)
            keep_going |= bool(((ctx.arrival_round[i] > rnd)
                                & (ctx.box_dist[i] < rad)).any())
        return heaps, counts, keep_going

    def final_fn(ctx, heaps, npad):
        return final_rows(ctx.stationary if use_tiled else None, heaps, npad,
                          True)

    return init_fn, round_fn, final_fn


def demand_knn(points_sharded, ids_sharded, k: int, num_shards: int, *,
               max_radius: float = float("inf"), engine: str = "auto",
               query_tile: int = 2048, point_tile: int = 2048,
               bucket_size: int = 0, point_group: int = 0, device=None,
               return_stats: bool = False, timers=None):
    """Bounds-pruned kNN over ``num_shards`` pre-partitioned virtual shards
    on ``device``.

    Same data contract as ``ring_knn`` (shard-major, sentinel-padded rows
    f32[R*Npad, D] with ids i32[R*Npad]). Returns f32[R*Npad] distances and
    the CandidateState in that row order, plus, with ``return_stats``, a
    dict of ``rounds`` (rounds run) and the per-shard lists
    ``kernels_run`` and ``rotations_run``. ``timers`` times the stages
    ``partition`` (tiled engine), ``init`` (bounds, schedule, warm start),
    ``traverse`` and ``final``, each ended by a device synchronisation.
    """
    engine = resolve_engine(engine)
    bucket_size = resolve_bucket_size(bucket_size)
    pts = torch.as_tensor(points_sharded, dtype=torch.float32, device=device)
    ids = torch.as_tensor(ids_sharded, dtype=torch.int32, device=device)
    npad = pts.shape[0] // num_shards
    point_group = _effective_group(point_group, npad, bucket_size)
    init_fn, round_fn, final_fn = _make_demand_fns(
        k, max_radius, engine, query_tile, point_tile, num_shards,
        point_group=point_group)
    slabs = [(pts[r * npad:(r + 1) * npad], ids[r * npad:(r + 1) * npad])
             for r in range(num_shards)]

    qs = None
    if engine == "pallas_tiled":
        with timed_stage(timers, "partition", pts.device):
            qs = [partition_points(p, i, bucket_size=bucket_size)
                  for p, i in slabs]
    with timed_stage(timers, "init", pts.device):
        ctx, heaps = init_fn(slabs, qs)
    rounds, keep_going = 0, True
    counts = [[0, 0] for _ in range(num_shards)]
    with timed_stage(timers, "traverse", pts.device):
        while rounds < ring_total_rounds(num_shards) and keep_going:
            heaps, counts, keep_going = round_fn(ctx, heaps, rounds, counts)
            rounds += 1
    with timed_stage(timers, "final", pts.device):
        dists, cands = final_fn(ctx, heaps, npad)
    if return_stats:
        return dists, cands, {"rounds": rounds,
                              "kernels_run": [c[0] for c in counts],
                              "rotations_run": [c[1] for c in counts]}
    return dists, cands
