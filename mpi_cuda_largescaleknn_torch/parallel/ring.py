"""The ring exchange of the unordered pipeline, on one card.

The port of the JAX package's ``parallel/ring.py`` ``ring_knn`` (fused
driver, tiled branch). R shards each hold stationary queries with
persistent candidate rows; every round each shard folds the resident
point shards it holds, then the point shards rotate. The ring is
bidirectional: two copies of every point shard counter-rotate, so after
``ring_total_rounds(R) = R//2 + 1`` rounds every shard has met every other.
Here the R shards are virtual — a Python loop over them on one card — and
the schedule is the JAX one exactly, so candidates arrive in the same fold
order: in round r shard i folds shard (i - r) % R forward, then shard
(i + r) % R backward, except in round 0 (both copies are its own shard)
and, for even R, in round R/2 (both are the antipode). Round 0 folds the
own shard with ``skip_self``: each row was warm-started with its own
bucket (ops/tiled.py, always exact f32). ``score_dtype`` reaches the
traversal only. The flat engine ``pallas`` folds whole shards with the
brute-force kernel (``csrc/knn_bf.cu``) in the same order: queries in
slab order, no partition, no warm start, and no bf16 path (it raises, as
the JAX package's ``_engine_fn`` does). The ``torch.distributed`` ring
across cards is ROADMAP.md Queue 1.
"""

from __future__ import annotations

import contextlib

import torch

from mpi_cuda_largescaleknn_torch.core.config import ENGINES, not_ported
from mpi_cuda_largescaleknn_torch.core.types import CandidateState
from mpi_cuda_largescaleknn_torch.ops.candidates import (
    extract_final_result,
    init_candidates,
)
from mpi_cuda_largescaleknn_torch.ops.distance import validate_score_dtype
from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import knn_update_tiled_cuda
from mpi_cuda_largescaleknn_torch.ops.partition import (
    choose_buckets,
    coarsen_buckets,
    partition_points,
    scatter_back,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self


def resolve_engine(engine: str) -> str:
    """``auto`` is ``pallas_tiled``: the nearest-first traversal, whose
    kernel on the card is ``csrc/knn_tiled.cu``; ``pallas`` is the flat
    brute force (``csrc/knn_bf.cu``). The JAX package's other engines are
    not ported yet."""
    if engine not in ENGINES:
        raise not_ported(f"engine '{engine}'",
                         "Queue 1, the tiled twin and flat engines")
    return "pallas_tiled" if engine == "auto" else engine


def resolve_bucket_size(bucket_size: int) -> int:
    """0 = auto: 256 points per bucket, the JAX package's ``pallas_tiled``
    value (it comes from TPU sweeps; no H100 sweep exists yet)."""
    return bucket_size or 256


def ring_total_rounds(num_shards: int) -> int:
    """Rounds for a full bidirectional sweep: the own shard at round 0,
    then offsets +-1, ..., +-floor(R/2)."""
    return num_shards // 2 + 1


def _effective_group(point_group: int, npad_local: int,
                     bucket_size: int) -> int:
    """The point-side coarsening factor, clamped to the bucket count (both
    powers of two, so the clamped value divides). 0 = auto: 2, the JAX
    package's ``pallas_tiled`` value."""
    if point_group == 0:
        point_group = 2
    if point_group <= 1:
        return 1
    if point_group & (point_group - 1):
        raise ValueError(f"point_group must be a power of two, "
                         f"got {point_group}")
    return min(point_group, choose_buckets(npad_local, bucket_size)[0])


@contextlib.contextmanager
def timed_stage(timers, name: str, device: torch.device):
    """``timers.phase(name)`` ended by a device synchronisation, so its time
    covers its device work; nothing when ``timers`` is None."""
    if timers is None:
        yield
        return
    with timers.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _ring_stats(visits_total: int, bucket_size: int, q_rows: int,
                num_shards: int, point_group: int) -> dict:
    """Executed-work stats: distance pairs scored. One visit is an
    [S, group*S] tile; the warm start scores one [group*S, group*S] tile
    per coarse bucket, i.e. one [S, group*S] tile per fine bucket. (The
    flat engine scores every pair: R*R*Npad*Npad, no tiles.)"""
    num_qb, s = choose_buckets(q_rows, bucket_size)
    tiles = int(visits_total) + num_shards * num_qb
    return {"pair_evals": tiles * s * s * point_group, "tiles": tiles,
            "flops_per_pair": 8}


def ring_knn(points_sharded, ids_sharded, k: int, num_shards: int, *,
             max_radius: float = float("inf"), engine: str = "auto",
             query_tile: int = 2048, point_tile: int = 2048,
             bucket_size: int = 0, point_group: int = 0,
             score_dtype: str = "f32", device=None,
             return_candidates: bool = False, return_stats: bool = False,
             timers=None):
    """Run the full ring over ``num_shards`` virtual shards on ``device``.

    Args:
      points_sharded: f32[R*Npad, D] shard-major (shard r owns rows
        [r*Npad, (r+1)*Npad)), sentinel-padded; numpy or a tensor.
      ids_sharded: i32[R*Npad] global point ids (-1 for padding).
      query_tile / point_tile: the flat engine's tiles (results do not
        depend on them).
      score_dtype: "f32" or "bf16" (the traversal's matmul-form scores,
        ops/knn_tiled.py); the flat engine raises ValueError on "bf16".

    Returns f32[R*Npad] k-th-NN distances (a tensor on ``device``; inf for
    the tiled engine's padding rows, which the flat engine fills with
    sentinel matches), plus the CandidateState in the same row order if
    ``return_candidates``, plus a stats dict if ``return_stats``.
    ``timers`` (an ``obs.timers.PhaseTimers``) times the stages
    ``partition`` and ``warm_start`` (tiled engine only), ``traverse`` and
    ``extract``, each ended by a device synchronisation.
    """
    engine = resolve_engine(engine)
    flat = engine == "pallas"
    if validate_score_dtype(score_dtype) != "f32" and flat:
        raise ValueError(
            f"engine '{engine}' has no score_dtype='{score_dtype}' path "
            "(matmul-form scoring exists for the traversal)")
    bucket_size = resolve_bucket_size(bucket_size)
    total_rounds = ring_total_rounds(num_shards)
    pts = torch.as_tensor(points_sharded, dtype=torch.float32, device=device)
    ids = torch.as_tensor(ids_sharded, dtype=torch.int32, device=device)
    npad = pts.shape[0] // num_shards
    group = _effective_group(point_group, npad, bucket_size)
    visits = torch.zeros((), dtype=torch.int64, device=pts.device)

    if flat:
        slabs = [(pts[r * npad:(r + 1) * npad], ids[r * npad:(r + 1) * npad])
                 for r in range(num_shards)]
        heaps = [init_candidates(npad, k, max_radius, device=pts.device)
                 for _ in range(num_shards)]

        def fold(i, shard, skip_self=False):
            heaps[i] = knn_update_bf_cuda(heaps[i], slabs[i][0],
                                          *slabs[shard],
                                          query_tile=query_tile,
                                          point_tile=point_tile)
    else:
        with timed_stage(timers, "partition", pts.device):
            qs = [partition_points(pts[r * npad:(r + 1) * npad],
                                   ids[r * npad:(r + 1) * npad],
                                   bucket_size=bucket_size)
                  for r in range(num_shards)]
            resident = [coarsen_buckets(q, group) for q in qs]
        with timed_stage(timers, "warm_start", pts.device):
            heaps = [warm_start_self(pc, k, max_radius) for pc in resident]

        def fold(i, shard, skip_self=False):
            nonlocal visits
            heaps[i], v = knn_update_tiled_cuda(heaps[i], qs[i],
                                                resident[shard],
                                                skip_self=skip_self,
                                                self_group=group,
                                                with_stats=True,
                                                score_dtype=score_dtype)
            visits = visits + v.sum()

    with timed_stage(timers, "traverse", pts.device):
        for rnd in range(total_rounds):
            dup = rnd == 0 or 2 * rnd == num_shards
            for i in range(num_shards):
                fold(i, (i - rnd) % num_shards, skip_self=rnd == 0)
                if not dup:
                    fold(i, (i + rnd) % num_shards)

    with timed_stage(timers, "extract", pts.device):
        dists, cands = final_rows(None if flat else qs, heaps, npad,
                                  return_candidates)
    out = (dists,)
    if return_candidates:
        out += (cands,)
    if return_stats:
        out += ({"pair_evals": num_shards * num_shards * npad * npad,
                 "tiles": 0, "flops_per_pair": 8} if flat else
                _ring_stats(int(visits), bucket_size, npad, num_shards,
                            group),)
    return out if len(out) > 1 else out[0]


def final_rows(qs, heaps, npad: int, with_candidates: bool):
    """Per-shard heaps to slab-row order: f32[R*npad] k-th-NN distances
    (inf where the tiled engine has no real query) and, with
    ``with_candidates``, the CandidateState rows (else None). ``qs`` are
    the per-shard partitions of bucket-order heaps; None means the heaps
    are in slab-row order already (the flat engine)."""
    if qs is None:
        cands = (CandidateState(torch.cat([h.dist2 for h in heaps]),
                                torch.cat([h.idx for h in heaps]))
                 if with_candidates else None)
        return torch.cat([extract_final_result(h) for h in heaps]), cands
    dists, hd2, hidx = [], [], []
    for q, heap in zip(qs, heaps):
        bs = (q.num_buckets, q.bucket_size)
        dists.append(scatter_back(extract_final_result(heap).view(bs),
                                  q.pos, npad, fill=torch.inf))
        if with_candidates:
            kk = heap.dist2.shape[1]
            hd2.append(scatter_back(heap.dist2.view(bs + (kk,)), q.pos,
                                    npad, fill=torch.inf))
            hidx.append(scatter_back(heap.idx.view(bs + (kk,)), q.pos,
                                     npad, fill=-1))
    cands = (CandidateState(torch.cat(hd2), torch.cat(hidx))
             if with_candidates else None)
    return torch.cat(dists), cands
