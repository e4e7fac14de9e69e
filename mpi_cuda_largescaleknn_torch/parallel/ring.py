"""The ring exchange of the unordered pipeline, on one card.

The port of the JAX package's ``parallel/ring.py``: ``ring_knn``,
``ring_knn_stepwise`` with checkpoint and resume between rounds, and
``ring_knn_chunked``, which streams the query side in chunks to bound the
candidate rows' memory. On one card every round is stepped from the host,
so JAX's fused and stepwise drivers are one loop here (``ring_knn`` is
``ring_knn_stepwise`` without a checkpoint); it and the chunked loop run
the per-round pieces of ``_make_ring_fns``, so they cannot diverge. R shards
each hold stationary queries with persistent candidate rows; every round
each shard folds the resident point shards it holds, then the point shards
rotate. The ring is bidirectional: two copies of every point shard
counter-rotate, so after ``ring_total_rounds(R) = R//2 + 1`` rounds every
shard has met every other. The schedule is the JAX one exactly, so
candidates arrive in the same fold order: in round r shard i folds shard
(i - r) % R forward, then shard (i + r) % R backward, except in round 0
(both copies are its own shard) and, for even R, in round R/2 (both are
the antipode). The copies travel on ``parallel/mesh.py``'s ``ShardRing``:
in one process the R shards are virtual, a Python loop on one device,
and a rotation shifts them by index; with a ``Mesh`` over a
``torch.distributed`` group each process holds its own positions and only
the copies at a process boundary cross. The fold order does not depend on
which process holds a position, so P processes write the bytes one
process writes. The self-join loops' round 0 folds the own shard with
``skip_self``: each row was warm-started with its own bucket, always in
exact f32 (``ops/knn_tiled.py`` ``warm_start_self_cuda``: one visit of the
traversal kernels on the card, ``ops/tiled.py`` ``warm_start_self`` on the
CPU). The engines are the JAX package's six:

- ``pallas_tiled`` (what ``auto`` names): the traversal kernels
  (``ops/knn_tiled.py``), warm-started on self-joins;
- ``tiled``: the traversal's XLA twin (``ops/tiled.py``), cold, on the
  same bucketed data;
- the flat engines fold whole shards in the same order, queries in slab
  order, with no partition and no warm start: ``pallas`` the brute-force
  kernel (``csrc/knn_bf.cu``), ``bruteforce`` its XLA twin
  (``ops/brute_force.py``), ``tree`` the stack-free traversal of each
  shard's kd-tree (``ops/traverse.py``, built at shard init).

``score_dtype="bf16"`` reaches ``pallas_tiled``, ``tiled`` and
``bruteforce``; ``pallas`` and ``tree`` raise on it, as the JAX package's
``_engine_fn`` does.

Across processes (``mesh=``, ``cli/multihost.py``) each driver takes this
process's block of the shard-major input and returns ``{position:
rows}``; round-level checkpoints stay single-process, the chunked loop
checkpoints each process's own rows, and its device merge gathers the
chunk to every process and reduces the R partial rows over the group
(``all_to_all``) in ascending shard order, as in one process.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, NamedTuple

import torch

from mpi_cuda_largescaleknn_torch.core.config import ENGINES, resolve_device
from mpi_cuda_largescaleknn_torch.core.types import (
    PAD_SENTINEL,
    CandidateState,
    aabb_of_points,
)
from mpi_cuda_largescaleknn_torch.ops.candidates import (
    extract_final_result,
    init_candidates,
    tree_merge_candidates,
)
from mpi_cuda_largescaleknn_torch.ops.brute_force import knn_update_bruteforce
from mpi_cuda_largescaleknn_torch.ops.build_tree import build_tree
from mpi_cuda_largescaleknn_torch.ops.distance import validate_score_dtype
from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
    knn_update_tiled_cuda,
    warm_start_self_cuda,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    BucketedPoints,
    choose_buckets,
    coarsen_buckets,
    partition_points,
    scatter_back,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import knn_update_tiled
from mpi_cuda_largescaleknn_torch.ops.traverse import knn_update_tree
from mpi_cuda_largescaleknn_torch.parallel.mesh import (
    Copy,
    Mesh,
    ShardRing,
    shard_nbytes,
    shard_tensors,
)
from mpi_cuda_largescaleknn_torch.utils import checkpoint as ckpt
from mpi_cuda_largescaleknn_torch.utils.math import cdiv, next_pow2


#: the engines on the bucketed data path (partition, nearest-first walk)
TILED_ENGINES = ("tiled", "pallas_tiled")


def resolve_engine(engine: str) -> str:
    """``auto`` is ``pallas_tiled``: the nearest-first traversal, whose
    kernel on the card is ``csrc/knn_tiled.cu`` (the JAX package's ``auto``
    is ``tiled`` off a TPU). Every other name of ``ENGINES`` is itself."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine '{engine}' (expected one of "
                         f"{ENGINES})")
    return "pallas_tiled" if engine == "auto" else engine


def _check_score_dtype(engine: str, score_dtype: str) -> None:
    if validate_score_dtype(score_dtype) != "f32" \
            and engine in ("tree", "pallas"):
        raise ValueError(
            f"engine '{engine}' has no score_dtype='{score_dtype}' path "
            "(matmul-form scoring exists for bruteforce and the tiled "
            "engines)")


def flat_fold_fn(engine: str, query_tile: int, point_tile: int,
                 score_dtype: str = "f32") -> Callable:
    """(rows, queries f32[Q, D], resident) -> rows: the fold of a flat
    engine (the JAX package's ``_engine_fn``); ``resident`` is what
    ``flat_resident`` made of a shard."""
    if engine == "bruteforce":
        return lambda rows, q, res: knn_update_bruteforce(
            rows, q, *res, query_tile=query_tile, point_tile=point_tile,
            score_dtype=score_dtype)
    if engine == "tree":
        return lambda rows, q, res: knn_update_tree(rows, q, *res)
    if engine == "pallas":
        return lambda rows, q, res: knn_update_bf_cuda(
            rows, q, *res, query_tile=query_tile, point_tile=point_tile)
    raise ValueError(f"'{engine}' is not a flat engine")


def flat_resident(engine: str, pts: torch.Tensor, ids: torch.Tensor):
    """A shard's point side for a flat engine: its kd-tree ``(tree,
    tree_ids)`` for ``tree`` (``build_tree``, which raises unless D is 3),
    else ``(pts, ids)``."""
    return build_tree(pts, ids) if engine == "tree" else (pts, ids)


def resolve_merge(merge: str, num_shards: int) -> str:
    """Where a chunked run merges the R shards' candidate rows: ``host``
    is the ring (each shard's rows end global, no merge), ``device``
    folds the whole chunk on every shard and merges the R partial rows on
    the card (``device_merge_final``). ``auto`` picks ``device`` at a
    power-of-two shard count and falls back to ``host`` with a logged
    warning otherwise (the tree reduction needs blocks that tile the
    shards); an explicit ``device`` there raises. Results are the same
    either way up to the order of exactly tied neighbors."""
    if merge == "auto":
        if num_shards & (num_shards - 1) == 0:
            return "device"
        if num_shards > 1:
            logging.getLogger(__name__).warning(
                "merge='auto': %d shards is not a power of two — "
                "falling back to the host-side merge (the device "
                "reduction needs the row blocks to tile the shards)",
                num_shards)
        return "host"
    if merge == "device":
        if num_shards & (num_shards - 1):
            raise ValueError(
                f"merge='device' needs a power-of-two shard count, got "
                f"{num_shards} (use merge='auto' to fall back to host)")
        return "device"
    if merge == "host":
        return "host"
    raise ValueError(f"unknown merge mode '{merge}' "
                     "(expected host | device | auto)")


def device_merge_final(states: list[CandidateState], via: str = "a2a"):
    """The global top-k of R per-shard candidate states for the SAME query
    rows, on the card: (dists f32[Q], CandidateState f32/i32[Q, k]).

    - ``a2a`` (default): each row's R*k candidates concatenated
      shard-major, then the k smallest by a stable sort (the JAX package's
      reduce-scatter and ``lax.top_k``, which prefers the lower column on
      ties: earlier shard, then earlier slot). ``torch.topk`` documents
      no tie order, so it is never used.
    - ``tree``: ``tree_merge_candidates``, the log2(R) recursive doubling,
      with the same tie order.
    """
    if via not in ("a2a", "tree"):
        raise ValueError(f"unknown device merge reduction '{via}'")
    num_shards = len(states)
    if num_shards == 1:
        st = states[0]
    elif via == "tree":
        st = tree_merge_candidates(states)
    else:
        rows, k = states[0].dist2.shape
        cat_d2 = torch.stack([s.dist2 for s in states], 1).view(
            rows, num_shards * k)
        cat_idx = torch.stack([s.idx for s in states], 1).view(
            rows, num_shards * k)
        top_d2, cols = torch.sort(cat_d2, dim=1, stable=True)
        st = CandidateState(top_d2[:, :k].contiguous(),
                            torch.gather(cat_idx, 1, cols[:, :k]))
    return extract_final_result(st), st


def resolve_bucket_size(bucket_size: int, engine: str) -> int:
    """0 = auto per engine, the JAX package's values: 128 for ``tiled``,
    256 for ``pallas_tiled``, 512 for the flat engines (which do not
    bucket). They come from the JAX package's tuning; no H100 sweep exists
    yet (ROADMAP.md Queue 2)."""
    if bucket_size:
        return bucket_size
    return {"tiled": 128, "pallas_tiled": 256}.get(engine, 512)


def resolve_query_buckets(query_buckets: int, qpad: int, k: int) -> int:
    """The serving engine's query-bucket count for one padded batch shape
    (0 = auto), the JAX package's rule: auto targets ``next_pow2(max(8,
    k))`` queries a bucket; explicit values round up to a power of two.
    The result divides ``qpad`` and leaves at least 8 rows a bucket; 1 is
    the single whole-batch bucket."""
    if qpad < 16:
        return 1
    cap = qpad // 8
    if query_buckets < 1:
        b = qpad // next_pow2(max(8, k))
    else:
        b = next_pow2(query_buckets)
    return max(1, min(b, cap))


def ring_total_rounds(num_shards: int) -> int:
    """Rounds for a full bidirectional sweep: the own shard at round 0,
    then offsets +-1, ..., +-floor(R/2)."""
    return num_shards // 2 + 1


def _folds_in_rounds(start: int, stop: int, num_shards: int) -> int:
    """Folds a shard runs in rounds [start, stop): 1 in round 0 and in the
    even-R antipodal round, else 2."""
    return sum(1 if (r == 0 or 2 * r == num_shards) else 2
               for r in range(start, stop))


def _ring_pair(rnd: int, num_shards: int) -> torch.Tensor:
    """i32[R, 2]: the shards that round ``rnd`` folds into shard i,
    forward and backward — the ring's rotating pair. On one card nothing
    rotates, so a checkpoint records it and a resume checks it."""
    i = torch.arange(num_shards, dtype=torch.int32)
    return torch.stack([(i - rnd) % num_shards, (i + rnd) % num_shards], 1)


def save_round(ckpt_dir: str, rnd: int, heaps: list, manifest: dict,
               extra: tuple = ()) -> None:
    """A stepwise loop's snapshot after ``rnd`` rounds: the rotating
    pair of the next round, every shard's rows, then ``extra`` tensors."""
    ckpt.save_tensors(ckpt_dir, rnd,
                      [_ring_pair(rnd, len(heaps))]
                      + [h.dist2 for h in heaps] + [h.idx for h in heaps]
                      + list(extra), manifest)


def load_round(ckpt_dir: str, manifest: dict, num_shards: int, device):
    """(round, rows, extra tensors) of ``save_round``'s snapshot, or None.
    Raises ValueError when its pair is not the one of its round."""
    got = ckpt.load_tensors(ckpt_dir, manifest, device)
    if got is None:
        return None
    rnd, tensors = got
    if not torch.equal(tensors[0].cpu(), _ring_pair(rnd, num_shards)):
        raise ValueError(f"checkpoint at {ckpt_dir}: its ring pair does "
                         "not match its round")
    rows = tensors[1:1 + 2 * num_shards]
    heaps = [CandidateState(d2, idx)
             for d2, idx in zip(rows[:num_shards], rows[num_shards:])]
    return rnd, heaps, tensors[1 + 2 * num_shards:]


def chunk_slabs(pts3: torch.Tensor, ids2: torch.Tensor, c: int,
                chunk_rows: int):
    """Chunk ``c`` of every shard's rows, sentinel-padded to
    ``chunk_rows``: (lo, hi, points f32[R, chunk_rows, D], ids
    i32[R, chunk_rows]) from the slabs ``pts3`` f32[R, Npad, D] and
    ``ids2`` i32[R, Npad]; rows [lo, hi) of each slab are real."""
    num_shards, npad, dim = pts3.shape
    lo = c * chunk_rows
    hi = min(lo + chunk_rows, npad)
    qp = torch.full((num_shards, chunk_rows, dim), PAD_SENTINEL,
                    device=pts3.device)
    qi = torch.full((num_shards, chunk_rows), -1, dtype=torch.int32,
                    device=pts3.device)
    qp[:, :hi - lo] = pts3[:, lo:hi]
    qi[:, :hi - lo] = ids2[:, lo:hi]
    return lo, hi, qp, qi


def host_rows(num_shards: int, npad: int, k: int, with_candidates: bool):
    """A chunked loop's results on the host: (dists f32[R, Npad] inf,
    and with ``with_candidates`` d2 f32[R, Npad, k] inf and ids
    i32[R, Npad, k] -1, else None and None)."""
    out_d = torch.full((num_shards, npad), torch.inf)
    if not with_candidates:
        return out_d, None, None
    return (out_d, torch.full((num_shards, npad, k), torch.inf),
            torch.full((num_shards, npad, k), -1, dtype=torch.int32))


def _effective_group(point_group: int, npad_local: int,
                     bucket_size: int, engine: str) -> int:
    """The point-side coarsening factor, clamped to the bucket count (both
    powers of two, so the clamped value divides). 0 = auto per engine, the
    JAX package's values: 2 for ``pallas_tiled``, 1 for every other."""
    if point_group == 0:
        point_group = 2 if engine == "pallas_tiled" else 1
    if point_group <= 1:
        return 1
    if point_group & (point_group - 1):
        raise ValueError(f"point_group must be a power of two, "
                         f"got {point_group}")
    return min(point_group, choose_buckets(npad_local, bucket_size)[0])


def _warm_tiles(engine: str, npad_local: int, bucket_size: int,
                num_shards: int) -> int:
    """[S, group*S] tiles the warm start scores: one a fine bucket, every
    shard (traversal self-joins only)."""
    if engine != "pallas_tiled":
        return 0
    return num_shards * choose_buckets(npad_local, bucket_size)[0]


def _ring_stats(engine: str, tiles_total: int, bucket_size: int,
                flat_pairs: int, *, q_rows: int, p_rows: int,
                point_group: int) -> dict:
    """Executed-work stats: distance pairs scored, as the JAX package
    counts them. One tile of a tiled engine is [S_q, group*S_p], S the
    padded bucket sizes of the query and point rows (the kernels count the
    buckets they visited, the twin ``C * V`` tiles for every chunk that
    ran); ``pallas`` and ``bruteforce`` score every pair, ``flat_pairs``;
    the tree's pruned work is not counted."""
    if engine == "tree":
        return {"pair_evals": 0, "tiles": 0, "flops_per_pair": 8,
                "note": "tree engine work is pruned and not counted"}
    if engine not in TILED_ENGINES:
        return {"pair_evals": int(flat_pairs), "tiles": 0,
                "flops_per_pair": 8}
    _, s_q = choose_buckets(q_rows, bucket_size)
    _, s_p = choose_buckets(p_rows, bucket_size)
    return {"pair_evals": int(tiles_total) * s_q * s_p * point_group,
            "tiles": int(tiles_total), "flops_per_pair": 8}


def _sum_visits(parts: list) -> int:
    """The tile counts the rounds returned (0-d device tensors from the
    kernels, ints from the twin, None for the flat engines), summed once at
    the end."""
    return int(sum(v for v in parts if v is not None))


@contextlib.contextmanager
def timed_stage(timers, name: str, device: torch.device):
    """``timers.phase(name)`` ended by a device synchronisation, so its time
    covers its device work, and the device spans inside it are settled;
    nothing when ``timers`` is None."""
    if timers is None:
        yield
        return
    with timers.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timers.settle()


def _sharded_input(points_sharded, ids_sharded, num_shards: int, device):
    """(points f32[R*Npad, D], ids i32[R*Npad]) on ``device`` (None = the
    card, which raises without CUDA), and the slabs: per shard (points,
    ids) views."""
    device = resolve_device(device)
    pts = torch.as_tensor(points_sharded, dtype=torch.float32, device=device)
    ids = torch.as_tensor(ids_sharded, dtype=torch.int32, device=device)
    npad = pts.shape[0] // num_shards
    slabs = [(pts[r * npad:(r + 1) * npad], ids[r * npad:(r + 1) * npad])
             for r in range(num_shards)]
    return pts, ids, slabs


class RingFns(NamedTuple):
    """The per-round pieces every ring loop runs (``_make_ring_fns``)."""

    #: (pts, ids) of one shard -> (stationary, resident): its query side
    #: (a partition, or the points for a flat engine) and its point side
    #: (the partition coarsened by the point group, or ``flat_resident``)
    shard_init_fn: Callable
    #: (stationary, resident) -> the shard's starting rows: warm-started
    #: with each query's own bucket where the caller asks for it
    rows_init_fn: Callable
    #: (qpts, qids) of a chunk -> (stationary, cold rows)
    query_init_fn: Callable
    #: (rows, stationary, resident, skip_self) -> (rows, tiles): one fold
    fold_fn: Callable
    #: (stationaries, ring, rows, rnd) -> (rows, tiles): round rnd for
    #: this process's shards, folding the copies ``ring`` (a
    #: ``ShardRing``) holds; tiles is a 0-d device tensor from the
    #: kernels, an int from the twin, None from the flat engines
    round_fn: Callable
    #: (stationaries, rows, n, with_candidates) -> (dists f32[R*n],
    #: CandidateState or None) in slab-row order, R the shards given
    final_fn: Callable


def _make_ring_fns(k, max_radius, engine, query_tile, point_tile,
                   bucket_size, num_shards, *, warm_start=False,
                   point_group=1, score_dtype="f32", timers=None) -> RingFns:
    """The per-round pieces of the stepwise and chunked loops.
    ``warm_start`` applies to self-joins of ``pallas_tiled``, whose query
    bucket b is point bucket b // group in round 0 (the JAX package keeps
    the twin cold); chunked queries are partitioned apart and always start
    cold. ``timers`` times each ``pallas_tiled`` fold's box order
    (``box_order``)."""
    flat = engine not in TILED_ENGINES
    warm_start = warm_start and engine == "pallas_tiled"
    if flat:
        flat_fold = flat_fold_fn(engine, query_tile, point_tile, score_dtype)

    def shard_init_fn(pts, ids):
        if flat:
            return pts, flat_resident(engine, pts, ids)
        q = partition_points(pts, ids, bucket_size=bucket_size)
        return q, coarsen_buckets(q, point_group)

    def cold_rows(stationary):
        if flat:
            return init_candidates(stationary.shape[0], k, max_radius,
                                   device=stationary.device)
        return init_candidates(stationary.ids.numel(), k, max_radius,
                               device=stationary.pts.device)

    def rows_init_fn(stationary, resident):
        if warm_start:
            return warm_start_self_cuda(resident, k, max_radius)
        return cold_rows(stationary)

    def query_init_fn(qpts, qids):
        stationary = (qpts if flat else
                      partition_points(qpts, qids, bucket_size=bucket_size))
        return stationary, cold_rows(stationary)

    def fold_fn(rows, stationary, resident, skip_self=False):
        if flat:
            return flat_fold(rows, stationary, resident), None
        if engine == "tiled":
            return knn_update_tiled(rows, stationary, resident,
                                    with_stats=True, skip_self=skip_self,
                                    self_group=point_group,
                                    score_dtype=score_dtype)
        rows, v = knn_update_tiled_cuda(rows, stationary, resident,
                                        skip_self=skip_self,
                                        self_group=point_group,
                                        with_stats=True,
                                        score_dtype=score_dtype,
                                        timers=timers)
        return rows, v.sum()

    def round_fn(stationary, ring, heaps, rnd):
        # after rnd rotations position i holds shard (i - rnd) % R
        # forward and (i + rnd) % R backward
        heaps, visits = list(heaps), []
        dup = rnd == 0 or 2 * rnd == num_shards
        for j in range(len(heaps)):
            heaps[j], v = fold_fn(heaps[j], stationary[j],
                                  ring.fwd[j].parts,
                                  skip_self=warm_start and rnd == 0)
            visits.append(v)
            if not dup:
                heaps[j], v = fold_fn(heaps[j], stationary[j],
                                      ring.bwd[j].parts)
                visits.append(v)
        return heaps, (None if flat else sum(visits))

    def final_fn(stationary, heaps, n, with_candidates):
        return final_rows(None if flat else stationary, heaps, n,
                          with_candidates)

    return RingFns(shard_init_fn, rows_init_fn, query_init_fn, fold_fn,
                   round_fn, final_fn)


def ring_knn(points_sharded, ids_sharded, k: int, num_shards: int, *,
             max_radius: float = float("inf"), engine: str = "auto",
             query_tile: int = 2048, point_tile: int = 2048,
             bucket_size: int = 0, point_group: int = 0,
             score_dtype: str = "f32", device=None, mesh: Mesh | None = None,
             return_candidates: bool = False, return_stats: bool = False,
             timers=None):
    """Run the full ring over ``num_shards`` shards on ``device`` (None =
    the card; without CUDA that raises).

    Args:
      points_sharded: f32[R*Npad, D] shard-major (shard r owns rows
        [r*Npad, (r+1)*Npad)), sentinel-padded; numpy or a tensor. With
        ``mesh``, this process's block only: its positions' slabs.
      ids_sharded: i32[R*Npad] global point ids (-1 for padding).
      engine: one of ``ENGINES`` (module docstring).
      query_tile / point_tile: the tiles of ``pallas`` and ``bruteforce``
        (results do not depend on them).
      score_dtype: "f32" or "bf16" (matmul-form scores, survivors rescored
        exactly); ``pallas`` and ``tree`` raise ValueError on "bf16".
      mesh: a ``parallel/mesh.py`` ``Mesh`` over a process group (its
        device replaces ``device``): the ring runs across its processes.

    Returns f32[R*Npad] k-th-NN distances (a tensor on ``device``; inf for
    the tiled engines' padding rows, which the flat engines fill with
    sentinel matches), plus the CandidateState in the same row order if
    ``return_candidates``, plus a stats dict if ``return_stats``. With
    ``mesh`` the rows are ``{position: f32[Npad]}`` (and ``{position:
    CandidateState}``) for this process's positions, and the stats count
    its own folds. ``timers`` (an ``obs.timers.PhaseTimers``) times the
    stages ``upload`` (the input onto the device), ``partition`` and
    ``warm_start`` (tiled engines and ``tree``, whose shard init builds its
    kd-tree), ``traverse`` and ``extract``, each ended by a device
    synchronisation, and the device span ``box_order`` of every
    ``pallas_tiled`` fold (inside ``traverse``).

    The rounds are stepped from the host either way, so this is
    ``ring_knn_stepwise`` without a checkpoint: one loop, the same bits
    and stats.
    """
    return ring_knn_stepwise(
        points_sharded, ids_sharded, k, num_shards, max_radius=max_radius,
        engine=engine, query_tile=query_tile, point_tile=point_tile,
        bucket_size=bucket_size, point_group=point_group,
        score_dtype=score_dtype, device=device, mesh=mesh,
        return_candidates=return_candidates, return_stats=return_stats,
        timers=timers)


def _resolve_mesh(mesh: Mesh | None, num_shards: int, device) -> Mesh:
    """The caller's mesh, checked against ``num_shards``, or every shard
    in this process on ``device``."""
    if mesh is None:
        return Mesh(num_shards, device, grouped=False)
    if mesh.num_shards != num_shards:
        raise ValueError(f"mesh of {mesh.num_shards} shards, asked for "
                         f"{num_shards}")
    return mesh


def by_position(mesh: Mesh, dists: torch.Tensor, cands, npad: int):
    """This process's shard-major rows -> ({position: dists}, {position:
    CandidateState} or None)."""
    rows = {s: slice(j * npad, (j + 1) * npad)
            for j, s in enumerate(mesh.positions)}
    return ({s: dists[r] for s, r in rows.items()},
            None if cands is None else
            {s: CandidateState(cands.dist2[r], cands.idx[r])
             for s, r in rows.items()})


def ring_knn_stepwise(points_sharded, ids_sharded, k: int, num_shards: int,
                      *, max_radius: float = float("inf"),
                      engine: str = "auto", query_tile: int = 2048,
                      point_tile: int = 2048, bucket_size: int = 0,
                      point_group: int = 0, score_dtype: str = "f32",
                      device=None, mesh: Mesh | None = None,
                      checkpoint_dir: str | None = None,
                      checkpoint_every: int = 1,
                      max_rounds: int | None = None,
                      return_candidates: bool = False,
                      return_stats: bool = False, timers=None):
    """``ring_knn`` with a checkpoint between rounds: every
    ``checkpoint_every`` rounds (and at the last round run) the round
    index, the rotating pair (``_ring_pair``), and every shard's rows go to
    ``checkpoint_dir``, and a relaunch with the same arguments resumes at
    that round, its rows loaded in place of the warm start. The
    fingerprint holds the run's configuration and a sampled digest of the
    input; a mismatch raises ValueError. A completed run clears its
    checkpoint. ``max_rounds`` stops early (state saved), for staged runs
    and interruption tests. Round checkpoints are single-process: with a
    ``mesh`` ``checkpoint_dir`` raises ValueError.

    Returns what ``ring_knn`` returns, the same bits; its stats count the
    warm start only in the run that did it. ``timers`` times what
    ``ring_knn``'s does; ``warm_start`` covers a checkpoint's load and
    ``traverse`` its writes and the rotations."""
    engine = resolve_engine(engine)
    _check_score_dtype(engine, score_dtype)
    bucket_size = resolve_bucket_size(bucket_size, engine)
    grouped = mesh is not None
    if grouped and checkpoint_dir:
        raise ValueError("multi-host --checkpoint-dir requires "
                         "--query-chunk (per-chunk result checkpoints; "
                         "round-level heap snapshots are single-host only)")
    mesh = _resolve_mesh(mesh, num_shards, device)
    n_mine = len(mesh.positions)
    with timed_stage(timers, "upload", mesh.device):
        pts, _ids, slabs = _sharded_input(points_sharded, ids_sharded,
                                          n_mine, mesh.device)
    npad = pts.shape[0] // n_mine
    group = _effective_group(point_group, npad, bucket_size, engine)
    fp = None
    if checkpoint_dir:
        fp = ckpt.fingerprint(
            n=int(pts.shape[0]), k=int(k), shards=num_shards, engine=engine,
            max_radius=float(max_radius), bucket_size=bucket_size,
            # keys present only when not the JAX package's defaults
            **({"point_group": group} if group > 1 else {}),
            **({"score_dtype": score_dtype} if score_dtype != "f32" else {}),
            query_tile=query_tile, point_tile=point_tile, ring="bidir",
            data=ckpt.data_digest(points_sharded, ids_sharded))
    fns = _make_ring_fns(k, max_radius, engine, query_tile, point_tile,
                         bucket_size, num_shards, warm_start=True,
                         point_group=group, score_dtype=score_dtype,
                         timers=timers)
    # shard init partitions (tiled engines) or builds the kd-tree (tree)
    tiled_timers = (None if engine in ("pallas", "bruteforce") else
                    timers)

    with timed_stage(tiled_timers, "partition", pts.device):
        parts = [fns.shard_init_fn(p, i) for p, i in slabs]
    stationary = [s for s, _ in parts]
    resident = [r for _, r in parts]
    start = 0
    with timed_stage(tiled_timers, "warm_start", pts.device):
        # a resumed run's rows come from the checkpoint (saved after at
        # least one round, so round 0's skip_self never meets them)
        got = (load_round(checkpoint_dir, fp, num_shards, pts.device)
               if checkpoint_dir else None)
        if got is not None:
            start, heaps, _ = got
        else:
            heaps = [fns.rows_init_fn(s, r) for s, r in parts]

    total = ring_total_rounds(num_shards)
    stop = total if max_rounds is None else min(max_rounds, total)
    ring = ShardRing(mesh, resident, start)
    visits = []
    with timed_stage(timers, "traverse", pts.device):
        for r in range(start, stop):
            heaps, v = fns.round_fn(stationary, ring, heaps, r)
            visits.append(v)
            if r + 1 < stop:
                ring.rotate()
            if checkpoint_dir and ((r + 1) % checkpoint_every == 0
                                   or r + 1 == stop):
                save_round(checkpoint_dir, r + 1, heaps, fp)
    with timed_stage(timers, "extract", pts.device):
        dists, cands = fns.final_fn(stationary, heaps, npad,
                                    return_candidates)
    if checkpoint_dir and stop == total:
        # done: a later run in the same directory never resumes past its
        # own work
        ckpt.clear(checkpoint_dir)
    if grouped:
        dists, cands = by_position(mesh, dists, cands, npad)
    out = (dists,)
    if return_candidates:
        out += (cands,)
    if return_stats:
        tiles = _sum_visits(visits)
        if got is None:
            # the warm start ran in THIS run
            tiles += _warm_tiles(engine, npad, bucket_size, n_mine)
        out += (_ring_stats(
            engine, tiles, bucket_size,
            _folds_in_rounds(start, stop, num_shards) * n_mine
            * npad * npad,
            q_rows=npad, p_rows=npad, point_group=group),)
    return out if len(out) > 1 else out[0]


def chunk_bucket(q: torch.Tensor) -> BucketedPoints:
    """A device-merge chunk f32[Q, D] as ONE query bucket of Q rows: ids
    ``arange(Q)`` on real rows and -1 on sentinel ones, the box of the
    real rows, ``pos = ids`` (the JAX package's device-merge program)."""
    rows = q.shape[0]
    valid = q[:, 0] < PAD_SENTINEL / 2
    qids = torch.where(valid, torch.arange(rows, dtype=torch.int32,
                                           device=q.device), -1)
    box = aabb_of_points(q, valid)
    return BucketedPoints(q[None], qids[None], box.lower[None],
                          box.upper[None], qids[None])


def ring_knn_chunked(points_sharded, ids_sharded, k: int, num_shards: int,
                     *, chunk_rows: int, max_radius: float = float("inf"),
                     engine: str = "auto", query_tile: int = 2048,
                     point_tile: int = 2048, bucket_size: int = 0,
                     point_group: int = 0, score_dtype: str = "f32",
                     device=None, mesh: Mesh | None = None,
                     checkpoint_dir: str | None = None,
                     checkpoint_every: int = 1,
                     max_chunks: int | None = None, pipeline_depth: int = 2,
                     merge: str = "host", return_candidates: bool = False,
                     return_stats: bool = False, timers=None):
    """``ring_knn`` with the query side streamed in chunks of
    ``chunk_rows`` rows a shard.

    The memory wall at scale is the candidate rows, N*k*8 bytes (at k=100
    ~67x the points). Every shard's whole point side stays resident
    (partitioned once, coarsened by the point group); rows are held for
    one chunk of queries at a time, so they take R*chunk_rows*k*8 bytes.

    - ``merge="host"``: the ring per chunk. Each shard's chunk is
      partitioned on its own (``choose_buckets(chunk_rows)``), starts cold
      (no warm start, no ``skip_self``: a chunk folds its own points once,
      as neighbors) and meets every shard over the R//2+1 rounds, from a
      pristine pair (the resident sides never move).
    - ``merge="device"``: the R shards' chunk rows gathered into ONE
      query bucket of R*chunk_rows rows (``chunk_bucket``), folded by
      every shard's resident side, the R partial rows merged by
      ``device_merge_final``. A flat engine folds the same gathered
      chunk. ``auto`` resolves by ``resolve_merge``.

    Distances are the same bits either way; at equal distances the two
    order ids differently (the ring by fold arrival, the device merge by
    shard then slot), both exact top-k. ``pipeline_depth`` chunks may
    have their result copies to the host pending: a chunk's rows are
    fetched only once ``pipeline_depth`` chunks wait, so the card works
    on the next chunk meanwhile; results are bit-identical at any depth (1
    is the serialized loop). With ``checkpoint_dir`` the finished chunks'
    results are saved every ``checkpoint_every`` chunks (after a full
    drain) and a relaunch resumes at the first unfinished chunk;
    ``max_chunks`` stops early.

    With ``mesh`` (a process group): the input is this process's block,
    each process chunks its own positions, checkpoints its own rows (in
    ``checkpoint_dir/host<rank>``, its positions in the fingerprint), and
    gets ``{position: rows}``; the device merge gathers each chunk to
    every process and reduces the R partial rows over the group.

    Returns ``ring_knn``'s outputs as tensors on the HOST (where the rows
    are gathered): f32[R*Npad] distances, the CandidateState with
    ``return_candidates``, and stats with ``return_stats``. ``timers``
    times ``partition`` (the resident sides) and ``chunks`` (the loop and
    its last fetch), as well as ``upload`` and ``box_order`` as
    ``ring_knn``'s do.
    """
    engine = resolve_engine(engine)
    _check_score_dtype(engine, score_dtype)
    bucket_size = resolve_bucket_size(bucket_size, engine)
    merge = resolve_merge(merge, num_shards)
    grouped = mesh is not None
    mesh = _resolve_mesh(mesh, num_shards, device)
    n_mine = len(mesh.positions)
    with timed_stage(timers, "upload", mesh.device):
        pts, ids, slabs = _sharded_input(points_sharded, ids_sharded,
                                         n_mine, mesh.device)
    dev = pts.device
    npad = pts.shape[0] // n_mine
    dim = pts.shape[1]
    n_chunks = max(1, cdiv(npad, chunk_rows))
    group = _effective_group(point_group, npad, bucket_size, engine)
    fns = _make_ring_fns(k, max_radius, engine, query_tile, point_tile,
                         bucket_size, num_shards, point_group=group,
                         score_dtype=score_dtype, timers=timers)
    flat = engine not in TILED_ENGINES
    with timed_stage(timers, "partition", dev):
        # Copy objects: a staged copy keeps its host bytes across chunks
        resident = [Copy(fns.shard_init_fn(p, i)[1]) for p, i in slabs]

    out_d, out_hd2, out_idx = host_rows(n_mine, npad, k, return_candidates)
    fp = None
    start_chunk = 0
    ckpt_dir = checkpoint_dir
    if checkpoint_dir:
        if grouped:
            # each process owns (and resumes) exactly its rows
            ckpt_dir = os.path.join(checkpoint_dir, f"host{mesh.rank}")
        fp = ckpt.fingerprint(
            n=num_shards * npad, k=int(k), shards=num_shards,
            engine=engine, max_radius=float(max_radius),
            bucket_size=bucket_size, chunk_rows=chunk_rows,
            query_tile=query_tile, point_tile=point_tile,
            candidates=bool(return_candidates),
            **({"merge": merge} if merge == "device" else {}),
            **({"score_dtype": score_dtype} if score_dtype != "f32" else {}),
            my_pos=",".join(str(s) for s in mesh.positions),
            data=ckpt.data_digest(points_sharded, ids_sharded))
        got = ckpt.load_ring_state(ckpt_dir, fp)
        if got is not None:
            start_chunk, arrs = got
            out_d = torch.from_numpy(arrs["out_d"])
            if return_candidates:
                out_hd2 = torch.from_numpy(arrs["out_hd2"])
                out_idx = torch.from_numpy(arrs["out_idx"])

    pts3 = pts.view(n_mine, npad, dim)
    ids2 = ids.view(n_mine, npad)
    stop_chunk = n_chunks if max_chunks is None else min(max_chunks,
                                                         n_chunks)
    total_rounds = ring_total_rounds(num_shards)
    depth = max(1, int(pipeline_depth))
    pending = []  # (lo, hi, host copies, their event): not fetched yet
    visits = []
    chunks_run = 0

    def stage(c):
        # chunk c's query sides on the card: partitions with cold rows
        # (ring), or the chunk of every position (device merge)
        lo, hi, qp, qi = chunk_slabs(pts3, ids2, c, chunk_rows)
        if merge == "device":
            return lo, hi, mesh.gather_positions(qp).view(-1, dim), None
        parts = [fns.query_init_fn(qp[s], qi[s]) for s in range(n_mine)]
        return lo, hi, [s for s, _ in parts], [h for _, h in parts]

    def start_fetch(lo, hi, d, cands):
        ts = [d] + ([cands.dist2, cands.idx] if return_candidates else [])
        if dev.type != "cuda":
            return lo, hi, ts, None
        host = [t.to("cpu", non_blocking=True) for t in ts]
        done = torch.cuda.Event()
        done.record()
        return lo, hi, host, done

    def drain_one():
        # the OLDEST pending chunk: waits for its copies only, later
        # chunks' folds stay queued on the card
        lo, hi, host, done = pending.pop(0)
        if done is not None:
            done.synchronize()
        n = hi - lo
        out_d[:, lo:hi] = host[0].view(n_mine, chunk_rows)[:, :n]
        if return_candidates:
            out_hd2[:, lo:hi] = host[1].view(n_mine, chunk_rows, k)[:, :n]
            out_idx[:, lo:hi] = host[2].view(n_mine, chunk_rows, k)[:, :n]

    with timed_stage(timers, "chunks", dev):
        staged = stage(start_chunk) if start_chunk < stop_chunk else None
        for c in range(start_chunk, stop_chunk):
            lo, hi, stationary, heaps = staged
            chunks_run += 1
            if merge == "device":
                qb = stationary if flat else chunk_bucket(stationary)
                states = []
                for s in range(n_mine):
                    st, v = fns.fold_fn(
                        init_candidates(stationary.shape[0], k, max_radius,
                                        device=dev), qb, resident[s].parts)
                    states.append(st)
                    visits.append(v)
                d, cands = merge_over_mesh(mesh, states, chunk_rows)
            else:
                # a pristine pair every chunk
                ring = ShardRing(mesh, resident)
                for rnd in range(total_rounds):
                    heaps, v = fns.round_fn(stationary, ring, heaps, rnd)
                    visits.append(v)
                    if rnd + 1 < total_rounds:
                        ring.rotate()
                del ring
                d, cands = fns.final_fn(stationary, heaps, chunk_rows,
                                        return_candidates)
            pending.append(start_fetch(lo, hi, d, cands))
            del stationary, heaps, d, cands
            while len(pending) >= depth:
                drain_one()
            if c + 1 < stop_chunk:
                staged = stage(c + 1)
            ckpt_due = checkpoint_dir and ((c + 1) % checkpoint_every == 0
                                           or c + 1 == stop_chunk)
            if ckpt_due:
                while pending:
                    drain_one()
                arrs = {"out_d": out_d}
                if return_candidates:
                    arrs.update(out_hd2=out_hd2, out_idx=out_idx)
                ckpt.save_ring_state(ckpt_dir, c + 1, arrs, fp)
        while pending:
            drain_one()
    if checkpoint_dir and stop_chunk == n_chunks:
        ckpt.clear(ckpt_dir)

    dists = out_d.view(-1)
    cands = (CandidateState(out_hd2.view(-1, k), out_idx.view(-1, k))
             if return_candidates else None)
    if grouped:
        dists, cands = by_position(mesh, dists, cands, npad)
    out = (dists,)
    if return_candidates:
        out += (cands,)
    if return_stats:
        tiles = _sum_visits(visits)
        if merge == "device" and not flat:
            # a device-merge visit is a tile of the chunk's single query
            # bucket (R*chunk_rows rows) by a coarsened point bucket
            _, s_p = choose_buckets(npad, bucket_size)
            stats = {"pair_evals": tiles * num_shards * chunk_rows * s_p
                     * group, "tiles": tiles, "flops_per_pair": 8}
        else:
            stats = _ring_stats(
                engine, tiles, bucket_size,
                chunks_run * n_mine * num_shards * chunk_rows * npad,
                q_rows=chunk_rows, p_rows=npad, point_group=group)
        out += (stats,)
    return out if len(out) > 1 else out[0]


def merge_over_mesh(mesh: Mesh, states: list[CandidateState],
                    chunk_rows: int):
    """The device merge of a gathered chunk (R*chunk_rows rows) across a
    mesh: ``states`` are this process's shards' partial rows of the whole
    chunk; returns ``device_merge_final`` of the rows of this process's
    positions (dists f32[n_mine*chunk_rows], CandidateState), every
    shard's partial rows in ascending shard order, as in one process. In
    a group the rows travel by one ``all_to_all`` (ids as their f32
    bits), padded to the widest process's positions."""
    if not mesh.grouped:
        return device_merge_final(states)
    c = chunk_rows
    n_mine = len(states)
    width = mesh.width()
    k = states[0].dist2.shape[1]
    both = torch.stack([torch.stack([s.dist2, s.idx.view(torch.float32)],
                                    -1) for s in states])
    send = torch.zeros((mesh.world, width, width * c, k, 2),
                       dtype=torch.float32, device=both.device)
    for p in range(mesh.world):
        sp = mesh.span(p)
        send[p, :n_mine, :len(sp) * c] = both[:, sp.start * c:sp.stop * c]
    recv = mesh.all_to_all(send)
    parts = []
    for p in range(mesh.world):
        for m in range(len(mesh.span(p))):
            blk = recv[p, m, :n_mine * c]
            parts.append(CandidateState(
                blk[..., 0].contiguous(),
                blk[..., 1].contiguous().view(torch.int32)))
    return device_merge_final(parts)


def measure_exchange_bandwidth(mesh: Mesh, npad_local: int, *,
                               reps: int = 10, bucket_size: int = 0,
                               engine: str = "auto") -> dict:
    """MEASURED ring-rotation bandwidth (not analytic), with the JAX
    package's keys.

    A representative shard of ``npad_local`` D=3 points, as the ring
    rotates it (the partition's points, ids and boxes on the tiled
    engines, else points and ids), moved in both directions at once, best
    of ``reps``, minus a control with no communication:

    - in a process group of more than one process: ``ShardRing.rotate``
      of the process's copies, which is what the group moves (staged
      through pinned host memory where gloo serves a card), minus a
      no-payload barrier of the group; the aggregate counts the P
      processes' boundary copies;
    - in one process (R virtual shards): nothing crosses a process, so it
      times a device copy of the bytes a round moves (both copies of
      every position), minus an empty synchronisation; the aggregate
      counts the R positions.

    ``exchange_GB_per_sec_per_link`` is one position's (one process's)
    two copies over the round's seconds."""
    engine = resolve_engine(engine)
    bucket_size = resolve_bucket_size(bucket_size, engine)
    dev = mesh.device
    if engine in TILED_ENGINES:
        nb, s = choose_buckets(npad_local, bucket_size)
        ids = torch.zeros((nb, s), dtype=torch.int32, device=dev)
        shard = BucketedPoints(torch.zeros((nb, s, 3), device=dev), ids,
                               torch.zeros((nb, 3), device=dev),
                               torch.zeros((nb, 3), device=dev), ids)
    else:
        shard = (torch.zeros((npad_local, 3), device=dev),
                 torch.zeros((npad_local,), dtype=torch.int32, device=dev))
    shard_bytes = shard_nbytes(shard)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best_of(fn):
        fn()  # warm
        sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    if mesh.grouped and mesh.world > 1:
        ring = ShardRing(mesh, [shard] * len(mesh.positions))
        seconds0, bytes0 = mesh.exchange_seconds, mesh.exchange_bytes
        t_rot = best_of(ring.rotate)
        # the measurement is not the run's exchange
        mesh.exchange_seconds, mesh.exchange_bytes = seconds0, bytes0
        t_ctl = best_of(mesh.barrier)
        staged = " staged through pinned host memory" if mesh.staged else ""
        method = (f"bidirectional rotation of both copies through the "
                  f"{mesh.backend} process group{staged}, best of {reps}, "
                  "minus a no-payload barrier")
        movers = mesh.world
    else:
        tensors = shard_tensors(shard) * (2 * mesh.num_shards)
        t_rot = best_of(lambda: [t.clone() for t in tensors])
        t_ctl = best_of(lambda: None)
        method = (f"device copy of both copies of every position on {dev} "
                  f"(R virtual shards in one process: nothing crosses a "
                  f"process), best of {reps}, minus an empty "
                  "synchronisation")
        movers = mesh.num_shards
    t_comm = max(t_rot - t_ctl, 1e-9)
    round_bytes = 2 * shard_bytes  # both directions
    return {
        "method": method,
        "platform": dev.type,
        "num_shards": mesh.num_shards,
        "shard_bytes": shard_bytes,
        "round_seconds": round(t_comm, 6),
        "control_seconds": round(t_ctl, 6),
        "exchange_GB_per_sec_per_link": round(round_bytes / t_comm / 1e9, 3),
        "exchange_GB_per_sec_aggregate": round(
            movers * round_bytes / t_comm / 1e9, 3),
    }


def final_rows(qs, heaps, npad: int, with_candidates: bool):
    """Per-shard heaps to slab-row order: f32[R*npad] k-th-NN distances
    (inf where a tiled engine has no real query) and, with
    ``with_candidates``, the CandidateState rows (else None). ``qs`` are
    the per-shard partitions of bucket-order heaps; None means the heaps
    are in slab-row order already (the flat engines)."""
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
