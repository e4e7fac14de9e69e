"""Resident query engine: the index lives on the card, queries fly through.

The port of the JAX package's ``serve/engine.py`` (``ResidentKnnEngine``,
single process). Build once: the point set is cut into R
slabs (``slab_bounds``), each a virtual shard on the one card, and each
slab is median-split into spatial buckets (``ops/partition.py``
``partition_points``, the partition the ring drivers use). For the
traversal kernel the point side of every shard is also laid out once for
the kernels (``ops/knn_tiled.py`` ``prepare_points``: the D=3 lanes, the
ring layout, or the bf16 halves and ``|p|^2``), the counterpart of the JAX
engine's resident ``point_norms2``, so a served batch pays only its own
query side. Query forever: an incoming batch is padded to its shape
bucket, traversed against each shard's resident buckets (each shard's
local top-k), and the R partial candidate rows are reduced to the global
top-k on the host (``_merge_shard_candidates``) or on the card
(``parallel/ring.py`` ``device_merge_final``), the two bit-identical, ties
included.

Shape discipline: every power-of-two batch bucket from ``min_batch`` to
``max_batch`` has one fixed-shape launch plan, built on first use and
counted in ``compile_count`` (there is no XLA here: a plan is the query
bucketing, the kernel's route for those shapes and the tile ceiling, what
the JAX engine's AOT executable fixes). After ``warmup()`` no client batch
size builds another. A batch wider than ``max_batch`` raises
``UnservableShapeError``. ``auto`` is ``pallas_tiled``, the traversal
kernel. On the card a kernel failure raises and fails its request; on the
CPU, where the kernel is its plain version, a runtime failure degrades to
the twin ``tiled`` (``degrade()``, driven by serve/admission.py).

Pipelining: ``dispatch`` stages the padded batch and its radius rows from
pinned host memory (``non_blocking``) onto the engine's own CUDA stream,
enqueues the traversal, the device merge and the copies of the result
back to pinned host memory on it, records an event and returns without
waiting: the stream is the card's launch queue (the JAX engine's launch
pool stands in for it on backends that execute synchronously).
``complete`` waits on that event, merges on the host where asked, and
undoes the Morton admission sort. On the CPU (``device="cpu"``) dispatch
computes in place and ``complete`` only finishes.

Slab engines (serve/slabpool.py): ``id_offset`` makes the ids global rows
of a larger index, ``emit="candidates"`` completes with the full ascending
(dist2, id) rows (``complete_candidates``) for the pool's fold, ``timers``
and ``plan_cache`` are shared by every slab engine of a pool, and
``pad_shard_rows`` pads every shard to the pool's common shape class, so
one launch plan per shape bucket serves every slab through eviction and
re-promotion. On the card an engine builds on its own stream (the one its
batches run on), so a promotion thread can build one while others serve.

Pod mode: given a ``Mesh`` (parallel/mesh.py) that spans processes, the
SAME engine runs on every host of a replicate pod: every host loads the
whole point set but uploads only the slabs of its own ring positions,
traverses the (front-end-replicated) batch against them, and the device
merge runs across the processes (``parallel/ring.py`` ``merge_over_mesh``:
one ``all_to_all`` of the partial rows a batch, then the same stable merge
as in one process), after which each host holds the final rows of its
positions' 1/R row slices and fetches only those (``complete_slices``),
so the pod's fetched result bytes equal one result. The merge is a
collective: every host must dispatch identical batches in the same order
(the front end's contract, serve/frontend.py), and ``dispatch`` validates
a batch before the collective, so a bad batch fails on every host alike.
Host merge would need partial rows no process holds, so pod mode requires
``merge="device"``. A mesh inside one process changes nothing.

Query locality: at D=3 on the tiled engines ``dispatch`` sorts each batch
by Morton code over the index bounding box (pads last), and the traversal
walks ``query_buckets`` contiguous slices of the sorted batch, each with
its own box and radius; ``complete`` un-permutes. The traversal runs with
the canonical (dist2, id) tie order while ids stay below 2**24, which makes
the result bit-identical across bucketings. The tile counters
(``tiles_executed`` / ``tiles_skipped``, tile-row units) make the prune a
number.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from mpi_cuda_largescaleknn_torch.analysis.annotations import guarded_by
from mpi_cuda_largescaleknn_torch.core.config import resolve_device
from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
from mpi_cuda_largescaleknn_torch.models.sharding import (
    pad_and_flatten,
    slab_aabbs,
    slab_bounds,
)
from mpi_cuda_largescaleknn_torch.obs.timers import PhaseTimers
from mpi_cuda_largescaleknn_torch.ops.brute_force import knn_update_bruteforce
from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
from mpi_cuda_largescaleknn_torch.ops.distance import (
    mxu_min_dim,
    norms2,
    validate_score_dtype,
)
from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
    knn_update_tiled_cuda,
    prepare_points,
)
from mpi_cuda_largescaleknn_torch.ops.partition import (
    BucketedPoints,
    partition_points,
)
from mpi_cuda_largescaleknn_torch.ops.tiled import (
    knn_update_tiled,
    tile_schedule_slots,
)
from mpi_cuda_largescaleknn_torch.parallel.ring import (
    TILED_ENGINES,
    device_merge_final,
    merge_over_mesh,
    resolve_bucket_size,
    resolve_engine,
    resolve_merge,
    resolve_query_buckets,
)
from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort, next_pow2

#: the engines a served batch can take: the traversal kernel (``auto``),
#: its twin, and the flat twin (the JAX serving engine's flat engine is
#: the XLA ``bruteforce``, not the flat Pallas kernel)
SERVE_ENGINES = ("auto", "pallas_tiled", "tiled", "bruteforce")


class UnservableShapeError(ValueError):
    """A batch no shape bucket covers reached the engine (the admission
    layer should have rejected or split it)."""


class LaunchPlanCache:
    """Launch plans shared across engines, keyed by resident SHAPE CLASS:
    the counterpart of the JAX package's ``ExecutableCache``.

    A plan fixes the shapes of a batch's launches, not the values of the
    resident operands, so engines whose resident sides share a shape class
    (the same padded shard rows, bucket geometry, dim and dtypes; the slab
    pool pads every slab engine to one class for exactly this) reuse ONE
    plan. ``compiles`` counts the plans built, pool-wide: it stays flat
    through eviction and re-promotion. A concurrent miss on a key that
    another engine is building waits for it instead of building twice."""

    def __init__(self):
        self._cv = threading.Condition()
        # every read and write under the lock (the promotion thread and
        # the stall path both build engines)
        self._cache: guarded_by("_cv") = {}
        #: keys some caller is building: a concurrent miss waits
        self._building: guarded_by("_cv") = set()
        self.compiles: guarded_by("_cv") = 0
        self.hits: guarded_by("_cv") = 0

    def get(self, key):
        """The cached plan, or None with the key CLAIMED for building: the
        caller then MUST ``put`` it (or ``abort`` on failure)."""
        with self._cv:
            while True:
                lp = self._cache.get(key)
                if lp is not None:
                    self.hits += 1
                    return lp
                if key in self._building:
                    self._cv.wait(0.05)
                    continue
                self._building.add(key)
                return None

    def put(self, key, lp) -> None:
        with self._cv:
            self._cache.setdefault(key, lp)
            self._building.discard(key)
            self.compiles += 1
            self._cv.notify_all()

    def abort(self, key) -> None:
        """Release a claimed key after a failed build (waiters retry)."""
        with self._cv:
            self._building.discard(key)
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {"programs": len(self._cache),
                    "compiles": self.compiles, "hits": self.hits,
                    "shapes": sorted({k[2] for k in self._cache})}


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host rows onto ``dev``: on the card through pinned staging and a
    non-blocking copy on the current stream (the caching host allocator
    keeps the pinned block until the copy has run)."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def batch_buckets(q: torch.Tensor, qb: int) -> BucketedPoints:
    """The query side of one padded batch f32[qpad, D]: ``qb`` contiguous
    buckets of its rows, each with its own tight box over its real rows
    (pad rows, at ``PAD_SENTINEL``, get id -1; an all-pad bucket gets
    inverted bounds and is never visited). Row ids are the batch rows."""
    qpad, dim = q.shape
    s_q = qpad // qb
    valid = q[:, 0] < PAD_SENTINEL / 2
    qids = torch.where(valid, torch.arange(qpad, dtype=torch.int32,
                                           device=q.device), -1)
    qg = q.view(qb, s_q, dim)
    vg = valid.view(qb, s_q, 1)
    return BucketedPoints(qg, qids.view(qb, s_q),
                          torch.where(vg, qg, torch.inf).amin(dim=1),
                          torch.where(vg, qg, -torch.inf).amax(dim=1),
                          qids.view(qb, s_q))


class _LaunchPlan:
    """One fixed-shape launch plan: the engine, padded batch ``qpad``,
    query buckets ``qb`` of ``s_q`` rows and recall-plan knobs
    (``plan_key``) it was built for, and the batch's static tile ceiling
    in tile-row units (``tiles_possible``)."""

    __slots__ = ("engine_name", "qpad", "qb", "s_q", "plan_key",
                 "tiles_possible")

    def __init__(self, engine_name, qpad, qb, plan_key, tiles_possible):
        self.engine_name = engine_name
        self.qpad = qpad
        self.qb = qb
        self.s_q = qpad // qb
        self.plan_key = plan_key
        self.tiles_possible = tiles_possible


class _InFlightBatch:
    """A dispatched-but-uncompleted engine call (``dispatch`` ->
    ``complete``).

    ``result`` holds what ``complete`` reads: (a, b, tiles) host tensors,
    the R partial [R*qpad, k] rows under ``merge="host"``, the final
    ([qpad], [qpad, k]) under ``merge="device"`` (the merged candidate
    rows ([qpad, k], [qpad, k]) under ``emit="candidates"``); ``done`` is
    the CUDA event recorded after their copies to pinned host memory (None
    on the CPU). ``queries`` retains the ORIGINAL (unsorted) host batch, so a
    completion-time failure can be replayed on the degraded twin.
    ``engine_name`` records which engine dispatched it; ``perm`` is the
    Morton admission sort (None when off): staged row i is
    ``queries[perm[i]]``. ``tiles_possible`` is the plan's tile ceiling,
    ``plan`` the recall plan it was dispatched under (None = exact)."""

    __slots__ = ("queries", "n", "qpad", "engine_name", "merge_mode",
                 "result", "done", "t0", "perm", "tiles_possible", "plan")

    def __init__(self, queries, n, qpad, engine_name, merge_mode, result,
                 done, t0, perm=None, tiles_possible=0, plan=None):
        self.queries = queries
        self.n = n
        self.qpad = qpad
        self.engine_name = engine_name
        self.merge_mode = merge_mode
        self.result = result
        self.done = done
        self.t0 = t0
        self.perm = perm
        self.tiles_possible = tiles_possible
        self.plan = plan


class ResidentKnnEngine:
    """One resident index over ``num_shards`` virtual shards on one card,
    and a family of fixed-shape launch plans.

    ``device=None`` is the card (it raises without CUDA); ``device="cpu"``
    runs the kernels' plain versions. ``emit="final"`` completions carry
    the (k-th distance, ids) answer; ``emit="candidates"`` engines complete
    with the full candidate rows (``complete_candidates``), the partial a
    slab pool folds. ``id_offset``, ``timers``, ``plan_cache`` and
    ``pad_shard_rows`` are what a slab pool hands each slab engine.
    ``mesh`` (parallel/mesh.py ``Mesh``) sets the shard count and the
    device; a mesh across processes puts the engine in pod mode (see the
    module's docstring)."""

    def __init__(self, points: np.ndarray, k: int, *, num_shards: int = 1,
                 mesh=None,
                 engine: str = "auto", bucket_size: int = 0,
                 max_radius: float = math.inf, max_batch: int = 1024,
                 min_batch: int = 8, merge: str = "auto",
                 query_buckets: int = 0, score_dtype: str = "f32",
                 id_offset: int = 0, emit: str = "final",
                 timers: PhaseTimers | None = None,
                 plan_cache: LaunchPlanCache | None = None,
                 pad_shard_rows: int = 0, device=None):
        points = np.asarray(points, np.float32)
        if points.ndim != 2 or points.shape[1] < 1:
            raise ValueError(f"points must be [N, D], got {points.shape}")
        if k < 1:
            raise ValueError("k must be >= 1")
        if engine not in SERVE_ENGINES:
            raise ValueError(f"unknown serving engine '{engine}' (expected "
                             f"one of {SERVE_ENGINES})")
        if mesh is not None:
            if num_shards not in (1, mesh.num_shards):
                raise ValueError(f"num_shards={num_shards} disagrees with "
                                 f"the mesh's {mesh.num_shards} positions")
            num_shards = mesh.num_shards
            if device is None:
                device = mesh.device
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if emit not in ("final", "candidates"):
            raise ValueError(f"emit must be 'final' or 'candidates', "
                             f"got {emit!r}")
        self.device = resolve_device(device)
        min_batch = max(8, next_pow2(min_batch))
        max_batch = next_pow2(max_batch)
        self.k = int(k)
        self.n_points = len(points)
        #: global row of this engine's first point: a slab engine serves
        #: one slab of a larger index, and its neighbor ids are GLOBAL
        #: rows, so the canonical (dist2, id) tie order matches one engine
        #: over the whole index bit for bit
        self.id_offset = int(id_offset)
        #: what completions carry: "final" = (k-th distance, ids);
        #: "candidates" = the full (dist2[Q, k], ids) rows, a PARTIAL the
        #: slab pool folds across slabs (``complete_candidates``)
        self.emit = emit
        #: a slab engine keeps a reference to its host rows (the caller's
        #: array, not a copy): an evicted engine demotes them to the slab
        #: pool's host tier
        self.host_points = points if emit == "candidates" else None
        #: pod mode: the mesh spans processes — every host runs ONE
        #: engine over the same mesh, dispatches IDENTICAL batches in the
        #: same order (the front end's contract) and fetches only its 1/R
        #: row slices of the pod-final answer (``complete_slices``)
        self.mesh = mesh
        self._multi = mesh is not None and mesh.world > 1
        self.process_index = mesh.rank if self._multi else 0
        self.process_count = mesh.world if self._multi else 1
        self.dim = int(points.shape[1])
        self.max_radius = float(max_radius)
        self.num_shards = int(num_shards)
        engine_name = resolve_engine(engine)
        self.bucket_size = resolve_bucket_size(bucket_size, engine_name)
        self.merge_mode = resolve_merge(merge, self.num_shards)
        if self._multi and self.merge_mode != "device":
            raise ValueError(
                "multi-host serving requires the device-side merge (the R "
                "partial candidate blocks live in processes this one "
                "cannot address) — got merge="
                f"'{self.merge_mode}' on a {self.num_shards}-shard pod "
                "mesh; use merge='device' on a power-of-two mesh")
        #: "f32" exact; "bf16" the matmul-form score with an exact rescore,
        #: effective (``score_mode`` "mxu") at D >= ``mxu_min_dim()``
        self.score_dtype = validate_score_dtype(score_dtype)
        self.score_mode = ("mxu" if (self.score_dtype == "bf16"
                                     and self.dim >= mxu_min_dim())
                           else "vpu")
        if self.merge_mode == "device":
            # the device merge hands each position a 1/R row slice, so
            # every shape bucket must hold R rows (both powers of two)
            if self.num_shards > max_batch and merge == "auto":
                self.merge_mode = "host"
            else:
                min_batch = max(min_batch, self.num_shards)
        if max_batch < min_batch:
            raise ValueError(f"max_batch {max_batch} < min_batch {min_batch}"
                             + (" (device merge needs buckets >= num_shards)"
                                if min_batch == self.num_shards else ""))
        #: ascending power-of-two padded batch sizes
        self.shape_buckets = [b for b in
                              (min_batch << i for i in range(64))
                              if b <= max_batch] or [min_batch]
        self.max_batch = self.shape_buckets[-1]
        use_tiled = engine_name in TILED_ENGINES
        self.query_buckets_setting = int(query_buckets)
        #: query buckets per padded shape: only the tiled engines at D=3
        #: bucket, everything else serves a single bucket
        self.query_buckets = {
            q: (resolve_query_buckets(query_buckets, q, self.k)
                if use_tiled and self.dim == 3 else 1)
            for q in self.shape_buckets}
        #: the Morton admission sort: off when query_buckets=1 was pinned
        #: and off the 3-D indexes
        self.sort_queries = (use_tiled and self.query_buckets_setting != 1
                             and self.dim == 3)
        #: canonical (dist2, id) tie order inside the traversal, while ids
        #: stay below 2**24 (the JAX engine's gate)
        self.canonical_ties = (use_tiled
                               and self.id_offset + self.n_points < (1 << 24))
        #: shared timers/counters sink: a slab pool hands every slab engine
        #: one PhaseTimers, so the counters outlive each evicted engine
        self.timers = timers if timers is not None else PhaseTimers()
        #: shared launch plans (None = this engine's own only)
        self._plan_cache = plan_cache
        #: pad each shard to at least this many rows: the slab pool's
        #: common shape class (single-process engines only: pod mode pads
        #: to the widest slab already)
        self._pad_shard_rows = int(pad_shard_rows)
        # _lock serializes dispatch, degrade and warmup; the identity
        # scalars live under _meta_lock (never held across a build), so a
        # /stats scrape never waits on a plan build. Order: _lock ->
        # _meta_lock.
        self._lock = threading.Lock()
        self._meta_lock = threading.Lock()
        self.compile_count: guarded_by("_meta_lock") = 0
        self.degraded_reason: guarded_by("_meta_lock") = None
        self.engine_name: guarded_by("_meta_lock") = engine_name
        self._compiled_shapes: guarded_by("_meta_lock") = []
        #: (engine_name, merge_mode, qpad, B, score_dtype[, plan_key]) ->
        #: _LaunchPlan
        self._plans: guarded_by("_lock") = {}
        #: the launch queue on the card: one stream keeps launches FIFO.
        #: The index is built on it too, so every batch is ordered after
        #: the build, and the resident tensors belong to the stream that
        #: reads them (the caching allocator reuses a freed block only on
        #: the stream it was allocated on)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        with self.timers.phase("index_build"):
            if self._stream is None:
                self._build_index(points)
            else:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    self._build_index(points)
                # only this stream: a slab built by the promotion thread
                # waits for its own upload, not for the batches other
                # engines have in flight
                self._stream.synchronize()

    # ------------------------------------------------------------------ build

    def _build_index(self, points):
        dev = self.device
        self._index_lo = (points.min(axis=0) if len(points)
                          else np.zeros(self.dim))
        self._index_hi = (points.max(axis=0) if len(points)
                          else np.ones(self.dim))
        bounds = slab_bounds(len(points), self.num_shards)
        #: per-shard AABB and point count, computed once from the host slabs
        self.shard_bounds = slab_aabbs(points, bounds)
        if self._multi:
            # pod mode: every host holds the whole point set but uploads
            # only the slabs of its own positions, padded to the widest
            # slab (the batch CLIs' process-ownership discipline)
            self._my_pos = list(self.mesh.positions)
            pad_to = max(max(e - b for b, e in bounds), 1)
        else:
            self._my_pos = list(range(self.num_shards))
            pad_to = None
            if self._pad_shard_rows:
                pad_to = max(self._pad_shard_rows, 1,
                             max((e - b for b, e in bounds), default=1))
        flat, ids, _counts, self.npad_local = pad_and_flatten(
            [points[bounds[s][0]:bounds[s][1]] for s in self._my_pos],
            id_bases=[bounds[s][0] + self.id_offset for s in self._my_pos],
            dim=self.dim, pad_to=pad_to)
        npad = self.npad_local
        self._flat_pts = _upload(flat, dev)
        self._flat_ids = _upload(ids, dev)
        #: per local shard: its bucketed partition (the tiled engines' side)
        self._buckets = [
            partition_points(self._flat_pts[r * npad:(r + 1) * npad],
                             self._flat_ids[r * npad:(r + 1) * npad],
                             bucket_size=self.bucket_size)
            for r in range(len(self._my_pos))]
        resident = [self._flat_pts, self._flat_ids]
        for b in self._buckets:
            resident += list(b)
        #: per-bucket ||p||^2, computed once, under the matmul-form score:
        #: the twin's ``point_norms2`` (the JAX engine's resident norms)
        self._bucket_norms2 = None
        # lsk: allow[lock-guard] _build_index runs from __init__ only —
        engine_name = self.engine_name  # unshared
        if self.score_mode == "mxu" and engine_name in TILED_ENGINES:
            self._bucket_norms2 = [norms2(b.pts) for b in self._buckets]
            resident += self._bucket_norms2
        #: per shard: the point side laid out once for the traversal
        #: kernel (``prepare_points``)
        self._prepared = None
        if engine_name == "pallas_tiled":
            self._prepared = [prepare_points(b, self.score_dtype)
                              for b in self._buckets]
        nbytes = sum(t.numel() * t.element_size() for t in resident)
        if self._prepared is not None:
            nbytes += sum(p.nbytes() for p in self._prepared)
        #: this engine's resident device bytes: flat arrays, partitions,
        #: norms and the kernels' prepared point sides (what a slab pool's
        #: device budget counts)
        self.device_bytes = int(nbytes)

    # ------------------------------------------------------------ launch plans

    def bucket_for(self, n: int) -> int:
        """Smallest shape bucket covering an ``n``-query batch."""
        for b in self.shape_buckets:
            if b >= n:
                return b
        raise UnservableShapeError(
            f"batch of {n} queries exceeds max_batch {self.max_batch}")

    def _tiles_possible(self, engine_name: str, qpad: int) -> int:
        """Static ceiling of one batch's traversal in TILE-ROW units (query
        row x point-bucket visit), summed over this process's shards (pod
        mode counts per host): the twin counts every schedule slot
        (``tile_schedule_slots``), the kernel only the buckets it kept, so
        its ceiling is the bucket count."""
        if engine_name not in TILED_ENGINES:
            return 0
        num_pb = self._buckets[0].ids.shape[0]
        per_row = (num_pb if engine_name == "pallas_tiled"
                   else tile_schedule_slots(num_pb))
        return len(self._my_pos) * qpad * per_row

    def _resident_shapes(self, engine_name: str) -> tuple:
        """The shape class of the resident operands a plan of
        ``engine_name`` launches against (shapes and dtypes)."""
        if engine_name in TILED_ENGINES:
            args = list(self._buckets[0])
            if self._bucket_norms2 is not None:
                args.append(self._bucket_norms2[0])
        else:
            args = [self._flat_pts, self._flat_ids]
        return tuple((tuple(a.shape), str(a.dtype)) for a in args)

    # lsk: holds[_lock]
    def _get_plan(self, qpad: int, plan=None) -> _LaunchPlan:
        """The launch plan of (active engine, qpad), built on a miss;
        ``compile_count`` counts each build. Recall-plan knobs reach only
        the twin ``tiled``; elsewhere the exact plan runs. With a shared
        ``plan_cache`` the key adds every other knob the plan depends on
        and the resident shape class, so every engine of the class (the
        slab pool's) takes the plan one of them built."""
        qb = self.query_buckets[qpad]
        with self._meta_lock:
            engine_name = self.engine_name
        plan_key = None
        if plan is not None and engine_name == "tiled":
            pk = plan.program_key()
            if pk != (False, 1.0, 1.0):
                plan_key = pk
        key = (engine_name, self.merge_mode, qpad, qb, self.score_dtype)
        if plan_key is not None:
            key = key + (plan_key,)
        lp = self._plans.get(key)
        if lp is not None:
            return lp
        shared_key = None
        if self._plan_cache is not None:
            shared_key = key + (
                self.emit, self.k, self.max_radius, self.canonical_ties,
                self.dim, self.num_shards,
                self._resident_shapes(engine_name))
            lp = self._plan_cache.get(shared_key)
            if lp is not None:
                self._plans[key] = lp
                with self._meta_lock:
                    self._compiled_shapes.append(qpad)
                return lp
            # None: this engine claimed the key; a concurrent miss waits
            # in get() until the put below, or the abort
        try:
            with self.timers.phase(f"compile_q{qpad}"):
                lp = _LaunchPlan(engine_name, qpad, qb, plan_key,
                                 self._tiles_possible(engine_name, qpad))
        except BaseException:
            if self._plan_cache is not None:
                self._plan_cache.abort(shared_key)
            raise
        self._plans[key] = lp
        if self._plan_cache is not None:
            self._plan_cache.put(shared_key, lp)
        with self._meta_lock:
            self.compile_count += 1
            self._compiled_shapes.append(qpad)
        return lp

    def _run(self, lp: _LaunchPlan, q: torch.Tensor, r: torch.Tensor):
        """The batch's device work under plan ``lp``: (a, b, tiles) device
        tensors, as ``_InFlightBatch.result`` describes them. In pod mode
        the device merge is the collective: (a, b) are then the final
        rows of this process's positions only."""
        heap = init_candidates(lp.qpad, self.k, r)
        states, tiles = [], []
        n_local = len(self._my_pos)
        if lp.engine_name in TILED_ENGINES:
            qbk = batch_buckets(q, lp.qb)
            for s in range(n_local):
                if lp.engine_name == "tiled":
                    kw = {}
                    if lp.plan_key is not None:
                        skip_rescore, prune_shrink, visit_frac = lp.plan_key
                        kw = dict(skip_rescore=skip_rescore,
                                  prune_shrink=prune_shrink,
                                  visit_frac=visit_frac)
                    st, t = knn_update_tiled(
                        heap, qbk, self._buckets[s], with_stats=True,
                        canonical_ties=self.canonical_ties,
                        score_dtype=self.score_dtype, chunk_buckets=1,
                        point_norms2=(None if self._bucket_norms2 is None
                                      else self._bucket_norms2[s]), **kw)
                    t = torch.tensor(t, dtype=torch.int64)
                else:
                    st, visits = knn_update_tiled_cuda(
                        heap, qbk, self._buckets[s], with_stats=True,
                        canonical_ties=self.canonical_ties,
                        score_dtype=self.score_dtype,
                        prepared=self._prepared[s])
                    t = visits.sum()
                states.append(st)
                # tile-row units: a visit of a bucket of s_q rows
                tiles.append(t * lp.s_q)
            tiles = torch.stack([t.to(q.device) for t in tiles])
        else:
            npad = self.npad_local
            for s in range(n_local):
                states.append(knn_update_bruteforce(
                    heap, q, self._flat_pts[s * npad:(s + 1) * npad],
                    self._flat_ids[s * npad:(s + 1) * npad],
                    score_dtype=self.score_dtype))
            # one (zero) count per local shard, as the tiled engines give
            tiles = torch.zeros(n_local, dtype=torch.int64, device=q.device)
        if self.merge_mode == "device":
            if self._multi:
                dists, st = merge_over_mesh(self.mesh, states,
                                            lp.qpad // self.num_shards)
            else:
                dists, st = device_merge_final(states)
            if self.emit == "candidates":
                # the merged candidate rows, not the k-th distances: the
                # slab pool's fold needs every candidate
                return st.dist2, st.idx, tiles
            return dists, st.idx, tiles
        return (torch.cat([st.dist2 for st in states]),
                torch.cat([st.idx for st in states]), tiles)

    def _launch(self, lp: _LaunchPlan, q: np.ndarray, r: np.ndarray):
        """Stage ``q`` f32[qpad, D] and ``r`` f32[qpad] and run plan ``lp``:
        on the card, from pinned host memory onto the engine's stream, the
        results copied back to pinned host memory on it and an event
        recorded after them; returns (result, event). On the CPU the result
        is computed here and the event is None."""
        if self._stream is None:
            return self._run(lp, torch.from_numpy(q),
                             torch.from_numpy(r)), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            q_dev = torch.from_numpy(q).pin_memory().to(self.device,
                                                        non_blocking=True)
            r_dev = torch.from_numpy(r).pin_memory().to(self.device,
                                                        non_blocking=True)
            out = self._run(lp, q_dev, r_dev)
            host = tuple(t.to("cpu", non_blocking=True) for t in out)
            done = torch.cuda.Event()
            done.record(self._stream)
        return host, done

    def warmup(self) -> dict:
        """Build (and once run) every shape bucket's launch plan, building
        the kernels on their first launch. Returns ``{"per_bucket_s":
        {qpad: seconds}, "query_buckets": {qpad: B}, "tiles_executed":
        int, "tiles_skipped": int}`` (the warmup batches are all padding:
        executed stays 0 and skipped counts each plan's ceiling)."""
        per_bucket = {}
        with self._lock:
            for qpad in self.shape_buckets:
                t0 = time.perf_counter()
                lp = self._get_plan(qpad)
                q0 = np.full((qpad, self.dim), PAD_SENTINEL, np.float32)
                r0 = np.full(qpad, self.max_radius, np.float32)
                out, done = self._launch(lp, q0, r0)
                if done is not None:
                    done.synchronize()
                self._count_tiles(int(out[2].sum()), lp.tiles_possible)
                per_bucket[qpad] = round(time.perf_counter() - t0, 3)
        return {"per_bucket_s": per_bucket,
                "query_buckets": dict(self.query_buckets),
                "tiles_executed": self.timers.counter("tiles_executed"),
                "tiles_skipped": self.timers.counter("tiles_skipped")}

    def _count_tiles(self, executed: int, possible: int) -> None:
        """Fold one batch's tile count into the executed/skipped counters,
        in aggregate and per score mode (flat engines report 0/0)."""
        if possible <= 0 and executed <= 0:
            return
        self.timers.count("tiles_executed", executed)
        self.timers.count("tiles_skipped", max(0, possible - executed))
        self.timers.count(f"tiles_executed_{self.score_mode}", executed)
        self.timers.count(f"tiles_skipped_{self.score_mode}",
                          max(0, possible - executed))

    # ----------------------------------------------------------------- degrade

    def can_degrade(self) -> bool:
        """True only for ``pallas_tiled`` on the CPU. On the card nothing
        falls back to the plain version: a kernel that fails to build or
        launch raises, and the request fails with it."""
        with self._meta_lock:
            return (self.engine_name == "pallas_tiled"
                    and self.device.type == "cpu")

    def degrade(self, reason: str) -> None:
        """Swap the traversal kernel's plain version for its twin ``tiled``
        after a runtime failure on the CPU (identical distances; the
        resident partition is kept); raises on the card (``can_degrade``).
        Takes the engine lock, so a dispatch never records an engine name
        other than the one it launched."""
        with self._lock:
            with self._meta_lock:
                if self.device.type != "cpu":
                    raise RuntimeError(
                        f"engine '{self.engine_name}' has no fallback on "
                        f"{self.device}: a kernel failure raises")
                if self.engine_name != "pallas_tiled":
                    raise RuntimeError(
                        f"engine '{self.engine_name}' has no fallback")
                self.degraded_reason = reason
                self.engine_name = "tiled"
            if self.score_mode == "mxu" and self._bucket_norms2 is None:
                self._bucket_norms2 = [norms2(b.pts) for b in self._buckets]

    # ------------------------------------------------------------------- query

    def set_launch_workers(self, n: int) -> None:
        """The serving layer asks for ``n`` launches in flight (its
        pipeline depth). Nothing to resize here: on the card the launch
        queue is the engine's one CUDA stream, ``dispatch`` returns as soon
        as a batch is enqueued and the stream keeps launches FIFO, so any
        depth is served as it is (the JAX engine widens a thread pool, its
        stand-in for the device's queue). On the CPU ``dispatch`` computes
        in place."""

    def dispatch(self, queries: np.ndarray, plan=None,
                 seed_radius=None) -> _InFlightBatch:
        """Enqueue a batch's traversal WITHOUT waiting for the result.

        Morton-sorts (when enabled), pads to the shape bucket, fills the
        per-row init radii (``max_radius``; ``seed_radius`` rows, the
        certified query cache's seeds, clamped to it; pad rows at
        ``max_radius``) and launches on the engine's stream. No step here
        waits for the card. ``plan`` (serve/recall.py, None = exact)
        selects the plan-keyed launch plan; seeds never change an answer,
        only the prune."""
        queries = np.asarray(queries, np.float32).reshape(-1, self.dim)
        n = len(queries)
        if n == 0:
            with self._meta_lock:
                name = self.engine_name
            return _InFlightBatch(queries, 0, 0, name, self.merge_mode,
                                  None, None, time.perf_counter(), plan=plan)
        qpad = self.bucket_for(n)
        perm = None
        if self.sort_queries and n > 1:
            with self.timers.phase("morton_sort"):
                perm = morton_argsort(queries, self._index_lo,
                                      self._index_hi)
        staged = queries if perm is None else queries[perm]
        r = np.full(qpad, self.max_radius, np.float32)
        if seed_radius is not None:
            sr = np.asarray(seed_radius, np.float32).reshape(-1)
            if len(sr) != n:
                raise ValueError(
                    f"seed_radius has {len(sr)} rows for {n} queries")
            sr = np.minimum(sr, np.float32(self.max_radius))
            r[:n] = sr if perm is None else sr[perm]
            self.timers.count(
                "seeded_rows", int(np.sum(sr < self.max_radius)))
        q = np.full((qpad, self.dim), PAD_SENTINEL, np.float32)
        q[:n] = staged
        with self._lock:
            lp = self._get_plan(qpad, plan=plan)
            t0 = time.perf_counter()
            result, done = self._launch(lp, q, r)
        if plan is not None:
            self.timers.count("approx_batches")
        return _InFlightBatch(queries, n, qpad, lp.engine_name,
                              self.merge_mode, result, done, t0, perm=perm,
                              tiles_possible=lp.tiles_possible, plan=plan)

    def complete(self, batch: _InFlightBatch):
        """Wait for a dispatched batch and finish its cross-shard top-k:
        ``merge="host"`` merges the R partial rows in numpy,
        ``merge="device"`` already holds the final ([Q], [Q, k]).
        ``fetch_bytes`` / ``result_rows`` count what came back; the tile
        counts feed ``tiles_executed`` / ``tiles_skipped``. Rows come back
        in the caller's order. A kernel fault raises here (at the event),
        where the graceful wrapper replays the retained queries on the
        twin."""
        if batch.n == 0:
            return (np.zeros(0, np.float32),
                    np.zeros((0, self.k), np.int32))
        if self._multi:
            raise RuntimeError(
                "pod-mode engines emit per-host row slices — use "
                "complete_slices (the front end assembles the full batch)")
        if self.emit == "candidates":
            raise RuntimeError(
                "emit='candidates' engines return full candidate rows — "
                "use complete_candidates (the slab pool's fold)")
        return self._finish(batch, full=False)

    def complete_candidates(self, batch: _InFlightBatch):
        """``complete`` for a slab engine: wait for a dispatched batch and
        return the full merged candidate rows ``(dist2 f32[n, k], idx
        i32[n, k])`` over THIS engine's points, ascending (dist2, id) per
        row, -1 ids and radius**2 distances in unfilled slots. Under both
        merge placements: the device merge emits the candidate rows
        (``emit='candidates'``), the host merge keeps the full-width
        variant of its fold."""
        if batch.n == 0:
            return (np.full((0, self.k), np.inf, np.float32),
                    np.full((0, self.k), -1, np.int32))
        if self._multi:
            raise RuntimeError(
                "pod-mode engines emit per-host row slices — routed "
                "(independent-host) serving never joins a process group")
        if batch.merge_mode == "device" and self.emit != "candidates":
            raise RuntimeError(
                "engine was built with emit='final': its device merge "
                "emits k-th distances, not candidate rows — construct the "
                "engine with emit='candidates'")
        return self._finish(batch, full=True)

    def refetch_exact(self, queries):
        """Exact f32 candidate rows for ``queries``, byte-equal to any
        earlier batch that held these rows: a row's top-k over this
        engine's points depends on the row alone, not on the batch it came
        in, so a routed pod's exact re-fetch (``?wire=x32``) after a
        quantized wave costs a round trip, never bits."""
        return self.complete_candidates(self.dispatch(queries))

    def _finish(self, batch: _InFlightBatch, full: bool):
        """The rest of ``complete`` / ``complete_candidates``: wait for the
        batch's event, count, merge the shards on the host where asked
        (``full``: the whole candidate rows), and undo the Morton sort."""
        if batch.done is not None:
            batch.done.synchronize()
        a, b, t = (x.numpy() for x in batch.result)
        self.timers.hist("engine_batch_seconds").record(
            time.perf_counter() - batch.t0)
        self.timers.count("fetch_bytes", a.nbytes + b.nbytes)
        self.timers.count("result_rows", batch.n)
        self._count_tiles(int(t.sum()), batch.tiles_possible)
        if batch.merge_mode == "device":
            dists, nbrs = a, b
        else:
            with self.timers.phase("host_merge"):
                dists, nbrs = _merge_shard_candidates(
                    a, b, self.num_shards, batch.qpad, self.k, full=full)
        dists, nbrs = dists[:batch.n], nbrs[:batch.n]
        if batch.perm is not None:
            out_d = np.empty_like(dists)
            out_n = np.empty_like(nbrs)
            out_d[batch.perm] = dists
            out_n[batch.perm] = nbrs
            dists, nbrs = out_d, out_n
        return dists, nbrs

    def complete_slices(self, batch: _InFlightBatch):
        """Pod-mode ``complete``: wait for a dispatched batch and return
        ONLY this process's row slices of the pod-final answer.

        Under the device merge, mesh position r holds rows [r*qpad/R,
        (r+1)*qpad/R) of the final [qpad] + [qpad, k] result, and this
        process's positions are contiguous, so it holds one row range and
        fetches 1/P of the result: the POD's fetched bytes equal ONE
        result (``fetch_bytes``). Returns ``(rows i32[m], dists f32[m],
        nbrs i32[m, k])``: ``rows`` are CALLER-order row indices (the
        Morton admission sort undone row by row through ``batch.perm``)
        and ``m`` counts only the real (non-pad) rows this host owns. The
        front end scatters each host's triple into the full batch, bitwise
        equal to one process's ``complete`` of the same batch, ties
        included. The rows are picked by their range, on the host copy,
        so nothing here waits on the card again."""
        if batch.n == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros((0, self.k), np.int32))
        if batch.done is not None:
            batch.done.synchronize()
        d, nb, t = (x.numpy() for x in batch.result)
        self.timers.hist("engine_batch_seconds").record(
            time.perf_counter() - batch.t0)
        self.timers.count("fetch_bytes", d.nbytes + nb.nbytes)
        self._count_tiles(int(t.sum()), batch.tiles_possible)
        lo = self._my_pos[0] * (batch.qpad // self.num_shards)
        # pad rows sort and stay last, so the real rows are one prefix
        m = max(0, min(batch.n - lo, len(d)))
        staged = np.arange(lo, lo + m)
        rows = (batch.perm[staged] if batch.perm is not None
                else staged).astype(np.int32)
        self.timers.count("result_rows", m)
        return rows, d[:m], nb[:m]

    def query(self, queries: np.ndarray, plan=None, seed_radius=None):
        """f32[n, D] -> (f32[n] k-th-NN distances, i32[n, k] neighbor ids),
        ``dispatch`` then ``complete``. ``n`` may be anything in [0,
        max_batch]. Distances are sqrt of the k-th smallest squared
        distance, inf (or the radius) when fewer than k neighbors exist;
        ids are global, ascending by distance, -1 for unfilled slots."""
        return self.complete(self.dispatch(queries, plan=plan,
                                           seed_radius=seed_radius))

    def stats(self) -> dict:
        with self._meta_lock:
            engine_name = self.engine_name
            degraded_reason = self.degraded_reason
            compile_count = self.compile_count
            compiled_shapes = sorted(self._compiled_shapes)
        out = {
            "engine": engine_name,
            "merge": self.merge_mode,
            "score_dtype": self.score_dtype,
            "score_mode": self.score_mode,
            "dim": self.dim,
            "degraded_reason": degraded_reason,
            "n_points": self.n_points,
            "k": self.k,
            "num_shards": self.num_shards,
            # pod-mode surface: which slice of the mesh this process owns
            # (the front end checks the hosts' coverage)
            "multihost": self._multi,
            "process_index": self.process_index,
            "process_count": self.process_count,
            "my_positions": list(self._my_pos),
            "row_offset": self.id_offset,
            "emit": self.emit,
            "canonical_ties": self.canonical_ties,
            "max_radius": (None if math.isinf(self.max_radius)
                           else self.max_radius),
            "shard_bounds": self.shard_bounds,
            "device_bytes": self.device_bytes,
            "max_batch": self.max_batch,
            "bucket_size": self.bucket_size,
            "shape_buckets": list(self.shape_buckets),
            "compiled_shapes": compiled_shapes,
            "compile_count": compile_count,
            "query_buckets": {str(q): b
                              for q, b in sorted(self.query_buckets.items())},
            "sort_queries": self.sort_queries,
            "tiles_executed": self.timers.counter("tiles_executed"),
            "tiles_skipped": self.timers.counter("tiles_skipped"),
            "tiles_executed_mxu": self.timers.counter("tiles_executed_mxu"),
            "tiles_skipped_mxu": self.timers.counter("tiles_skipped_mxu"),
            "tiles_executed_vpu": self.timers.counter("tiles_executed_vpu"),
            "tiles_skipped_vpu": self.timers.counter("tiles_skipped_vpu"),
            "fetch_bytes": self.timers.counter("fetch_bytes"),
            "result_rows": self.timers.counter("result_rows"),
            "approx_batches": self.timers.counter("approx_batches"),
            "timers": self.timers.report(),
        }
        if self._multi:
            # pod mode: seconds and bytes this process spent in the merge's
            # all_to_all (its staging included), all batches so far
            out["exchange_seconds"] = self.mesh.exchange_seconds
            out["exchange_bytes"] = self.mesh.exchange_bytes
        return out


def _merge_shard_candidates(d2, idx, num_shards, qpad, k, full=False):
    """Merge R per-shard top-k candidate blocks (``d2``/``idx`` [R*qpad,
    k], shard-major) into the global top-k: (sqrt of the k-th f32[qpad],
    ids i32[qpad, k]), or with ``full`` the whole merged rows (dist2
    f32[qpad, k], ids). Ties follow a stable sort over the shard-major
    concatenation (earlier shard, then earlier slot), found without the
    full width-R*k sort: ``np.argpartition`` selects k per row, a
    column-ordered tie-fix picks the boundary ties the stable sort would
    keep, and only the k survivors are sorted (the JAX engine's merge)."""
    d2 = d2.reshape(num_shards, qpad, k).transpose(1, 0, 2).reshape(qpad, -1)
    idx = idx.reshape(num_shards, qpad, k).transpose(1, 0, 2).reshape(qpad, -1)
    if num_shards == 1:
        if full:
            return d2, idx
        return np.sqrt(d2[:, k - 1]), idx
    part = np.argpartition(d2, k - 1, axis=1)[:, :k]
    kth = np.take_along_axis(d2, part, axis=1).max(axis=1, keepdims=True)
    # every strictly-closer column is in; of the columns tied AT the k-th
    # value (kth is an element of d2, so == finds exactly its class), the
    # stable sort keeps the first (k - m) in column order
    below = d2 < kth
    m = below.sum(axis=1, keepdims=True)
    # lsk: allow[float-eq] the boundary tie-fix IS bitwise: kth is an element
    tied = d2 == kth  # of d2, so exact equality finds exactly the tied class
    mask = below | (tied & (np.cumsum(tied, axis=1) <= k - m))
    sel_cols = np.sort(np.argpartition(~mask, k - 1, axis=1)[:, :k], axis=1)
    sel_d2 = np.take_along_axis(d2, sel_cols, axis=1)
    order = np.argsort(sel_d2, axis=1, kind="stable")
    top_d2 = np.take_along_axis(sel_d2, order, axis=1)
    top_idx = np.take_along_axis(
        idx, np.take_along_axis(sel_cols, order, axis=1), axis=1)
    if full:
        return top_d2, top_idx
    return np.sqrt(top_d2[:, k - 1]), top_idx


def load_slab_rows(path: str, slab: int, num_slabs: int):
    """Load row slab ``[N*i/S, N*(i+1)/S)`` of ``path``; returns
    ``(points f32[n, D], begin, n_total)``: the one slab split every slab
    consumer shares (``materialize_slab_engine`` and the slab pool's cold
    tier, serve/slabpool.py ``SlabSource``), the reference's
    ``read_file_portion`` for ``.float3`` and an mmap slice for ``.npy``,
    so every consumer materializes byte-identical rows."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        n_total = len(arr)
        begin, end = slab_bounds(n_total, num_slabs)[slab]
        return np.asarray(arr[begin:end], np.float32), begin, n_total
    from mpi_cuda_largescaleknn_torch.io.reader import read_file_portion

    return read_file_portion(path, slab, num_slabs)


def materialize_slab_engine(path, slab: int, num_slabs: int, *, k: int,
                            num_shards: int = 1, engine: str = "auto",
                            merge: str = "auto", bucket_size: int = 0,
                            max_radius: float = math.inf,
                            max_batch: int = 1024, min_batch: int = 8,
                            query_buckets: int = 0,
                            score_dtype: str = "f32", points=None,
                            id_offset: int | None = None,
                            warmup: bool = False, device=None):
    """Load row slab ``[N*i/S, N*(i+1)/S)`` and build its candidates
    engine (global ids from the slab's first row). Pass ``points`` and
    ``id_offset`` to skip the file read. Returns ``(engine, id_offset,
    n_total)``, ``n_total`` None when the rows came pre-loaded."""
    if points is None:
        if not path:
            raise ValueError("need an input path or pre-loaded slab rows")
        points, id_offset, n_total = load_slab_rows(path, slab, num_slabs)
    else:
        if id_offset is None:
            raise ValueError("pre-loaded slab rows need their id_offset "
                             "(the slab's global row origin)")
        n_total = None
    eng = ResidentKnnEngine(
        points, k, num_shards=num_shards, engine=engine, merge=merge,
        bucket_size=bucket_size, max_radius=max_radius,
        max_batch=max_batch, min_batch=min_batch,
        query_buckets=query_buckets, score_dtype=score_dtype,
        id_offset=int(id_offset), emit="candidates", device=device)
    if warmup:
        eng.warmup()
    return eng, int(id_offset), n_total
