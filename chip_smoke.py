#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit, and the kernels of the main paths;
2. build ``csrc/knn_tiled.cu``, ``csrc/knn_bf.cu`` and
   ``csrc/knn_tiled_mxu.cu`` with nvcc into ``build/``, the compilers
   started together;
3. the D=3 traversal kernel against its plain PyTorch version on the
   card, bit for bit (d2 and ids; visit counts equal where a query bucket
   is one block, at most the plain count where its rows split over
   blocks, as they do at D=3), on ~32K seeded uniform, clustered and
   integer-grid points (exact ties at the k-th slot): k in {1, 8, 31, 32,
   33, 64, 65, 100, 200} (the lane borders of the warp fold) and 300 and
   903 (its instances of 16 and 32 slots a lane), a finite
   ``-r``, ``skip_self`` with point group 2, and buckets wider than one
   staged tile with a partial last tile; each case on the D=3 kernel;
   then the launches split along the grid's y axis (``grid_split_cases``):
   one D=3 query bucket of 2,097,152 rows at k=8 (65,536 blocks of 32
   rows, one past the grid's limit: two launches), and a cap of 3 blocks
   a launch forced on 1,000-row buckets of the D=3, ring (D=16) and
   wgmma (bf16 D=128) kernels;
3b. the brute-force kernel against its plain version, bit for bit (d2 and
   ids), on ~32K seeded points: uniform, clustered and integer-grid, k in
   {1, 8, 31, 32, 33, 64, 65, 100, 200, 300, 903}, a finite ``-r``,
   sentinel-padded points and queries, ids with an offset, two incremental
   calls against one, a point count that is not a multiple of the staged
   tile, and other tiles giving the same bits; each case on its route by
   the counters;
3c. the ring kernel (``knn_tiled_nd_ring_kernel``, every f32 fold at D !=
   3) against the plain versions, bit for bit, on both its routes: the
   traversal on 32,000 clustered points at D in {4, 16, 128}: k in {1, 10,
   100} (k=100 at D=128 with the rows in device memory), a finite ``-r``,
   ``skip_self`` with point group 2, point buckets of two chunks and more;
   D=5 and D=130 (padded components), a bucket of 1,000 rows (split over
   blocks); above ``RESIDENT_MAX_DP4``, D streamed in slices, on 8,000
   points at D in {228, 240, 256, 960} and k in {1, 10, 100}, a bucket of
   1,000 rows at D=240, k=1000 at D in {128, 240, 960}; the flat fold at D
   in {4, 16, 128} (k in {1, 10, 100}, a finite ``-r``), sentinel points
   and queries with a partial last chunk, D=240, and k=1000 at D in {128,
   240, 960}; each case on its planned route by the counters;
3d. the tensor-core bf16 kernel against its plain version, on both its
   routes: the query halves resident at D in {16, 32, 64, 128}, k in {1,
   10, 100}, a finite ``-r`` and warm-started rows, a bucket of 1,000 rows
   (split over blocks, T not a multiple of the chunk) and D=200 (a 2-stage
   ring, rows in device memory); above ``WGMMA_MAX_DP``, D streamed in
   K-slices, at D=240 (just above), D=600 and D=1000 (a short last slice),
   D=960 at k in {1, 10, 100} and k=1000 (W=2000, rows in device memory),
   and a bucket of 1,000 rows at D=600: d2 bitwise and equal to the f32
   kernel's; ids equal, where they differ, only among equally distant
   points (checked exactly); each case's launch on its route;
3e. the same checks on the query sides the chunked loops give the kernels
   (``chunk_cases``), cold and without ``skip_self``: phase 13c's
   device-merge chunk as one query bucket of 4,000 rows (the first chunk
   and the last, part padding) against a 65,536-point shard coarsened at
   G=2, k=8, on the D=3 traversal and the flat D=3 kernel; chunk
   partitions of 16,384 rows against a whole shard at G=2, at D=3 k=100
   and at D=128 k=10 in f32 (ring kernel) and bf16 (wgmma);
4. the main path through the CLI: 1,000,000 seeded uniform points at
   k=100 and at k=8, each with ``--selfcheck 1000 --timings`` (in phases
   4-8 every launch must be on the D=3 kernels);
5. the same k=8 run over 4 virtual shards, byte-equal to the 1-shard file;
5b. in a fresh process, the kernel library's load, then the k=8 run at
   R=1 twice and at R=4 through ``UnorderedKNN``: each D=3 launch's visit
   schedule, layout (``d3_lanes``) and kernel timed apart, the first
   launch's kernel time holding its loading;
6. the D=3 traversal kernel's time at the main path's shapes (the one
   fold of a 1-shard run) against its plain version and its bounds (the
   data sheet's, and the FMA-free one: ``PEAK_F32_ISSUE``) on the real
   pairs its 32-row blocks score (``block_walk``, checked against its rows
   and visits) and on those of the plain version's walk, and the warps an
   SM holds (at least the plan's);
7. the flat engine through the unordered CLI (``--engine pallas -k 8``),
   byte-equal to phase 4's k=8 file;
8. the pre-partitioned pipeline: phase 4's file cut into 4 Morton parts,
   then ``prepartitioned_main`` with ``--engine auto -k 8``, ``--engine
   pallas -k 8`` and ``--engine auto -k 100``: the two k=8 runs byte-equal
   to each other and to the unordered CLI on the joined parts; then 1M
   clustered points in 8 parts (where the early exit prunes);
9. the brute-force kernel's time at the flat path's shape (1M x 1M, k=8
   and k=100) against its bounds, its plain version's on the first 16,384
   queries, and the warps an SM holds (at least the plan's);
10. the high-D main path: ``UnorderedKNN`` on 1,000,000 seeded points at
   D=128 (32 Gaussian clusters, the SIFT1M shape) and k=10, in bf16 at
   R=1, in f32 at R=1 and in bf16 at R=4: distances byte-equal, ids equal
   up to the order of exact ties, a selfcheck of 200 samples on the card
   (``verify_sample_card``: ``kth_distance_card``, the host check's
   recipe in eager ops, then its tolerance and inf pattern); every bf16
   launch on the wgmma kernel and every f32 one on the ring kernel, bf16
   ``pair_evals`` at most 1.1x f32's, and the bf16 runs' kernel time per
   launch beside the wrapper's preparation time (the packed halves rebuilt
   at every launch);
10b. ``prepartitioned_main`` on 4 ``.npy`` slab parts of the first
   262,144 of those points, byte-equal to ``UnorderedKNN`` on them, every
   traversal launch on the ring kernel, the rank files checked on the
   card (200 samples);
10c. the main paths above ``RESIDENT_MAX_DP4``: ``UnorderedKNN`` f32 at R=1
   on 262,144 points at D=960 (GIST1M's width and k=10; 32 Gaussian
   clusters; a quarter of its points), every traversal launch on the
   streamed ring route; ``UnorderedKNN`` in bf16 at R=1 on the same
   points, every launch on the wgmma kernel's streamed route, distances
   byte-equal to the f32 run, ids equal up to the order of exact ties, its
   kernel and preparation timed apart; a selfcheck on the card of 50
   samples of the distances both runs share; and ``UnorderedKNN`` with
   ``engine="pallas"`` at D=128 on phase 10b's points (the flat route of
   the ring kernel), byte-equal to the ``auto`` run there; stages and peak device memory of each, each
   kernel against its bounds on the pairs it scored, and the seconds of
   each step of the phase on the host's clock;
11. the f32 ring kernel (with its plan, and its wrapper's layout time
   apart) and the bf16 (wgmma) kernel at phase 10's shape, against both
   bounds and their share of each, and their plain versions' on 16 query
   buckets;
11b. the ring kernel's streamed traversal at D=240 and its flat fold at
   D=128 (16,384 queries x 1M points), and the wgmma kernel's streamed
   route at D=600 (65,536 points), at the shapes their first kernels were
   timed at, each against its plain version and both bounds
   (``time_offpath_kernels``);
13. the chunked and stepwise loops (``chunked_phases``): 13a 8,388,608
   seeded uniform points at k=100, R=1, through ``UnorderedKNN``
   unchunked and with ``query_chunk=1,048,576`` (8 chunks, host merge),
   distances byte-equal, the chunked peak device memory below the
   unchunked, a selfcheck of 1000, every launch on the D=3 kernel, each
   chunk's kernel and ``d3_lanes`` timed; 13b phase 5's points through
   ``ring_knn_stepwise`` cut after 1 round and ``ring_knn_chunked`` cut
   after 2 chunks of 65,536, each resumed from its checkpoint byte-equal
   to phase 5's file (and the checkpoint cleared), and the
   pre-partitioned CLI on phase 8's parts with ``--query-chunk 65536
   --checkpoint-dir``, byte-equal to phase 8's rank files; 13c the device
   merge on 262,144 uniform points, R=4, k=8, chunks of 1,000 rows (single
   query buckets of 4,000 rows), ``auto`` and ``pallas``, distances
   byte-equal to the host merge and ids equal up to exact ties, and
   phase 10b's D=128 points in chunks of 65,536 in f32 (ring route) and
   bf16 (``wgmma``), byte-equal to phase 10b's unchunked run;
14. the native out-of-core IO (``io/native.py``, built with g++ into
   ``build/`` at first use; the phase fails without it) and a job the card
   can run only in chunks, all from one raw ``.float3`` file of 33,554,432
   seeded uniform points written in slabs (``out_of_core_phases``): 14a
   ``read_file_portion`` (native, threaded) and ``np.fromfile`` give equal
   bytes, both timed; 14b ``partition_main -n 8`` in a child process, a
   baseline child importing the same modules and a child running
   ``partition_float3_file_np``, started together through a small
   intermediate process each (so that ``ru_maxrss`` does not start from
   this script's peak), each printing its peak RSS: native and
   numpy parts byte-equal, the native child under the baseline plus a
   quarter of the file; 14c ``prepartitioned_main`` on the 8 native parts
   at k=100 (``--query-chunk 524288`` a shard: chunks of 4,194,304 rows,
   ``--selfcheck 200``) and ``unordered_main`` on the joined parts with
   ``--query-chunk 4194304``: rank files byte-equal to the unordered
   output, every launch on the D=3 kernel, peak device memory and stages
   printed; 14d one 4,194,304-row chunk against the whole 33.5M-point side
   on the D=3 kernel (one launch, timed), its first and last 16 query
   buckets bit for bit against the plain version;
12. phase 10's f32 R=1 run again under ``profile_trace``, byte-equal to
   it: the card's busy share of the run and its top kernels by device
   time (last, after phases 13 and 14, so that no timing runs in a
   process that has been profiled).

Phase 15 (``engine_phases``) runs the XLA engines; then, before phase 12,
the serving core (``serving_phases``):

3f. the traversal kernels at the shapes the serving engine gives them,
   the point side resident (``prepare_points``), ``canonical_ties``, per-row
   init radii mixing +inf, finite seeds and pad rows: D=3 batches of 1024
   rows in query buckets of 8, 16 and 128 rows against phase 13's
   8,388,608 points at T=256 in one shard and in each of 4, against the
   plain traversal bit for bit, and 12 rows over the whole cube in one
   bucket of 16 at k=100 against the plain traversal of each row alone;
   D=128 single buckets of 8, 64 and 1024 rows
   against phase 10's 1M points, f32 (ring kernel) and bf16 (wgmma),
   against the plain flat fold; each launch on its route;
16. ``serve/`` on the card, the server on 127.0.0.1:0 in a thread and 8
   closed-loop client threads (``closed_loop``: batches of 1-1024 rows,
   one client in four binary, one batch in eight repeated or perturbed):
   16a those 8,388,608 points at k=100 over 1 shard and at k=8 over 4
   (about 8 s each), 16b phase 10's points at D=128, k=10, f32 and bf16
   (about 5 s each). Checks, each fatal: (1) 1,000 sampled served rows
   byte-equal to the exact answer by a plain version on the card, ids
   equal up to exact ties; (2) a fixed request list answered in
   byte-equal bodies at pipeline depth 1 and 2, with the query cache on
   and off and with the merge on the host (R=4), and with one query
   bucket (D=3) in byte-equal distances, ids equal up to exact ties; (3) no launch
   plan built after warmup; (4) no degradation; (5) one traversal launch
   a shard for each dispatched batch. Printed: queries/s, p50/p99, mean
   batch rows, tiles executed/skipped, the kernel's time a batch at each
   shape bucket against its bounds, peak device memory, each beside the
   card's name and power limit; 16c ``cli/serve_main.main`` in this
   process on phase 4's file at k=8: one JSON and one binary request,
   byte-equal to phase 4's k=8 output, then stopped.

Then the tiered slab index and tenancy (``tiered_phases``), on 16a's
8,388,608 points in Morton order written to one raw file:

3g. the D=3 traversal kernel at the slab engines' shapes (a slab engine's
   own point side: ``emit="candidates"``, global ids, padded to the pool's
   shape class; a slab of 1,048,576 rows and one 1,000 rows short),
   sub-batches of 1, 37 and 1024 rows staged as the engine stages them,
   seeded radii (a third +inf), k=100, against the plain traversal, d2
   and ids bit for bit;
16s. ``StreamingKnnEngine`` over the file as 8 slabs behind
   ``build_server``: a device budget of 2 slabs (4x over it), a host pool
   of 4 slabs' bytes, prefetch depth 2, the query cache off, k=100, R=1;
   8 closed-loop clients send a sweep (Gaussian blobs of sigma 0.05
   whose center drifts along the box diagonal every 4 s) for 8 s.
   Checks: a 64-row probe before and after the churn byte-equal to a
   ``ResidentKnnEngine`` over the same points; 1,000 served rows against
   the exact answer; promotions and evictions during the traffic; no
   launch plan built after warmup; the pool's device bytes over the
   budget only by counted overcommit. Printed: queries/s, p50/p99, the
   stall fraction, promotions, evictions, cold reads, host hits, the
   pool's high water and ``max_memory_allocated``;
16t. ``cli/serve_main.main`` in this process with four ``--tenant``
   indexes of 2,097,152 Morton-sorted points (one ``.npy``),
   ``--num-slabs 4`` (16 slabs on a budget of 6) and
   ``--tenant-quota-rows 512``: each tenant's probe byte-equal to its own
   resident engine, legacy ``/knn`` the default tenant's, an unknown
   tenant's 404 listing the tenants, a request over the quota a 429 with
   Retry-After, then zipf-skewed traffic (1/(i+1)^4) through the URL, the
   JSON field and the binary codec's header, no plan built after warmup.

Then the ring across processes (``multihost_phases``), each child a real
CLI process joined by ``--coordinator 127.0.0.1:<free port> --num-hosts P
--host-id i`` on the one card (gloo, its copies staged through pinned
host memory), each with a wall-clock limit, every child killed when one
fails:

17a. 16a's 8,388,608 points as one raw file in input order, k=100,
   ``--shards 4`` in 4 processes (one position each): the output file
   byte-equal to ``unordered_main --shards 4`` in this process, every
   traversal launch on the D=3 kernel; each host's stages, ``exchange``,
   the ring's GB/s and peak device memory printed beside the card's name
   and power limit;
17b. phase 4's file at k=8, ``--shards 4`` in 2 processes (two positions
   each: rotations inside a process and across processes mix):
   ``--query-chunk 262144`` with the host merge and with the device
   merge, and ``--engine pallas``, each byte-equal to the same flags in
   this process;
17c. ``prepartitioned_main`` in 2 processes on phase 8's 4 Morton parts at
   k=8 and k=100: rank files byte-equal to phase 8's, ``kernels_run`` and
   ``rotations_run`` equal to its one process's;
17d. an NCCL group of world size 1 in this process: the gathered boxes,
   the need all-reduce and the device merge's ``all_to_all`` on CUDA
   tensors against the one-process answers, then ``ring_knn`` and
   ``ring_knn_chunked`` (device merge) at R=4 through the group path,
   byte-equal to phase 5's file, and ``demand_knn`` on phase 8's parts,
   byte-equal to its k=8 rank files with its work counts.

Then the routed pod (``routed_pod_phases``), on 16s's points with the 4
rows after the first slab edge replaced by copies of the 4 before it:

3h. the D=3 traversal kernel at a routed host's shapes: the point side of
   ``ResidentKnnEngine(emit="candidates", id_offset=4,194,304)`` over a
   slab of 2,097,152 rows, sub-batches of 1, 7, 300 and 1024 rows staged as
   the engine stages them, k=100, bit for bit against the plain version;
   ``refetch_exact`` of 7 of a batch's rows byte-equal to those rows;
18. 4 ``serve_main --routing bounds --num-hosts 4 --host-id i`` processes
   (a slab of 2,097,152 rows each) and 3 front ends (``python -m
   ...serve.frontend``: ``--on-host-loss fail``, the same with ``--wire
   f32``, ``--on-host-loss degrade``; query cache off), started together,
   each with a wall-clock limit, all killed on a failure: 18a a fixed
   list (uniform, blobs, rows on the copies, JSON and binary) byte-equal
   to one ``ResidentKnnEngine`` over the file, distance-0 ids ascending
   across hosts; 18b 8 closed-loop clients, a sweep then uniform rows:
   q/s, p50/p99, waves a batch, the rows certified after one host, wire
   bytes by codec, each host's sub-batches, 1,000 served rows against the
   exact answer, every launch in the hosts on the D=3 kernel; 18c the
   ``--wire f32`` front end byte-equal, ``pull_slab_rows`` with d16, f32
   and the single-shot body bit-equal to a host's slab; 18d one host
   answering 503 (``POST /faults``): requests away from it byte-equal,
   the others 503 with Retry-After (fail) or the surviving slabs' answer
   with the predicted ``exact`` flags (degrade); the fault cleared, the
   host rejoined through the front ends' monitors, the list byte-equal
   again; 18e a ``serve_main --routing bounds --standby`` process (started
   with the hosts) and one more front end (``serve.frontend.main`` in this
   process, ``--standbys`` it, ``--handoff-floor 1``, its monitor
   running): host 2 answering 503 is drained, the standby adopts slab 2
   from the file and is bound after its fingerprint matches; with host 2
   still down the list is byte-equal to 18a, ``exact`` true on every row,
   ``knn_handoffs_total 1``.

Then the replicate pod (``replicate_pod_phases``; its processes start
when 18b's traffic ends, so their start-up overlaps 18c-18e):

19. 4 ``serve_main --merge device --coordinator 127.0.0.1:C --num-hosts 4
   --host-id i`` processes on the same points (one gloo group, staged
   through pinned host memory: the processes share the card; one ring
   position of 2,097,152 rows each) and one front end (``--qcache-rows
   0``), each with a wall-clock limit, all killed on a failure: 19a a
   fixed list of 1, 7, 300 and 1024 rows, with rows on the copies across
   the first position edge, JSON and binary, byte-equal to one in-process
   ``ResidentKnnEngine(num_shards=4, merge="device")``, distance-0 ids
   ascending across the edge, and the hosts' fetched bytes one result a
   batch, a quarter each; 19b 8 closed-loop clients of uniform rows:
   q/s, p50/p99, straggler seconds, each host's fetched bytes a batch,
   1,000 served rows against the exact answer, every launch in the hosts
   on the D=3 kernel; 19c host 3 sent SIGTERM: the next request answers
   503 naming ``PodBrokenError`` and /healthz reports the break, then
   every child is killed.

Then the port's tools (``tooling_phases``), a ``serve_main`` child on
16s's raw file (k=100, R=1, ``--port 0``) and a ``tools/torch_lskcheck.py``
child started together:

20c. ``obs/cost.py`` ``cost_report`` over phase 4's two ``--timings`` runs
   (their ``pair_evals`` and ring seconds), the peak by the card's name;
20b. ``tools/torch_recall_harness.py`` on the card at its defaults (16,384
   points, k=16, 512 queries, three workloads): every measured recall in
   [0, 1], the policy file loaded by ``RecallPolicy.from_file``, and the
   exact plan's recall 1.0 on every workload against the plain traversal;
20d. the analyzer's full gate in its child: exit 0, zero findings;
20a. ``tools/torch_loadgen.py`` in a child process against the server,
   closed loop, 8 workers, binary rows of 1024, ``--server-stats``: 8 s
   uniform, then 8 s sweep, no errors; a 64-row probe before and after
   byte-equal and exact (ids up to ties); /stats: no plan built after
   warmup, one traversal launch a dispatched batch, all on the D=3
   kernel; q/s and p50/p99 a workload beside 16a's in-thread q/s.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Details go to
``build/smoke/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, redirect_stderr, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
N_MAIN = 1_000_000
SEED = 20261016
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# The data sheet's FP32 rate counts a fused multiply-add as two FLOPs:
# 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz. The exact kernels fuse nothing
# (each (q-p)*(q-p) is rounded before its add), so each sub, mul, add and
# compare is one issue of an FP32 lane: 132 x 128 x 1.98e9 = 33.5e12
# operations/s, half the data sheet's rate. The FMA-free bound of an f32
# kernel is its operations at this rate (or its bytes, if longer).
PEAK_F32_ISSUE = 33.5e12
OPS_PER_PAIR = 9   # 3 sub, 3 mul, 2 add, 1 compare
SOURCE = "mpi_cuda_largescaleknn_torch/csrc/knn_tiled.cu"
REPLACES = "mpi_cuda_largescaleknn_tpu/ops/pallas/knn_tiled.py:54"
RING_REPLACES = "mpi_cuda_largescaleknn_tpu/ops/pallas/knn_tiled.py:161"
BF_SOURCE = "mpi_cuda_largescaleknn_torch/csrc/knn_bf.cu"
BF_REPLACES = "mpi_cuda_largescaleknn_tpu/ops/pallas/knn_bf.py:173"
MXU_SOURCE = "mpi_cuda_largescaleknn_torch/csrc/knn_tiled_mxu.cu"
MXU_REPLACES = "mpi_cuda_largescaleknn_tpu/ops/pallas/knn_tiled.py:135"
KERNELS = ("knn_tiled", "knn_bf", "knn_tiled_mxu")  # sources in csrc/
PLAIN_QUERIES = 16_384  # the brute-force plain version's reduced shape
PEAK_BF16 = 989e12      # dense bf16 tensor-core FLOP/s (same data sheet)
HD_DIM, HD_K = 128, 10  # phase 10: the SIFT1M shape and its recall@10
HD_SUB = 262_144        # phase 10b: points cut into 4 .npy slab parts
GIST_DIM = 960          # phase 10c: GIST1M's width, on HD_SUB points
GIST_SELFCHECK = 50     # phase 10c: samples checked on the card
HD_SELFCHECK = 200      # phases 10, 10b: samples checked on the card
                        # (kth_distance_card; on the host, 200 took phase
                        # 10 39.3-90.1 s, its three runs ~7 s of it)
PLAIN_BUCKETS = 16      # phase 11: query buckets the plain versions run
N_WALL, WALL_K = 8_388_608, 100  # phase 13a: the candidate rows' memory wall
WALL_CHUNK = 1_048_576           # phase 13a: 8 chunks
CKPT_CHUNK = 65_536              # phase 13b: 4 chunks of a 250,000-row shard
MERGE_CHUNK = 1_000              # phase 13c: query buckets of 4 x 1,000 rows
N_BIG, BIG_K = 33_554_432, 100   # phase 14: one raw file, run only chunked
BIG_PARTS = 8                    # phase 14b: Morton parts of that file
BIG_CHUNK = 4_194_304            # phase 14c: query rows a chunk (8 chunks)
BIG_SELFCHECK = 200              # phase 14c: host samples (was 1000)
# the pre-partitioned CLI's --query-chunk counts rows of each shard: 8
# parts x 524,288 rows make chunks of BIG_CHUNK rows, as the unordered run
BIG_PART_CHUNK = BIG_CHUNK // BIG_PARTS
N_ENGINE = 131_072               # phase 15b-d: the flat engines' points
N_ENGINE_HD = 65_536             # phase 15a-b: D=128 (phase 10b's first;
                                 # its 262,144 took the twin 104.5 s in f32)
XLA_ENGINES = ("tiled", "bruteforce", "tree")
SERVE_CLIENTS = 8                # phase 16: closed-loop clients
SERVE_SECONDS = 8.0              # 16a: traffic a configuration
SERVE_SECONDS_HD = 5.0           # 16b: traffic a configuration
SERVE_SAMPLE = 1000              # served rows held against the exact answer
SERVE_MAX_BATCH = 1024           # the widest shape bucket (the default)
SERVE_FIXED = 16                 # 16a: requests of the fixed list (check 2)
SERVE_FIXED_HD = 9               # 16b: the same (a D=128 batch walks all
                                 # 1M points: ~250 ms in f32 on an H100)
TIER_SLABS = 8                   # 16s: N_WALL points in slabs of 1,048,576
TIER_BUDGET_SLABS = 2            # 16s: the device budget (4x over it)
TIER_HOST_SLABS = 4              # 16s: the host pool, in slabs' bytes
TIER_PREFETCH = 2                # 16s: --prefetch-depth
TIER_PROBE = 64                  # 16s/16t: probe rows held to a resident
SWEEP_PERIOD = 4.0               # 16s: seconds a sweep of the diagonal
SWEEP_SIGMA = 0.05               # 16s: the sweep's blob sigma
TENANTS = 4                      # 16t: tenants, each
TENANT_POINTS = 2_097_152        # ... this many Morton-sorted points
TENANT_SLABS = 4                 # ... in this many slabs (16 in all)
TENANT_BUDGET_SLABS = 6          # 16t: the shared device budget
TENANT_QUOTA = 512               # 16t: --tenant-quota-rows
TENANT_SKEW = 4.0                # 16t: rank i gets 1/(i+1)^4 of requests
TENANT_SECONDS = 4.0             # 16t: traffic
TENANT_MAX_ROWS = 256            # 16t: rows a request, log-uniform from 1


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


#: (phase, start time) of each phase, in order, as ``say`` announces them
PHASE_STARTS = []


def say(msg: str) -> None:
    if msg.startswith("[phase "):
        PHASE_STARTS.append((msg[7:msg.index("]")], time.perf_counter()))
    print(msg, flush=True)


@contextmanager
def timed_step(steps: dict, name: str):
    """Stores the seconds of its block, on the host's clock, in
    ``steps[name]``."""
    t0 = time.perf_counter()
    yield
    steps[name] = time.perf_counter() - t0


def seeded_points(kind: str, n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((n, 3), dtype=np.float32)
    centers = rng.random((32, 3), dtype=np.float32) * 100.0
    pick = rng.integers(0, len(centers), n)
    return (centers[pick] + rng.normal(0.0, 0.5, (n, 3))).astype(np.float32)


def grid_points(n: int, seed: int):
    """``n`` points on the integer grid [0, 24)^3: most distances are
    shared by many pairs and many points repeat, so exact ties meet at the
    k-th slot and across the lane borders of the warp fold."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 24, (n, 3)).astype(np.float32)


def clustered_nd(n: int, dim: int, seed: int):
    """``n`` points in ``dim`` dimensions: 32 Gaussian clusters, centres
    drawn N(0, 4^2) per component, sigma 1 (zero-mean data, so the bf16
    matmul form's error, which grows with |q||p|, stays small)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, (32, dim)).astype(np.float32)
    pts = rng.standard_normal((n, dim), dtype=np.float32)
    pts += centers[rng.integers(0, 32, n)]
    return pts


def kth_distance_card(points, query_idx, k, max_radius=float("inf"),
                      device="cuda", block_elems=1 << 26):
    """The card's twin of ``obs/selfcheck.py`` ``kth_distance_exact``:
    the exact k-th-NN distance of ``points[query_idx]`` against every
    point, by the same recipe, ``((d0*d0 + d1*d1) + d2*d2) ...`` summed
    left to right, each sub, mul and add its own eager op (its own
    rounding: no kernel of the port, no FMA). The points stream in blocks
    of ``block_elems / Q`` columns (components laid out [D, N], so a
    component's block is contiguous); each block's distances join the
    running k smallest (radius**2 slots to start) through a stable sort,
    so ties cannot change the k-th value. The square root is numpy's, on
    the host. Returns f32[Q]."""
    import numpy as np
    import torch

    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)) \
        .to(device)
    q = pts[torch.from_numpy(np.asarray(query_idx, np.int64)).to(device)]
    cols = pts.t().contiguous()
    del pts
    nq, dim = q.shape
    r2 = float(np.float32(max_radius) ** 2)
    best = torch.full((nq, k), r2, dtype=torch.float32, device=device)
    block = max(1024, block_elems // max(1, nq))
    for lo in range(0, cols.shape[1], block):
        c = cols[:, lo:lo + block]
        d2 = q[:, 0:1] - c[0:1]
        d2.mul_(d2)
        t = torch.empty_like(d2)
        for i in range(1, dim):
            torch.sub(q[:, i:i + 1], c[i:i + 1], out=t)
            t.mul_(t)
            d2.add_(t)
        best = torch.sort(torch.cat([best, d2], 1), dim=1,
                          stable=True).values[:, :k]
    return np.sqrt(best[:, k - 1].cpu().numpy())


def verify_sample_card(points, dists, k, num_samples,
                       max_radius=float("inf"), seed=0, rtol=1e-5,
                       atol=1e-6, device="cuda") -> int:
    """``obs/selfcheck.py`` ``verify_sample`` with the exact answer from
    ``kth_distance_card``: the same samples (``seed``), the same
    tolerance and the same inf pattern; fails the phase on a mismatch.
    Returns the samples checked."""
    import numpy as np

    n = len(points)
    num_samples = min(num_samples, n)
    idx = np.random.default_rng(seed).choice(n, size=num_samples,
                                             replace=False)
    want = kth_distance_card(points, idx, k, max_radius, device=device)
    got = np.asarray(dists)[idx]
    inf_mismatch = np.isinf(got) != np.isinf(want)
    if inf_mismatch.any():
        i = int(np.argmax(inf_mismatch))
        fail(f"selfcheck FAILED: point {idx[i]} got {got[i]}, exact "
             f"{want[i]}")
    finite = ~np.isinf(want)
    if not np.allclose(got[finite], want[finite], rtol=rtol, atol=atol):
        err = np.abs(got[finite] - want[finite])
        i = int(np.argmax(err))
        fail(f"selfcheck FAILED: point {idx[finite][i]} got "
             f"{got[finite][i]}, exact {want[finite][i]} (|err| "
             f"{err[i]:.3g})")
    return num_samples


def max_abs_err(got, want) -> float:
    """Max abs difference of the entries finite on both sides."""
    import torch

    fin = torch.isfinite(want) & torch.isfinite(got)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0


def cuda_ms(fn):
    """(milliseconds of ``fn()`` on the card by CUDA events, its result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), result


def tie_rows(got_idx, want_idx, queries, points) -> int:
    """Rows whose ids differ between two results with bitwise-equal d2:
    checks that each such row of both results holds distinct ids whose
    exact distances to the query, sorted, are equal, so the two differ
    only in which of several equally distant points they keep. Returns the
    count; fails on any other difference. ``queries`` are the rows'
    coordinates, ``points`` are indexed by id."""
    import torch

    bad = (got_idx != want_idx).any(dim=1)
    n = int(bad.sum())
    if n == 0:
        return 0
    q = queries[bad]
    exact = []
    for ids in (got_idx[bad], want_idx[bad]):
        srt = ids.sort(dim=1).values
        if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
            fail("a row holds the same neighbor twice")
        pg = points[ids.clamp(min=0).long()]
        acc = None
        for i in range(q.shape[-1]):
            di = q[:, None, i] - pg[..., i]
            acc = di * di if acc is None else acc + di * di
        exact.append(torch.where(ids >= 0, acc, torch.inf).sort(dim=1).values)
    if not torch.equal(exact[0], exact[1]):
        fail(f"{n} rows differ in their neighbors' distances, not only in "
             "the order of ties")
    return n


def route_counts() -> dict:
    """Launches so far of each kernel of the traversal and flat modules,
    by route: "d3", "ring" (queries resident), "stream" (D streamed)
    (csrc/knn_tiled.cu), "wgmma" (query halves resident), "wgmma_stream"
    (D streamed) (csrc/knn_tiled_mxu.cu), "bf_d3" (csrc/knn_bf.cu),
    "bf_ring" (the flat fold on csrc/knn_tiled.cu's ring kernel)."""
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda as kt,
    )

    bf = knn_update_bf_cuda
    return {"d3": kt.d3_launches, "ring": kt.ring_launches,
            "stream": kt.stream_launches, "wgmma": kt.wgmma_launches,
            "wgmma_stream": kt.wgmma_stream_launches,
            "bf_d3": bf.d3_launches, "bf_ring": bf.ring_launches}


def compare_case(name, pts_np, k, *, radius=float("inf"), bucket_size=256,
                 group=2, warm=True, score_dtype="f32", route=None,
                 canonical=False, max_grid_y=None):
    """Traversal kernel vs plain on the card for one input (f32: the D=3
    or the ring kernel; bf16: the tensor-core kernel, whose
    rows must also equal the f32 kernel's up to the order of exact ties);
    ``route`` names the kernel the case must plan, and the launch counters
    show it ran there; ``max_grid_y`` caps the blocks of rows a launch
    takes (a bucket past it goes in several launches). Returns the max abs
    difference of the finite d2 entries (0.0 when bitwise equal)."""
    import torch

    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    pts = torch.from_numpy(pts_np).cuda()
    q = partition_points(pts, bucket_size=bucket_size)
    pc = coarsen_buckets(q, group)
    state = (warm_start_self(pc, k, radius) if warm else
             init_candidates(q.num_buckets * q.bucket_size, k, radius,
                             device=pts.device))
    return check_traversal(name, state, q, pc, pts, skip_self=warm,
                           group=group, score_dtype=score_dtype, route=route,
                           canonical=canonical, max_grid_y=max_grid_y)


def check_traversal(name, state, q, pc, pts, *, skip_self, group,
                    score_dtype="f32", route=None, canonical=False,
                    prepared=None, max_grid_y=None):
    """The traversal kernel vs its plain version on the card: rows
    ``state`` of the query side ``q`` folded with the point side ``pc``
    (``pts`` indexed by its ids). d2 bitwise, visits equal (at most the
    plain count where a bucket is split over blocks), ids equal (bf16: up
    to exact ties, and d2 equal to the f32 kernel's; with ``canonical``,
    both sides' ``canonical_ties``, ids equal in bf16 too), the launch on
    the ``route`` planned. Returns the max abs difference of the finite d2
    entries (0.0 when bitwise equal). ``prepared`` (``prepare_points``)
    is the kernel's resident point side; the plain version ignores it.
    ``max_grid_y`` (default the grid's limit) caps the blocks of rows of a
    launch, so a smaller cap splits the bucket into several launches."""
    import torch

    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        MAX_GRID_Y,
        WGMMA_LANES,
        WGMMA_ROWS,
        knn_update_tiled_cuda,
        knn_update_tiled_plain,
        mxu_launch_geometry,
        prepare_points,
        survivor_width,
        tiled_launch_plan,
        uses_mxu,
    )

    dim = q.pts.shape[-1]
    k = state.dist2.shape[1]
    kw = dict(skip_self=skip_self, self_group=group, with_stats=True,
              score_dtype=score_dtype, canonical_ties=canonical)
    want, want_vis = knn_update_tiled_plain(state, q, pc, **kw)
    before = route_counts()
    got, got_vis = knn_update_tiled_cuda(state, q, pc, prepared=prepared,
                                         max_grid_y=max_grid_y or MAX_GRID_Y,
                                         **kw)
    torch.cuda.synchronize()
    same_inf = torch.equal(torch.isinf(got.dist2), torch.isinf(want.dist2))
    err = max_abs_err(got.dist2, want.dist2)
    if uses_mxu(score_dtype, dim):
        plan = mxu_launch_geometry(dim, survivor_width(k, pc))
    else:
        plan = tiled_launch_plan(q.bucket_size, pc.bucket_size, k, dim)
    if route is not None and plan.kernel != route:
        fail(f"case {name}: planned the {plan.kernel} kernel, not the "
             f"{route} one")
    ran = route_counts()
    for kernel, n in ran.items():
        if n - before[kernel] != (kernel == plan.kernel):
            fail(f"case {name}: planned the {plan.kernel} kernel, but "
                 f"{n - before[kernel]} {kernel} launches ran")
    rows, lanes = ((WGMMA_ROWS, WGMMA_LANES) if uses_mxu(score_dtype, dim)
                   else (plan.rows, plan.lanes))
    one_block = rows >= q.bucket_size
    plan_txt = f" {plan.kernel}"
    if plan.stages > 1:
        plan_txt += (f" stages={plan.stages} rows_in_smem="
                     f"{plan.rows_in_smem}")
    if getattr(plan, "slice_groups", 0):
        plan_txt += f" slice_groups={plan.slice_groups}"
    if getattr(plan, "slice_width", 0):
        plan_txt += f" slice_width={plan.slice_width}"
    # a bucket split over blocks prunes per block: at most the plain count
    vis_ok = bool((got_vis == want_vis).all() if one_block
                  else (got_vis <= want_vis).all())
    ok = torch.equal(got.dist2, want.dist2) and same_inf and vis_ok
    ties = ""
    if score_dtype == "f32" or canonical:
        ok = ok and torch.equal(got.idx, want.idx)
    if score_dtype != "f32" and ok:
        # under bf16 equal exact distances keep the order of their
        # approximate scores, whose last bits depend on the order of
        # accumulation: ids may differ among exact ties, nowhere else
        qrows = q.pts.reshape(-1, dim)
        exact = knn_update_tiled_cuda(state, q, pc, skip_self=skip_self,
                                      self_group=group,
                                      canonical_ties=canonical,
                                      prepared=(None if prepared is None else
                                                prepare_points(pc)))
        torch.cuda.synchronize()
        if not torch.equal(got.dist2, exact.dist2):
            fail(f"case {name}: bf16 distances differ from the f32 kernel's "
                 f"in {int((got.dist2 != exact.dist2).any(1).sum())} rows")
        ties = (f", ids: {tie_rows(got.idx, want.idx, qrows, pts)} rows vs "
                f"plain and {tie_rows(got.idx, exact.idx, qrows, pts)} vs the "
                "f32 kernel differ only among equally distant points")
    if max_grid_y:
        plan_txt += f" grid-y cap {max_grid_y}"
    say(f"  {name}: D={dim} B={q.num_buckets} S={q.bucket_size} "
        f"T={pc.bucket_size} k={k}{plan_txt} rows/block={rows} "
        f"lanes/tile={lanes} visits={int(got_vis.sum())} "
        f"(plain {int(want_vis.sum())}"
        f"{'' if one_block else ', rows split'}) max_abs_err={err} "
        f"{'bit-equal' if ok else 'MISMATCH'}{ties}")
    if not ok:
        fail(f"kernel disagrees with its plain version in case {name}")
    return err


FAULT_ROWS = 2_097_152  # phase 3: a D=3 bucket of 65,536 blocks of 32 rows


def grid_split_cases(uni):
    """Phase 3's cases of launches split along the grid's y axis (at most
    65,535 blocks of rows a launch), each against its plain version bit
    for bit: the fault's shape, one D=3 query bucket of ``FAULT_ROWS``
    uniform rows at k=8 (65,536 blocks of 32 rows: two launches) against
    16 point buckets of 256, cold; and the split forced by a cap of 3
    blocks on buckets of 1,000 rows, on each kernel: D=3 (32 blocks), the
    ring kernel at D=16 and the wgmma kernel in bf16 at D=128 (8 blocks of
    128 each). Returns the max abs error."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points

    q_np = seeded_points("uniform", FAULT_ROWS, SEED + 120)
    q = partition_points(torch.from_numpy(q_np).cuda(),
                         bucket_size=FAULT_ROWS)
    p_t = torch.from_numpy(uni[:4096]).cuda()
    pc = partition_points(p_t, bucket_size=256)
    state = init_candidates(FAULT_ROWS, 8, device=p_t.device)
    errs = [check_traversal(
        f"one D=3 bucket of {FAULT_ROWS} rows, k=8 (65,536 blocks)", state,
        q, pc, p_t, skip_self=False, group=1, route="d3")]
    del q, state
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 121)
    errs += [
        compare_case("D=3 S=1000 k=33, grid-y cap 3 (11 launches)",
                     uni[:16_000], 33, bucket_size=1000, max_grid_y=3,
                     route="d3"),
        compare_case("ring D=16 S=1000 k=10, grid-y cap 3 (3 launches)",
                     rng.normal(size=(16_000, 16)).astype(np.float32), 10,
                     bucket_size=1000, max_grid_y=3, route="ring"),
        compare_case("wgmma bf16 D=128 S=1000 k=10, grid-y cap 3 (3 "
                     "launches)", clustered_nd(16_000, 128, SEED + 122), 10,
                     bucket_size=1000, max_grid_y=3, score_dtype="bf16",
                     route="wgmma")]
    return max(errs)


def chunk_sides(pts_np, num_shards, k, chunk_rows):
    """``ring_knn_chunked``'s pieces on the card for ``pts_np`` in
    ``num_shards`` slabs, built by its own helpers: (its ``RingFns``, the
    resident sides, the point group, the last chunk's number, and a
    function of ``c`` giving chunk ``c`` of every slab as ``chunk_slabs``
    does)."""
    from mpi_cuda_largescaleknn_torch.models.sharding import (
        pad_and_flatten,
        slab_bounds,
    )
    from mpi_cuda_largescaleknn_torch.parallel.ring import (
        _effective_group,
        _make_ring_fns,
        _sharded_input,
        chunk_slabs,
        resolve_bucket_size,
    )

    bnds = slab_bounds(len(pts_np), num_shards)
    flat, ids, _counts, npad = pad_and_flatten(
        [pts_np[b:e] for b, e in bnds], [b for b, _ in bnds],
        pts_np.shape[1])
    pts, ids_t, slabs = _sharded_input(flat, ids, num_shards, "cuda")
    del flat, ids
    bucket = resolve_bucket_size(0, "pallas_tiled")
    group = _effective_group(0, npad, bucket, "pallas_tiled")
    fns = _make_ring_fns(k, float("inf"), "pallas_tiled", 2048, 2048,
                         bucket, num_shards, point_group=group)
    resident = [fns.shard_init_fn(p, i)[1] for p, i in slabs]
    pts3 = pts.view(num_shards, npad, -1)
    ids2 = ids_t.view(num_shards, npad)
    last = -(-npad // chunk_rows) - 1
    return (fns, resident, group, last,
            lambda c: chunk_slabs(pts3, ids2, c, chunk_rows))


def chunk_cases():
    """Phase 3e: the kernels on the query sides of ``ring_knn_chunked``,
    built by its own helpers, against their plain versions on the same
    card tensors, cold and without ``skip_self``, as the chunked loops
    fold them. Phase 13c's device merge (262,144 uniform points, R=4,
    chunks of 1,000 rows): the chunk gathered into one query bucket of
    4,000 rows (``chunk_bucket``), the first chunk and the last (536 real
    rows a shard), against one shard's resident side (65,536 points
    coarsened at G=2), k=8, on the D=3 traversal and the flat D=3 kernel.
    The host merge: a chunk partition (``choose_buckets(16,384)``; the
    first chunk and the last, part padding) against the whole shard
    coarsened at G=2, R=1, at D=3 k=100 (phase 13a's route and k), and at
    D=128 k=10 in f32 (the ring kernel) and bf16 (``wgmma``). Returns the
    max abs difference of the finite d2 entries."""
    import torch

    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.parallel.ring import chunk_bucket

    errs = []
    uni = seeded_points("uniform", HD_SUB, SEED + 9)   # phase 13c's points
    every = torch.from_numpy(uni).cuda()
    _fns, resident, group, last, chunk = chunk_sides(uni, 4, 8, MERGE_CHUNK)
    for c, shard in ((0, 0), (last, 3)):
        lo, hi, qp, _qi = chunk(c)
        rows = qp.view(-1, 3)
        qb = chunk_bucket(rows)
        cold = init_candidates(rows.shape[0], 8, float("inf"),
                               device=rows.device)
        errs.append(check_traversal(
            f"device-merge chunk {c} ({4 * (hi - lo)} real of "
            f"{rows.shape[0]} rows, one bucket) vs shard {shard} G{group} "
            "k=8 cold", cold, qb, resident[shard], every, skip_self=False,
            group=group, route="d3"))
        n4 = len(uni) // 4
        errs.append(compare_bf_case(
            f"flat device-merge chunk {c} ({4 * (hi - lo)} real of "
            f"{rows.shape[0]} rows) vs shard {shard} k=8",
            rows.cpu().numpy(), uni[shard * n4:(shard + 1) * n4], 8,
            id_base=shard * n4))
    del every, resident
    for label, pts_np, k, score, route in (
            ("D=3", seeded_points("uniform", 126_976, SEED + 40), 100,
             "f32", "d3"),
            ("D=128", clustered_nd(32_000, 128, SEED + 41), 10, "f32",
             "ring"),
            ("bf16 D=128", clustered_nd(32_000, 128, SEED + 41), 10, "bf16",
             "wgmma")):
        fns, resident, group, last, chunk = chunk_sides(pts_np, 1, k, 16_384)
        every = torch.from_numpy(pts_np).cuda()
        for c in sorted({0, last}):
            lo, hi, qp, qi = chunk(c)
            q, cold = fns.query_init_fn(qp[0], qi[0])
            errs.append(check_traversal(
                f"{label} chunk {c} ({hi - lo} real of 16,384 rows, "
                f"{q.num_buckets} buckets) vs the shard G{group} k={k} cold",
                cold, q, resident[0], every, skip_self=False, group=group,
                score_dtype=score, route=route))
        del every, resident
    return max(errs)


def run_cli(args, timeout=900, module="unordered_main"):
    """One CLI run in a fresh process; returns (timings dict, stdout)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", f"mpi_cuda_largescaleknn_torch.cli.{module}",
           *args, "--timings"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout, check=False)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"CLI {module} {' '.join(args)} exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    timings = json.loads(proc.stderr.strip().splitlines()[-1])
    timings["process_seconds"] = wall
    return timings, proc.stdout


def cli_in_process(args, module):
    """One CLI run through its ``main`` in this process (the card's context
    and the libraries already loaded, so no process start-up: phase 15
    runs seven of them); returns (timings dict, stdout) as ``run_cli``
    does, ``process_seconds`` being the call's."""
    import importlib
    from io import StringIO

    cli = importlib.import_module(f"mpi_cuda_largescaleknn_torch.cli.{module}")
    out, err = StringIO(), StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main([*args, "--timings"])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"CLI {module} {' '.join(args)} returned {rc}:\n"
             f"{out.getvalue()[-3000:]}\n{err.getvalue()[-3000:]}")
    timings = json.loads(err.getvalue().strip().splitlines()[-1])
    timings["process_seconds"] = wall
    return timings, out.getvalue()


def report_run(label, t, kernel_key, selfcheck=True):
    """Print a CLI run's timings: run time, launches, memory and every
    timed stage in the order it ran."""
    say(f"  {label}: run {t['run_seconds']:.3f} s, "
        f"{t['queries_per_second']:.0f} queries/s, knn_tiled launches "
        f"{t['knn_tiled_launches']}, knn_bf launches {t['knn_bf_launches']}, "
        f"peak device memory {t['peak_device_bytes'] / 2**20:.1f} MiB, "
        f"process {t['process_seconds']:.1f} s"
        f"{', selfcheck OK' if selfcheck else ''}")
    say("    stages: " + ", ".join(
        f"{name} {v['seconds']:.4f} s" for name, v in t.items()
        if isinstance(v, dict) and "seconds" in v))
    if t[kernel_key] < 1:
        fail(f"{label}: {kernel_key} is 0: the kernel was never launched")


def main_path_run(label, pts_path, out_path, k, shards, n, engine="auto"):
    import numpy as np

    t, out = run_cli([str(pts_path), "-o", str(out_path), "-k", str(k),
                      "--shards", str(shards), "--engine", engine,
                      "--selfcheck", "1000"])
    if "selfcheck OK (1000 samples)" not in out:
        fail(f"{label}: no selfcheck line in\n{out}")
    d = np.fromfile(out_path, dtype=np.float32)
    if d.shape != (n,) or not np.all(np.isfinite(d)) or np.any(d <= 0):
        fail(f"{label}: output has shape {d.shape} or non-finite/zero values")
    report_run(label, t, "knn_bf_launches" if engine == "pallas"
               else "knn_tiled_launches")
    check_d3_route(label, t)
    say(f"    pair_evals {t['pair_evals']}")
    return t


def first_launch_child() -> None:
    """Runs in a fresh process (``first_launch_split``): the kernel
    library's load (``dlopen`` and its CUDA runtime's start), then phase
    4's k=8 run through ``UnorderedKNN``, at R=1 twice and then at R=4,
    with each D=3 launch's visit schedule (``nearest_first_order``, timed
    on the host between synchronisations), layout (``d3_lanes``) and kernel
    timed apart, the last two by CUDA events. The first launch's kernel
    time holds the kernel's loading into the process, as in every CLI run
    of phases 4-8. Prints one JSON line."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN
    from mpi_cuda_largescaleknn_torch.ops import knn_tiled

    kt = knn_tiled.knn_update_tiled_cuda
    pts = seeded_points("uniform", N_MAIN, SEED + 2)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn_tiled._library("knn_tiled")
    load_ms = (time.perf_counter() - t0) * 1e3
    schedule_ms = []
    order_fn = knn_tiled.nearest_first_order

    def timed_order(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = order_fn(*args)
        torch.cuda.synchronize()
        schedule_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    knn_tiled.nearest_first_order = timed_order
    runs = [{"label": "library load", "ms": load_ms}]
    for label, shards in (("R=1, the process's first", 1),
                          ("R=1 again", 1), ("R=4", 4)):
        events = []
        schedule_ms.clear()
        kt.layout_events = events
        kt.launches = kt.d3_launches = 0
        model = UnorderedKNN(KnnConfig(k=8, num_shards=shards))
        model.run(pts)
        torch.cuda.synchronize()
        kt.layout_events = None
        runs.append({
            "label": label,
            "traverse": model.timers.report()["traverse"]["seconds"],
            "launches": kt.launches, "d3_launches": kt.d3_launches,
            "schedule_ms": list(schedule_ms),
            "layout_ms": [a.elapsed_time(b) for a, b, _ in events],
            "kernel_ms": [b.elapsed_time(c) for _, b, c in events]})
    print(json.dumps(runs))


def first_launch_split():
    """``first_launch_child`` in a fresh process: where the traverse stage
    of a CLI run goes (layout, kernel, the first launch's loading)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.first_launch_child()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=False)
    if proc.returncode != 0:
        fail(f"first-launch child exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"  the kernel library's load: {runs[0]['ms']:.3f} ms")
    for r in runs[1:]:
        if r["launches"] < 1 or r["d3_launches"] != r["launches"]:
            fail(f"first-launch child, {r['label']}: {r['d3_launches']} of "
                 f"{r['launches']} launches on the D=3 kernel")
        say(f"  {r['label']}: traverse {r['traverse']:.4f} s, "
            f"{r['launches']} launches: visit schedule "
            f"{sum(r['schedule_ms']):.3f} ms (first "
            f"{r['schedule_ms'][0]:.3f}), layout {sum(r['layout_ms']):.3f} ms "
            f"(first {r['layout_ms'][0]:.3f}), kernel "
            f"{sum(r['kernel_ms']):.3f} ms (first {r['kernel_ms'][0]:.3f})")
    return runs


def prepartitioned_run(label, list_path, prefix, k, engine, num_parts,
                       selfcheck=1000, dim3=True, extra=()):
    """``prepartitioned_main`` over the parts of ``list_path`` (points at
    D=3 unless ``dim3`` is false) with the arguments ``extra`` and the
    CLI's own ``--selfcheck`` (none when ``selfcheck`` is 0: the caller
    checks the rank files); returns (timings, the rank files' bytes
    joined in rank order)."""
    import numpy as np

    check = ["--selfcheck", str(selfcheck)] if selfcheck else []
    t, out = run_cli([str(list_path), "-o", str(prefix), "-k", str(k),
                      "--engine", engine, *check, *extra],
                     module="prepartitioned_main")
    if selfcheck and f"selfcheck OK ({selfcheck} samples)" not in out:
        fail(f"{label}: no selfcheck line in\n{out}")
    files = [Path(f"{prefix}_{r:06d}.float") for r in range(num_parts)]
    joined = b"".join(f.read_bytes() for f in files)
    d = np.frombuffer(joined, dtype=np.float32)
    if not np.all(np.isfinite(d)) or np.any(d <= 0):
        fail(f"{label}: output has non-finite/zero values")
    if not 1 <= t["rounds"] <= num_parts // 2 + 1:
        fail(f"{label}: {t['rounds']} rounds, not in 1..{num_parts // 2 + 1}")
    report_run(label, t, "knn_bf_launches" if engine == "pallas"
               else "knn_tiled_launches", selfcheck=bool(selfcheck))
    if dim3:
        check_d3_route(label, t)
    say(f"    rounds {t['rounds']}, kernels_run {t['kernels_run']}, "
        f"rotations_run {t['rotations_run']}")
    return t, joined


def partition_file(pts_path, num_parts, prefix):
    """The port's partition tool on ``pts_path``; returns the list file."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_cuda_largescaleknn_torch.cli."
         "partition_main", str(pts_path), "-n", str(num_parts), "-o",
         str(prefix)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, check=False)
    if proc.returncode != 0:
        fail(f"partition_main exited {proc.returncode}:\n{proc.stderr}")
    say("  " + " ".join(line.split(" ->")[0] for line in
                        proc.stdout.splitlines() if line.startswith("#")))
    return Path(f"{prefix}.txt")


def compare_bf_case(name, q_np, p_np, k, *, radius=float("inf"), id_base=0,
                    split=None, tiles=(2048, 2048)):
    """Brute-force kernel vs its plain version on the card for one input;
    returns the max abs difference of the finite d2 entries (0.0 when
    bitwise equal). ``split`` folds the points in two calls; ``tiles`` are
    the kernel's (query_tile, point_tile); the plain version keeps its
    defaults, so a pass also shows the tiles do not change the result."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import (
        flat_plan,
        knn_update_bf_cuda,
        knn_update_bf_plain,
        launch_geometry,
    )

    q = torch.from_numpy(q_np).cuda()
    p = torch.from_numpy(p_np).cuda()
    ids = torch.arange(id_base, id_base + len(p), dtype=torch.int32,
                       device=p.device)
    ids = torch.where(p[:, 0] < PAD_SENTINEL / 2, ids, -1)
    state = init_candidates(len(q), k, radius, device=q.device)
    want = knn_update_bf_plain(state, q, p, ids)
    before = route_counts()
    qt, pt = tiles
    if split is None:
        got = knn_update_bf_cuda(state, q, p, ids, query_tile=qt,
                                 point_tile=pt)
    else:
        got = knn_update_bf_cuda(state, q, p[:split], ids[:split],
                                 query_tile=qt, point_tile=pt)
        got = knn_update_bf_cuda(got, q, p[split:], ids[split:],
                                 query_tile=qt, point_tile=pt)
    torch.cuda.synchronize()
    dim = p.shape[1]
    route = "bf_d3" if dim == 3 else "bf_ring"
    calls = 1 if split is None else 2
    for kernel, n in route_counts().items():
        if n - before[kernel] != (calls if kernel == route else 0):
            fail(f"case {name}: {n - before[kernel]} launches of the "
                 f"{kernel} route, {calls} of the {route} one planned")
    err = max_abs_err(got.dist2, want.dist2)
    ok = torch.equal(got.dist2, want.dist2) and torch.equal(got.idx, want.idx)
    if dim == 3:
        rows, lanes = launch_geometry(qt, pt, k)
        plan_txt = f"rows/block={rows} lanes/tile={lanes}"
    else:
        plan = flat_plan(k, dim)
        plan_txt = (f"ring kernel, {plan.kernel} stages={plan.stages} "
                    f"rows_in_smem={plan.rows_in_smem}"
                    + (f" slice_groups={plan.slice_groups}"
                       if plan.slice_groups else ""))
    say(f"  {name}: D={dim} Q={len(q)} N={len(p)} k={k} {plan_txt} "
        f"max_abs_err={err} {'bit-equal' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"knn_bf disagrees with its plain version in case {name}")
    return err


def bounds(ms, op_s, fma_free_op_s, nbytes):
    """A kernel's two bounds and its share of each: ``bound_ms`` with its
    operations at the data sheet's peaks (``op_s`` seconds), and
    ``fma_free_bound_ms`` with its FP32 operations at ``PEAK_F32_ISSUE``
    (``fma_free_op_s`` seconds); each the longer of those and ``nbytes``
    at ``PEAK_BYTES``."""
    byte_s = nbytes / PEAK_BYTES
    out = {}
    for key, t in (("bound", op_s), ("fma_free_bound", fma_free_op_s)):
        out[f"{key}_ms"] = max(t, byte_s) * 1e3
        out[f"{key}_by"] = "operations" if t >= byte_s else "bytes"
        out[f"share_of_{key}"] = out[f"{key}_ms"] / ms
    return out


def bound_txt(r) -> str:
    """Both bounds of a timed kernel and its share of each."""
    return (f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
            f"{100 * r['share_of_bound']:.1f}% of it), FMA-free bound "
            f"{r['fma_free_bound_ms']:.3f} ms ("
            f"{100 * r['share_of_fma_free_bound']:.1f}%)")


def visited_pairs(order, visits, q, p) -> int:
    """Pairs of real query rows and real point lanes (ids >= 0) that a walk
    with these per-query-bucket visit counts scores: each query bucket's
    real rows against the real lanes of the first ``visits`` point buckets
    of its nearest-first ``order`` (bucket padding left out)."""
    import torch

    lanes = (p.ids >= 0).sum(1)[order.long()]
    walked = (torch.arange(order.shape[1], device=order.device)
              < visits[:, None])
    return int(((q.ids >= 0).sum(1) * (lanes * walked).sum(1)).sum())


def block_walk(state, q, p, rows, self_group):
    """The D=3 traversal kernel's own walk in plain PyTorch: each block of
    ``rows`` query rows walks its bucket's nearest-first order and prunes
    on the radius of its own rows. That is the plain version run on the
    query buckets cut into sub-buckets of ``rows`` rows that keep their
    bucket's box (so its order) and its own point bucket. Returns the rows
    (in ``q``'s layout), the sub-buckets and their visit counts
    (i64[Bq * blocks a bucket])."""
    import torch
    from torch.nn.functional import pad

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_plain,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import BucketedPoints

    bq, s = q.ids.shape
    k = state.dist2.shape[1]
    nb = -(-s // rows)
    extra = nb * rows - s
    sub = BucketedPoints(
        pad(q.pts, (0, 0, 0, extra)).view(bq * nb, rows, -1),
        pad(q.ids, (0, extra), value=-1).view(bq * nb, rows),
        q.lower.repeat_interleave(nb, 0), q.upper.repeat_interleave(nb, 0),
        pad(q.pos, (0, extra), value=-1).view(bq * nb, rows))
    rows_in = CandidateState(
        pad(state.dist2.view(bq, s, k), (0, 0, 0, extra),
            value=float("inf")).view(-1, k),
        pad(state.idx.view(bq, s, k), (0, 0, 0, extra),
            value=-1).view(-1, k))
    # sub-bucket b's own point bucket is (b // nb) // self_group
    out, visits = knn_update_tiled_plain(rows_in, sub, p, skip_self=True,
                                         self_group=self_group * nb,
                                         with_stats=True)
    out = CandidateState(out.dist2.view(bq, nb * rows, k)[:, :s].reshape(-1, k),
                         out.idx.view(bq, nb * rows, k)[:, :s].reshape(-1, k))
    return out, sub, visits


def check_d3_route(label, t) -> None:
    """Fails unless every launch of a D=3 run's timings ``t`` went to the
    D=3 kernels (knn_tiled_d3_kernel, knn_bf_d3_kernel)."""
    for total, d3 in (("knn_tiled_launches", "knn_tiled_d3_launches"),
                      ("knn_bf_launches", "knn_bf_d3_launches")):
        if t[d3] != t[total]:
            fail(f"{label}: {t[d3]} of {t[total]} {total[:-9]} launches "
                 "took the D=3 kernel")
    say(f"    all {t['knn_tiled_launches']} knn_tiled and "
        f"{t['knn_bf_launches']} knn_bf launches on the D=3 kernels")


def check_ring_route(label, t, stream=False) -> None:
    """Fails unless every f32 traversal launch of a run's timings ``t``
    went to the ring kernel with the queries resident (D=128) or, with
    ``stream``, with D streamed."""
    key = "knn_tiled_stream_launches" if stream else "knn_tiled_ring_launches"
    what = "streamed" if stream else "resident"
    n, ring = t["knn_tiled_launches"], t[key]
    if n < 1 or ring != n:
        fail(f"{label}: {ring} of {n} knn_tiled launches took the ring "
             f"kernel's {what} route")
    say(f"  {label}: all {n} knn_tiled launches on the ring kernel's "
        f"{what} route")


def time_kernel(k, pts, reps=5):
    """The main path's fold at 1M points (R=1: one launch after the warm
    start): kernel time by CUDA events over ``reps`` launches on fresh
    copies of the warm rows, the plain version's time, the bounds on the
    real pairs the kernel's blocks scored (``block_walk``: each block
    prunes on its own rows) and, under ``plain_walk``, on those of the
    plain version's walk (each query bucket's radius over all its rows, as
    in the TPU kernel), and the warps an SM holds (fails below the plan's
    count)."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        d3_blocks_per_sm,
        d3_resident_warps,
        knn_update_tiled_plain,
        launch_knn_tiled,
        tiled_launch_plan,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        coarsen_buckets,
        nearest_first_order,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    q = partition_points(pts, bucket_size=256)
    pc = coarsen_buckets(q, 2)
    warm = warm_start_self(pc, k)
    sorted_d2, order = nearest_first_order(q.lower, q.upper,
                                           pc.lower, pc.upper)
    rows = CandidateState(warm.dist2.clone(), warm.idx.clone())
    launch_knn_tiled(order, sorted_d2, q, pc, rows, skip_self=True,
                     self_group=2)                      # warm-up
    total_ms = 0.0
    for _ in range(reps):
        rows.dist2.copy_(warm.dist2)
        rows.idx.copy_(warm.idx)
        ms, visits = cuda_ms(lambda: launch_knn_tiled(
            order, sorted_d2, q, pc, rows, skip_self=True, self_group=2))
        total_ms += ms
    ms = total_ms / reps
    plain_ms, (plain, plain_visits) = cuda_ms(lambda: knn_update_tiled_plain(
        warm, q, pc, skip_self=True, self_group=2, with_stats=True))
    if not (torch.equal(plain.dist2, rows.dist2)
            and torch.equal(plain.idx, rows.idx)):
        fail(f"k={k}: kernel and plain differ at the main path's shape")
    err = max_abs_err(rows.dist2, plain.dist2)

    bq, s = q.ids.shape
    bp, t = pc.ids.shape
    plan = tiled_launch_plan(s, t, k, 3)
    # the pairs the kernel's blocks scored: the walk of each block of
    # plan.rows rows on its own radius, checked against the kernel's rows
    # and its visits (the most of a bucket's blocks)
    walked, sub, block_visits = block_walk(warm, q, pc, plan.rows, 2)
    if not (torch.equal(walked.dist2, rows.dist2)
            and torch.equal(walked.idx, rows.idx)):
        fail(f"k={k}: the walk of the kernel's blocks gives other rows")
    if not torch.equal(block_visits.view(bq, -1).amax(1), visits.long()):
        fail(f"k={k}: the kernel's visits are not the most of its blocks' "
             "walks")
    nvis = int(plain_visits.sum())
    plain_pairs = visited_pairs(order, plain_visits, q, pc)
    # a sub-bucket walks its bucket's order
    pairs = visited_pairs(order.repeat_interleave(sub.num_buckets // bq, 0),
                          block_visits, sub, pc)
    ops = pairs * OPS_PER_PAIR
    nbytes = (bq * s * 16                 # query coords + ids
              + 2 * bq * s * k * 8        # candidate rows in and out
              + bp * t * 16               # point coords + ids
              + (nvis + bq) * 8)          # the visited schedule prefix
    plain_ops = plain_pairs * OPS_PER_PAIR
    plain_walk = bounds(ms, plain_ops / PEAK_F32, plain_ops / PEAK_F32_ISSUE,
                        nbytes)
    blocks = d3_blocks_per_sm(plan.threads, plan.smem)
    warps = d3_resident_warps(s, t, k)
    if warps < blocks * plan.threads // 32:
        fail(f"k={k}: the card holds {warps} warps an SM, the plan counted "
             f"on {blocks * plan.threads // 32}")
    return {"k": k, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "visits": nvis, "kernel_visits": int(visits.sum()),
            "block_visits": int(block_visits.sum()),
            "pairs": pairs, "plain_walk_pairs": plain_pairs, "ops": ops,
            "bytes": nbytes,
            **bounds(ms, ops / PEAK_F32, ops / PEAK_F32_ISSUE, nbytes),
            "plain_walk": plain_walk,
            "plan": plan._asdict(), "warps_per_sm": warps,
            "planned_warps_per_sm": blocks * plan.threads // 32,
            "Bq": bq, "S": s, "Bp": bp, "T": t}


def time_bf_kernel(k, pts, reps=3):
    """The flat path's one fold at 1M points (R=1: every query against
    every point): kernel time by CUDA events over ``reps`` launches on
    fresh rows, the plain version's time on the first PLAIN_QUERIES
    queries (all the points; it cannot run all 10^12 pairs in time), the
    rows of both compared, and the bound."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import (
        knn_update_bf_plain,
        launch_geometry,
        launch_knn_bf,
        resident_warps,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        CHUNK_LANES,
        d3_blocks_per_sm,
        d3_smem_bytes,
    )

    n = pts.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=pts.device)
    init = init_candidates(n, k, device=pts.device)
    # no warm-up launch: phase 3b has loaded the kernel, and one launch
    # here takes 0.5-4 s
    rows = CandidateState(init.dist2.clone(), init.idx.clone())
    total_ms = 0.0
    for _ in range(reps):
        rows.dist2.copy_(init.dist2)
        rows.idx.copy_(init.idx)
        total_ms += cuda_ms(lambda: launch_knn_bf(pts, pts, ids, rows))[0]
    ms = total_ms / reps
    nq = PLAIN_QUERIES
    plain_ms, plain = cuda_ms(lambda: knn_update_bf_plain(
        CandidateState(init.dist2[:nq], init.idx[:nq]), pts[:nq], pts, ids))
    if not (torch.equal(plain.dist2, rows.dist2[:nq])
            and torch.equal(plain.idx, rows.idx[:nq])):
        fail(f"knn_bf k={k}: kernel and plain differ at the flat shape")
    err = max_abs_err(rows.dist2[:nq], plain.dist2)

    rows, lanes = launch_geometry(2048, 2048, k)
    warps = resident_warps(k)
    planned = d3_blocks_per_sm(8 * rows, d3_smem_bytes(rows, lanes, k)) \
        * rows // 4
    if warps < planned:
        fail(f"knn_bf k={k}: the card holds {warps} warps an SM, the plan "
             f"counted on {planned}")
    blocks = -(-n // rows)
    pairs = n * n
    ops = pairs * OPS_PER_PAIR
    np_pad = -(-n // CHUNK_LANES) * CHUNK_LANES
    nbytes = (blocks * np_pad * 16        # the staged point set per block
              + n * 12                    # query coordinates
              + 2 * n * k * 8)            # candidate rows in and out
    return {"k": k, "ms": ms, "plain_ms": plain_ms,
            "plain_shape": f"{nq} queries x {n} points", "max_abs_err": err,
            "pairs": pairs, "ops": ops, "bytes": nbytes,
            **bounds(ms, ops / PEAK_F32, ops / PEAK_F32_ISSUE, nbytes),
            "rows_per_block": rows, "lanes": lanes,
            "warps_per_sm": warps, "planned_warps_per_sm": planned}


def reset_counts() -> None:
    """Every kernel launch count of the traversal and flat wrappers to 0."""
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda,
    )

    for name in ("launches", "ring_launches", "stream_launches",
                 "d3_launches", "mxu_launches", "wgmma_launches",
                 "wgmma_stream_launches"):
        setattr(knn_update_tiled_cuda, name, 0)
    for name in ("launches", "d3_launches", "ring_launches"):
        setattr(knn_update_bf_cuda, name, 0)
    # the XLA engines' work counters (cli/common.py launch_counts)
    from mpi_cuda_largescaleknn_torch.ops.tiled import knn_update_tiled
    from mpi_cuda_largescaleknn_torch.ops.traverse import knn_update_tree

    knn_update_tiled.folds = 0
    knn_update_tree.folds = knn_update_tree.steps = 0


def unordered_run(label, pts_np, k, shards, score_dtype, profile_dir=None,
                  engine="auto", neighbors=True, **config):
    """``UnorderedKNN`` in this process on ``pts_np`` (any D) with
    ``engine`` (and other ``KnnConfig`` fields in ``config``), with every
    kernel count set to 0 just before the run and read just after; each
    launch's preparation (the bf16 halves and norms, or the ring layouts,
    or ``d3_lanes``) and kernel are timed apart by the wrappers' CUDA
    events (``launch_ms``: [preparation, kernel] of each launch). With
    ``profile_dir`` the run is traced by ``profile_trace`` and its timings
    also hold the card's busy share and top kernels. Returns (timings,
    distances f32[N], neighbor ids i32[N, k] or None without
    ``neighbors``)."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts
    from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN
    from mpi_cuda_largescaleknn_torch.obs.trace import (
        device_summary,
        profile_trace,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import knn_update_bf_cuda
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda,
    )

    model = UnorderedKNN(KnnConfig(k=k, num_shards=shards, engine=engine,
                                   score_dtype=score_dtype, **config))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = []
    if score_dtype == "bf16":
        knn_update_tiled_cuda.mxu_events = events
    elif engine == "pallas":
        knn_update_bf_cuda.layout_events = events
    else:
        knn_update_tiled_cuda.layout_events = events
    with profile_trace(profile_dir) as prof:
        t0 = time.perf_counter()
        got = model.run(pts_np, return_neighbors=neighbors)
        wall = time.perf_counter() - t0
    dists, idx = got if neighbors else (got, None)
    knn_update_tiled_cuda.mxu_events = None
    knn_update_tiled_cuda.layout_events = None
    knn_update_bf_cuda.layout_events = None
    t = model.timers.report()
    t.update({"run_seconds": wall, "queries_per_second": len(pts_np) / wall,
              **launch_counts(),
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              **(model.last_stats or {})})
    if dists.shape != (len(pts_np),) or not np.all(np.isfinite(dists)) \
            or np.any(dists <= 0):
        fail(f"{label}: output has shape {dists.shape} or non-finite/zero "
             "values")
    key = ("knn_tiled_mxu_launches" if score_dtype == "bf16"
           else "knn_bf_launches" if engine == "pallas"
           else "knn_tiled_launches")
    say(f"  {label}: run {wall:.3f} s, {t['queries_per_second']:.0f} "
        f"queries/s, knn_tiled launches {t['knn_tiled_launches']} (ring "
        f"{t['knn_tiled_ring_launches']}, streamed "
        f"{t['knn_tiled_stream_launches']}), "
        f"knn_tiled_mxu launches {t['knn_tiled_mxu_launches']} (resident "
        f"{t['knn_tiled_wgmma_launches']}, streamed "
        f"{t['knn_tiled_wgmma_stream_launches']}), knn_bf "
        f"launches {t['knn_bf_launches']} (ring "
        f"{t['knn_bf_ring_launches']}), peak device memory "
        f"{t['peak_device_bytes'] / 2**20:.1f} MiB, pair_evals "
        f"{t['pair_evals']}")
    say("    stages: " + ", ".join(
        f"{name} {v['seconds']:.4f} s" for name, v in t.items()
        if isinstance(v, dict) and "seconds" in v))
    if t[key] < 1:
        fail(f"{label}: {key} is 0: the kernel was never launched")
    if prof is not None:
        summary = device_summary(prof, wall)
        t["profile"] = summary
        if summary["busy_share"] is None:
            say("    profile: device busy share not measured, top kernels "
                "not measured (the trace holds no device time)")
        else:
            say(f"    profile: the card was busy "
                f"{summary['device_seconds']:.4f} s of the {wall:.3f} s run "
                f"({100 * summary['busy_share']:.1f}%); top kernels by "
                "device time:")
            for row in summary["top"]:
                say(f"      {row['ms']:.3f} ms in {row['calls']} calls: "
                    f"{row['name'][:100]}")
    if events:
        torch.cuda.synchronize()
        t["launch_ms"] = [[a.elapsed_time(b), b.elapsed_time(c)]
                          for a, b, c in events]
        t["prep_ms"] = sum(p for p, _ in t["launch_ms"])
        t["kernel_ms"] = sum(kn for _, kn in t["launch_ms"])
        prep = ("halves, norms" if score_dtype == "bf16" else
                "d3_lanes" if pts_np.shape[1] == 3 else "ring layouts")
        say(f"    {score_dtype} launches: {len(events)}, kernel "
            f"{t['kernel_ms'] / len(events):.3f} ms per launch, "
            f"preparation ({prep}) "
            f"{t['prep_ms'] / len(events):.3f} ms per launch")
    return t, dists, idx


def time_hd_kernels(pts_np, k, reps=2):
    """Phase 11: the f32 ring kernel and the bf16 tensor-core kernel (the
    wgmma one) at phase 10's shape (the one fold of a 1-shard run after
    the warm start), each over ``reps`` launches on fresh copies of the
    warm rows: the kernel alone by the wrapper's CUDA events, and with its
    preparation (f32: the ring layouts; bf16: the packed halves and
    norms); the rows of both compared; the plain versions timed on the
    first PLAIN_BUCKETS query buckets and compared with the kernels' rows;
    and the bounds, on the real pairs the f32 walk visits (the work the
    data needs): f32 at 3*D+1 FP32 operations a pair; bf16 at 3*2*D
    tensor-core FLOP a pair at the bf16 peak and 4 FP32 operations of the
    epilogue a pair at the FP32 rate, whichever is longer; each at the data
    sheet's FP32 peak and at the FMA-free issue rate."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        WGMMA_LANES,
        WGMMA_ROWS,
        knn_update_tiled_cuda,
        knn_update_tiled_plain,
        launch_knn_tiled,
        launch_knn_tiled_mxu,
        mxu_launch_geometry,
        survivor_width,
        tiled_launch_plan,
        widen_rows,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        BucketedPoints,
        coarsen_buckets,
        nearest_first_order,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    pts = torch.from_numpy(pts_np).cuda()
    n, dim = pts.shape
    q = partition_points(pts, bucket_size=256)
    pc = coarsen_buckets(q, 2)
    warm = warm_start_self(pc, k)
    sorted_d2, order = nearest_first_order(q.lower, q.upper,
                                           pc.lower, pc.upper)
    s, t = q.bucket_size, pc.bucket_size
    w = survivor_width(k, pc)
    wide = widen_rows(warm, w)
    plan = mxu_launch_geometry(dim, w)
    ring_plan = tiled_launch_plan(s, t, k, dim)
    before = (knn_update_tiled_cuda.wgmma_launches,
              knn_update_tiled_cuda.ring_launches)
    runs = {}
    for mode, start_rows, launch in (("f32", warm, launch_knn_tiled),
                                     ("bf16", wide, launch_knn_tiled_mxu)):
        rows = CandidateState(start_rows.dist2.clone(),
                              start_rows.idx.clone())
        total = 0.0
        events = []
        knn_update_tiled_cuda.mxu_events = events if mode == "bf16" else None
        knn_update_tiled_cuda.layout_events = events if mode == "f32" else None
        for _ in range(reps):
            rows.dist2.copy_(start_rows.dist2)
            rows.idx.copy_(start_rows.idx)
            ms, visits = cuda_ms(lambda: launch(
                order, sorted_d2, q, pc, rows, skip_self=True, self_group=2))
            total += ms
        knn_update_tiled_cuda.mxu_events = None
        knn_update_tiled_cuda.layout_events = None
        # with the wrapper's preparation, and the kernel alone by the
        # wrapper's events
        runs[mode] = {
            "wrapper_ms": total / reps, "rows": rows, "visits": visits,
            "ms": sum(b.elapsed_time(c) for _, b, c in events) / reps,
            "prep_ms": sum(a.elapsed_time(b) for a, b, _ in events) / reps}
    if plan.kernel != "wgmma" or ring_plan.kernel != "ring" or \
            knn_update_tiled_cuda.wgmma_launches - before[0] != reps or \
            knn_update_tiled_cuda.ring_launches - before[1] != reps:
        fail("phase 11: the f32 and bf16 launches did not all take the ring "
             "and the wgmma kernels")
    f32_rows = runs["f32"]["rows"]
    bf_wide = runs["bf16"]["rows"]
    bf_rows = CandidateState(bf_wide.dist2[:, :k], bf_wide.idx[:, :k])
    qrows = q.pts.reshape(-1, dim)
    if not torch.equal(bf_rows.dist2, f32_rows.dist2):
        fail("phase 11: bf16 kernel distances differ from the f32 kernel's")
    ties = tie_rows(bf_rows.idx, f32_rows.idx, qrows, pts)

    nb = PLAIN_BUCKETS
    qs = BucketedPoints(q.pts[:nb], q.ids[:nb], q.lower[:nb], q.upper[:nb],
                        q.pos[:nb])
    sub = CandidateState(warm.dist2[:nb * s], warm.idx[:nb * s])
    plain = {mode: cuda_ms(lambda: knn_update_tiled_plain(
        sub, qs, pc, skip_self=True, self_group=2, score_dtype=mode))
        for mode in ("f32", "bf16")}
    for mode, rows in (("f32", f32_rows), ("bf16", bf_rows)):
        got = plain[mode][1]
        if not torch.equal(got.dist2, rows.dist2[:nb * s]):
            fail(f"phase 11: {mode} kernel and plain differ")
        if mode == "f32" and not torch.equal(got.idx, rows.idx[:nb * s]):
            fail("phase 11: f32 kernel and plain ids differ")
        if mode == "bf16":
            tie_rows(rows.idx[:nb * s], got.idx, qrows[:nb * s], pts)

    bq = q.num_buckets
    nvis = int(runs["f32"]["visits"].sum())
    pairs = visited_pairs(order, runs["f32"]["visits"], q, pc)
    schedule = (nvis + bq) * 8
    f32_ops = pairs * (3 * dim + 1)
    f32_bytes = 2 * n * (dim * 4 + 4) + 2 * n * k * 8 + schedule
    bf_tc = pairs * 3 * 2 * dim
    bf_epi = pairs * 4
    bf_bytes = 2 * n * (dim * 4 + 4) + 2 * n * w * 8 + schedule
    yardsticks = {
        "f32": (f32_ops / PEAK_F32, f32_ops / PEAK_F32_ISSUE, f32_bytes),
        "bf16": (max(bf_tc / PEAK_BF16, bf_epi / PEAK_F32),
                 max(bf_tc / PEAK_BF16, bf_epi / PEAK_F32_ISSUE), bf_bytes)}
    res = {}
    for mode, run in runs.items():
        err_rows = bf_rows if mode == "bf16" else run["rows"]
        res[mode] = {
            "ms": run["ms"], "wrapper_ms": run["wrapper_ms"],
            "prep_ms": run["prep_ms"], "plain_ms": plain[mode][0],
            "plain_shape": f"{nb} of {bq} query buckets ({nb * s} rows)",
            "max_abs_err": max_abs_err(plain[mode][1].dist2,
                                       err_rows.dist2[:nb * s]),
            "visits": int(run["visits"].sum()), "pairs": pairs,
            **bounds(run["ms"], *yardsticks[mode])}
    res["f32"].update({"ops": f32_ops, "bytes": f32_bytes,
                       "plan": ring_plan._asdict()})
    res["bf16"].update({"tensor_flop": bf_tc, "epilogue_ops": bf_epi,
                        "bytes": bf_bytes, "W": w,
                        "kernel": plan.kernel, "stages": plan.stages,
                        "rows_in_smem": plan.rows_in_smem,
                        "rows_per_block": WGMMA_ROWS,
                        "lanes_per_chunk": WGMMA_LANES,
                        "id_rows_differing_by_ties": ties})
    res["shape"] = {"N": n, "D": dim, "k": k, "Bq": bq, "S": s,
                    "Bp": pc.num_buckets, "T": t}
    return res


def time_offpath_kernels(hd_np):
    """Phase 11b: each kernel timed by CUDA events over one launch at a
    shape of its own, alone and with its wrapper's preparation (the ring
    layouts, or the bf16 halves and norms), its plain version timed on a
    reduced shape and compared with the kernel's rows there, and both
    bounds on the work this run's data needs:
    - the ring kernel's streamed traversal (``stream``): 262,144 clustered
      points at D=240 (above ``RESIDENT_MAX_DP4``), k=10, one traversal
      after the warm start; a bucket is one block, so its visits are the
      plain version's; the plain version on PLAIN_BUCKETS query buckets;
    - the wgmma kernel's streamed route (``wgmma_stream``): 65,536
      clustered points at D=600 (Dp=608, a short last slice), k=10, the
      bounds on the pairs of its own walk (the widened rows' radius); the
      plain bf16 version on PLAIN_BUCKETS query buckets;
    - the ring kernel's flat fold (``bf_ring``): the first 16,384 of phase
      10's points against all 1M at D=128, k=10; the plain version on 2,048
      queries x 131,072 points, against the kernel on the same.
    These are the shapes at which the kernels they replaced were timed."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.ops.knn_bf import (
        flat_plan,
        knn_update_bf_cuda,
        knn_update_bf_plain,
        launch_knn_bf,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda,
        knn_update_tiled_plain,
        launch_knn_tiled,
        launch_knn_tiled_mxu,
        mxu_launch_geometry,
        survivor_width,
        tiled_launch_plan,
        widen_rows,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        BucketedPoints,
        coarsen_buckets,
        nearest_first_order,
        partition_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.tiled import warm_start_self

    k = HD_K
    res = {}
    nb = PLAIN_BUCKETS
    for name, n, dim in (("knn_tiled_nd_ring_stream", 262_144, 240),
                         ("knn_tiled_mxu_stream", 65_536, 600)):
        pts = torch.from_numpy(clustered_nd(n, dim, SEED + 30 + dim)).cuda()
        q = partition_points(pts, bucket_size=256)
        pc = coarsen_buckets(q, 2)
        warm = warm_start_self(pc, k)
        sorted_d2, order = nearest_first_order(q.lower, q.upper,
                                               pc.lower, pc.upper)
        s, t = q.bucket_size, pc.bucket_size
        bf16 = name.startswith("knn_tiled_mxu")
        if bf16:
            w = survivor_width(k, pc)
            start = widen_rows(warm, w)
            plan = mxu_launch_geometry(dim, w)
            launch, mode = launch_knn_tiled_mxu, "bf16"
        else:
            start = warm
            plan = tiled_launch_plan(s, t, k, dim)
            launch, mode = launch_knn_tiled, "f32"
        if plan.kernel != ("wgmma_stream" if bf16 else "stream"):
            fail(f"phase 11b: {name} planned the {plan.kernel} route")
        before = route_counts()
        rows = CandidateState(start.dist2.clone(), start.idx.clone())
        events = []
        knn_update_tiled_cuda.mxu_events = events if bf16 else None
        knn_update_tiled_cuda.layout_events = None if bf16 else events
        wrapper_ms, visits = cuda_ms(lambda: launch(
            order, sorted_d2, q, pc, rows, skip_self=True, self_group=2))
        knn_update_tiled_cuda.mxu_events = None
        knn_update_tiled_cuda.layout_events = None
        ms = events[0][1].elapsed_time(events[0][2])
        after = route_counts()
        if after[plan.kernel] - before[plan.kernel] != 1:
            fail(f"phase 11b: {name} did not launch its kernel once")
        got = CandidateState(rows.dist2[:, :k], rows.idx[:, :k])
        qs = BucketedPoints(q.pts[:nb], q.ids[:nb], q.lower[:nb],
                            q.upper[:nb], q.pos[:nb])
        sub = CandidateState(warm.dist2[:nb * s], warm.idx[:nb * s])
        plain_ms, plain = cuda_ms(lambda: knn_update_tiled_plain(
            sub, qs, pc, skip_self=True, self_group=2, score_dtype=mode))
        if not torch.equal(plain.dist2, got.dist2[:nb * s]):
            fail(f"phase 11b: {name} and its plain version differ")
        if bf16:
            tie_rows(got.idx[:nb * s], plain.idx,
                     q.pts[:nb].reshape(-1, dim), pts)
        elif not torch.equal(plain.idx, got.idx[:nb * s]):
            fail(f"phase 11b: {name} and its plain version's ids differ")
        pairs = visited_pairs(order, visits, q, pc)
        schedule = (int(visits.sum()) + q.num_buckets) * 8
        nbytes = (2 * n * (dim * 4 + 4) + schedule
                  + 2 * n * rows.dist2.shape[1] * 8)
        if bf16:
            # the function's D components; the kernel also multiplies the
            # Dp - D zero columns, shown apart as padded_tensor_flop
            tc, epi = pairs * 3 * 2 * dim, pairs * 4
            yard = (max(tc / PEAK_BF16, epi / PEAK_F32),
                    max(tc / PEAK_BF16, epi / PEAK_F32_ISSUE), nbytes)
        else:
            ops = pairs * (3 * dim + 1)
            yard = (ops / PEAK_F32, ops / PEAK_F32_ISSUE, nbytes)
        res[name] = {
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "plain_shape": f"{nb} of {q.num_buckets} query buckets",
            "max_abs_err": max_abs_err(got.dist2[:nb * s], plain.dist2),
            "visits": int(visits.sum()), "pairs": pairs,
            "shape": {"N": n, "D": dim, "k": k, "S": s, "T": t},
            "plan": plan._asdict(), **bounds(ms, *yard)}
        if bf16:
            res[name].update(tensor_flop=tc,
                             padded_tensor_flop=pairs * 3 * 2 * plan.dp)
        del pts, q, pc, warm, start, rows, got

    # the flat fold on the ring kernel at D=128
    pts = torch.from_numpy(hd_np).cuda()
    n, dim = pts.shape
    nq = PLAIN_QUERIES
    ids = torch.arange(n, dtype=torch.int32, device=pts.device)
    init = init_candidates(nq, k, device=pts.device)
    rows = CandidateState(init.dist2.clone(), init.idx.clone())
    before = route_counts()
    events = []
    knn_update_bf_cuda.layout_events = events
    wrapper_ms, _ = cuda_ms(lambda: launch_knn_bf(pts[:nq], pts, ids, rows))
    knn_update_bf_cuda.layout_events = None
    ms = events[0][1].elapsed_time(events[0][2])
    pq, pp = 2048, 131_072
    small = CandidateState(init.dist2[:pq].clone(), init.idx[:pq].clone())
    launch_knn_bf(pts[:pq], pts[:pp], ids[:pp], small)
    if route_counts()["bf_ring"] - before["bf_ring"] != 2:
        fail("phase 11b: the flat fold did not launch the ring kernel")
    plain_ms, plain = cuda_ms(lambda: knn_update_bf_plain(
        CandidateState(init.dist2[:pq], init.idx[:pq]), pts[:pq], pts[:pp],
        ids[:pp]))
    if not (torch.equal(plain.dist2, small.dist2)
            and torch.equal(plain.idx, small.idx)):
        fail("phase 11b: the flat ring fold and its plain version differ")
    pairs = nq * n
    ops = pairs * (3 * dim + 1)
    # queries, points with their ids, and the rows in and out, once each
    nbytes = nq * dim * 4 + n * (dim * 4 + 4) + 2 * nq * k * 8
    res["knn_bf_ring"] = {
        "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "plain_shape": f"{pq} queries x {pp} points",
        "max_abs_err": max_abs_err(small.dist2, plain.dist2),
        "pairs": pairs, "shape": {"Q": nq, "N": n, "D": dim, "k": k},
        "plan": flat_plan(k, dim)._asdict(),
        **bounds(ms, ops / PEAK_F32, ops / PEAK_F32_ISSUE, nbytes)}
    return res


def counted_call(fn):
    """``fn()`` with every kernel count set to 0 just before it and read
    just after: (its result, the launch counts and ``run_seconds``)."""
    import torch

    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {**launch_counts(), "run_seconds": time.perf_counter() - t0}


def chunked_phases(pts_np, parts_list, auto8, sub, d_sub):
    """Phase 13: the chunked and stepwise loops on the card (13a the
    memory wall at 8M points and k=100, 13b checkpoint and resume against
    phases 5 and 8, 13c the device merge and the high-D chunked routes).
    Returns (details, the main-path runs whose launches count)."""
    import tempfile

    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.models.sharding import (
        pad_and_flatten,
        slab_bounds,
    )
    from mpi_cuda_largescaleknn_torch.obs.selfcheck import verify_sample
    from mpi_cuda_largescaleknn_torch.parallel.ring import (
        ring_knn_chunked,
        ring_knn_stepwise,
    )

    out, runs = {}, {}

    say(f"  13a: the memory wall, {N_WALL} uniform points, k={WALL_K}, R=1")
    wall = seeded_points("uniform", N_WALL, SEED + 8)
    label = "13a unchunked"
    runs[label], d_full, _ = unordered_run(label, wall, WALL_K, 1, "f32",
                                           neighbors=False)
    label = f"13a query_chunk={WALL_CHUNK}"
    runs[label], d_chunk, _ = unordered_run(label, wall, WALL_K, 1, "f32",
                                            neighbors=False,
                                            query_chunk=WALL_CHUNK)
    t_full, t_chunk = runs["13a unchunked"], runs[label]
    for name, t in runs.items():
        check_d3_route(name, t)
    if d_chunk.tobytes() != d_full.tobytes():
        fail("13a: chunked distances differ from the unchunked run's")
    if t_chunk["peak_device_bytes"] >= t_full["peak_device_bytes"]:
        fail(f"13a: chunked peak {t_chunk['peak_device_bytes']} B is not "
             f"below the unchunked {t_full['peak_device_bytes']} B")
    n_chunks = -(-N_WALL // WALL_CHUNK)
    t_chunk["chunks"] = n_chunks
    say(f"  13a: {n_chunks} chunks; distances byte-equal to the unchunked "
        f"run; peak device memory {t_chunk['peak_device_bytes']} B vs "
        f"{t_full['peak_device_bytes']} B "
        f"({t_chunk['peak_device_bytes'] / t_full['peak_device_bytes']:.4f}"
        "x)")
    say("    per chunk (preparation d3_lanes, kernel) ms: " + ", ".join(
        f"({p:.3f}, {kn:.3f})" for p, kn in t_chunk["launch_ms"]))
    checked = verify_sample(wall, d_chunk, WALL_K, 1000)
    say(f"  13a: selfcheck OK ({checked} samples) of the chunked run")
    out["memory_wall"] = {"unchunked": t_full, "chunked": t_chunk}
    del wall, d_full, d_chunk

    say("  13b: checkpoint and resume, phase 5's points, R=4, k=8")
    bounds = slab_bounds(len(pts_np), 4)
    flat, ids, _counts, _npad = pad_and_flatten(
        [pts_np[b:e] for b, e in bounds], [b for b, _ in bounds], 3)
    want = (WORK / "k8_r4.float").read_bytes()
    resumed = {}
    for name, kw, cut in (
            ("ring_knn_stepwise", {}, {"max_rounds": 1}),
            ("ring_knn_chunked", {"chunk_rows": CKPT_CHUNK},
             {"max_chunks": 2})):
        fn = ring_knn_stepwise if name.endswith("stepwise") \
            else ring_knn_chunked
        with tempfile.TemporaryDirectory(dir=WORK) as cdir:
            _, t_cut = counted_call(lambda: fn(flat, ids, 8, 4,
                                               checkpoint_dir=cdir,
                                               **kw, **cut))
            if not (Path(cdir) / "ring_state.npz").exists():
                fail(f"13b: {name} {cut} left no checkpoint")
            d, t_res = counted_call(lambda: fn(flat, ids, 8, 4,
                                               checkpoint_dir=cdir, **kw))
            if any(Path(cdir).iterdir()):
                fail(f"13b: {name} did not clear its checkpoint")
        if d.cpu().numpy().tobytes() != want:
            fail(f"13b: {name} resumed differs from phase 5's file")
        for part, t in (("cut", t_cut), ("resumed", t_res)):
            check_d3_route(f"13b {name} {part}", t)
            runs[f"13b {name} {part}"] = t
        resumed[name] = {"cut": t_cut, "resumed": t_res}
        say(f"  13b: {name} {cut} then resumed: {t_cut['run_seconds']:.3f} "
            f"+ {t_res['run_seconds']:.3f} s, {t_cut['knn_tiled_launches']} "
            f"+ {t_res['knn_tiled_launches']} launches; byte-equal to "
            "phase 5's file, checkpoint cleared")
    label = (f"13b pre-partitioned CLI --query-chunk {CKPT_CHUNK} "
             "--checkpoint-dir")
    t, joined = prepartitioned_run(
        label, parts_list, WORK / "parts" / "chunk_k8", 8, "auto", 4,
        extra=["--query-chunk", str(CKPT_CHUNK), "--checkpoint-dir",
               str(WORK / "ckpt_pre")])
    if joined != auto8:
        fail("13b: chunked pre-partitioned rank files differ from phase 8's")
    say(f"    rounds_per_chunk {t['rounds_per_chunk']}; rank files "
        "byte-equal to phase 8's")
    runs[label] = t
    resumed["prepartitioned_cli"] = t
    out["checkpoint"] = resumed

    say(f"  13c: the device merge, {HD_SUB} uniform points, R=4, k=8, "
        f"chunks of {MERGE_CHUNK} rows (single query buckets of "
        f"{4 * MERGE_CHUNK} rows)")
    uni = seeded_points("uniform", HD_SUB, SEED + 9)
    merged = {}
    for name, engine, merge in (("host auto", "auto", "host"),
                                ("device auto", "auto", "device"),
                                ("device pallas", "pallas", "device")):
        label = f"13c merge={merge} --engine {engine}"
        t, d, idx = unordered_run(label, uni, 8, 4, "f32", engine=engine,
                                  query_chunk=MERGE_CHUNK, merge=merge)
        check_d3_route(label, t)
        runs[label] = merged[name] = t
        if name == "host auto":
            ref_d, ref_idx = d, idx
            continue
        if d.tobytes() != ref_d.tobytes():
            fail(f"13c: {label}: distances differ from the host merge")
        q = torch.from_numpy(uni).cuda()
        t["id_rows_differing_by_ties"] = tie_rows(
            torch.from_numpy(idx).cuda(), torch.from_numpy(ref_idx).cuda(),
            q, q)
        del q
        say(f"  {label}: distances byte-equal to the host merge; ids of "
            f"{t['id_rows_differing_by_ties']} rows differ only among "
            "equally distant points")
    del uni
    say(f"  13c: D={HD_DIM}, k={HD_K} on phase 10b's points, chunks of "
        f"{CKPT_CHUNK} rows, R=1")
    for sd in ("f32", "bf16"):
        label = f"13c {sd} D={HD_DIM} query_chunk={CKPT_CHUNK}"
        t, d, _ = unordered_run(label, sub, HD_K, 1, sd, neighbors=False,
                                query_chunk=CKPT_CHUNK)
        if sd == "f32":
            check_ring_route(label, t)
        elif t["knn_tiled_wgmma_launches"] != t["knn_tiled_mxu_launches"] \
                or t["knn_tiled_mxu_launches"] < 1:
            fail(f"13c: {label}: {t['knn_tiled_wgmma_launches']} of "
                 f"{t['knn_tiled_mxu_launches']} launches on the wgmma "
                 "kernel")
        if d.tobytes() != d_sub.tobytes():
            fail(f"13c: {label}: distances differ from phase 10b's "
                 "unchunked run")
        say(f"  {label}: distances byte-equal to the unchunked run")
        runs[label] = merged[f"{sd} D={HD_DIM}"] = t
    out["device_merge_and_high_d"] = merged
    return out, runs


# Phase 14b's children: each imports the same modules and loads the native
# library, then partitions the file (or not) and prints its peak RSS
RSS_CHILD = """
import json, resource, sys, time
from mpi_cuda_largescaleknn_torch.cli import partition_main
from mpi_cuda_largescaleknn_torch.io import native, partition_file
mode, src, prefix, parts = sys.argv[1:5]
loaded = native.available()
t0 = time.perf_counter()
if mode == "native":
    partition_main.main([src, "-n", parts, "-o", prefix])
elif mode == "numpy":
    partition_file.partition_float3_file_np(src, int(parts), prefix)
print(json.dumps({"native": loaded, "seconds": time.perf_counter() - t0,
                  "max_rss_kib": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss}))
"""
# A process exec'd straight from this one starts with this one's peak as
# its ru_maxrss (the peak of the memory it replaced at exec); one started
# by a small intermediate process starts from that process's peak
VIA = ("import subprocess, sys; "
       "sys.exit(subprocess.run(sys.argv[1:]).returncode)")


def rss_children(src, prefix):
    """Phase 14b's three children (baseline, native, numpy) on ``src``,
    started together, each through a small intermediate process; returns
    {mode: its JSON line (``native``, ``seconds``, ``max_rss_kib``)} and
    the native child's partition_main lines. Waits for all three before
    it fails on any."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = {mode: subprocess.Popen(
        [sys.executable, "-c", VIA, sys.executable, "-c", RSS_CHILD, mode,
         str(src), f"{prefix}_{mode}", str(BIG_PARTS)], cwd=ROOT, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
        for mode in ("baseline", "native", "numpy")}
    done = {}
    try:
        for mode, proc in procs.items():
            done[mode] = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        for proc in procs.values():
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        fail("14b: a partition child ran past 600 s")
    out, lines = {}, []
    for mode, (stdout, stderr) in done.items():
        if procs[mode].returncode != 0:
            fail(f"14b: the {mode} child exited {procs[mode].returncode}:\n"
                 f"{stdout[-2000:]}\n{stderr[-3000:]}")
        out[mode] = json.loads(stdout.strip().splitlines()[-1])
        if mode == "native":
            lines = stdout.strip().splitlines()[:-1]
    return out, lines


def bucket_witness(name, state, q, pc, group):
    """The D=3 traversal kernel on the whole query side ``q`` (one launch
    at the main path's shape) against its plain version on the first and
    the last ``PLAIN_BUCKETS`` query buckets, cold and without
    ``skip_self``: d2 and ids bitwise, visits at most the plain count (a
    bucket's rows split over blocks). Returns (the max abs difference of
    the finite d2 entries, the launch's milliseconds by CUDA events: the
    wrapper's call, which builds the visit schedule, and within it the
    point layout ``d3_lanes`` and the kernel)."""
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda,
        knn_update_tiled_plain,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import BucketedPoints

    before = route_counts()
    events = knn_update_tiled_cuda.layout_events = []
    call_ms, (got, got_vis) = cuda_ms(lambda: knn_update_tiled_cuda(
        state, q, pc, skip_self=False, self_group=group, with_stats=True))
    knn_update_tiled_cuda.layout_events = None
    (a, b, c), = events
    ms = {"call": call_ms, "d3_lanes": a.elapsed_time(b),
          "kernel": b.elapsed_time(c)}
    say(f"  {name}: wrapper {ms['call']:.3f} ms (schedule included), "
        f"d3_lanes {ms['d3_lanes']:.3f} ms, kernel {ms['kernel']:.3f} ms")
    ran = {key: n - before[key] for key, n in route_counts().items()}
    if ran != {key: int(key == "d3") for key in ran}:
        fail(f"14d: {name}: launches {ran}, not one on the D=3 kernel")
    nb, s = q.ids.shape
    errs = []
    for b0 in (0, nb - PLAIN_BUCKETS):
        sl = slice(b0, b0 + PLAIN_BUCKETS)
        rows = slice(b0 * s, (b0 + PLAIN_BUCKETS) * s)
        want, want_vis = knn_update_tiled_plain(
            CandidateState(state.dist2[rows], state.idx[rows]),
            BucketedPoints(q.pts[sl], q.ids[sl], q.lower[sl], q.upper[sl],
                           q.pos[sl]),
            pc, skip_self=False, self_group=group, with_stats=True)
        g_d2, g_idx = got.dist2[rows], got.idx[rows]
        ok = (torch.equal(g_d2, want.dist2) and torch.equal(g_idx, want.idx)
              and bool((got_vis[sl] <= want_vis).all()))
        errs.append(max_abs_err(g_d2, want.dist2))
        say(f"  {name}: buckets {b0}..{b0 + PLAIN_BUCKETS - 1} of {nb} "
            f"(rows {rows.start}..{rows.stop - 1}): visits "
            f"{int(got_vis[sl].sum())} (plain {int(want_vis.sum())}, rows "
            f"split) max_abs_err={errs[-1]} "
            f"{'bit-equal' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"14d: {name}: the kernel disagrees with its plain version")
    return max(errs), ms


def engine_run(label, pts_np, k, shards, engine, score_dtype="f32"):
    """``UnorderedKNN`` in this process with ``engine``, every count set to
    0 just before the run and read just after. The XLA engines launch no
    kernel of this package (they are PyTorch ops), ``auto`` must launch
    its traversal kernel. Returns (timings, distances f32[N])."""
    import numpy as np

    from mpi_cuda_largescaleknn_torch.core.config import KnnConfig
    from mpi_cuda_largescaleknn_torch.models.unordered import UnorderedKNN

    model = UnorderedKNN(KnnConfig(k=k, num_shards=shards, engine=engine,
                                   score_dtype=score_dtype))
    d, t = counted_call(lambda: model.run(pts_np))
    t.update(model.timers.report())
    t.update(model.last_stats or {})
    if d.shape != (len(pts_np),) or not np.all(np.isfinite(d)) \
            or np.any(d <= 0):
        fail(f"{label}: output has shape {d.shape} or non-finite/zero "
             "values")
    check_engine_launches(label, engine, t)
    say(f"  {label}: run {t['run_seconds']:.3f} s, "
        f"{len(pts_np) / t['run_seconds']:.0f} queries/s, "
        + engine_work(t))
    return t, d


def check_engine_launches(label, engine, t) -> None:
    kernels = t["knn_tiled_launches"] + t["knn_bf_launches"]
    if engine in XLA_ENGINES and kernels:
        fail(f"{label}: the XLA engine '{engine}' launched {kernels} "
             "kernels of this package")
    if engine == "auto" and t["knn_tiled_launches"] < 1:
        fail(f"{label}: auto launched no traversal kernel")
    if engine == "tiled" and t["tiled_folds"] < 1 or \
            engine == "tree" and t["tree_folds"] < 1:
        fail(f"{label}: the '{engine}' engine folded nothing")


def engine_work(t) -> str:
    """The work counters of a run: launches, the twin's tiles and chunk
    merges, the tree's lockstep steps per fold."""
    txt = (f"knn_tiled launches {t['knn_tiled_launches']}, knn_bf launches "
           f"{t['knn_bf_launches']}")
    if "pair_evals" in t:      # the ring's stats (the demand ring has none)
        txt += f", pair_evals {t['pair_evals']}, tiles {t['tiles']}"
    if t["tiled_folds"]:
        txt += f", twin folds {t['tiled_folds']}"
    if t["tree_folds"]:
        txt += (f", tree folds {t['tree_folds']} at "
                f"{t['tree_steps'] / t['tree_folds']:.1f} lockstep steps "
                "each")
    return txt


def engine_phases(pts_path, sub):
    """Phase 15: the JAX package's XLA engines on the card, each output
    byte-equal to ``auto``'s on the same points (in f32 the k-th distances
    do not depend on the engine or the visit schedule; bf16 survivors are
    rescored exactly). 15a ``tiled`` through the unordered CLI on phase 4's
    file (phase 4/5's outputs) and in process on the first ``N_ENGINE_HD``
    of phase 10b's points at D=128, f32 and bf16; 15b ``bruteforce`` on
    ``N_ENGINE`` uniform points, and in bf16 on the same D=128 points;
    15c ``tree`` on the uniform points; 15d the pre-partitioned CLI on
    them in 4 Morton parts; 15e ``canonical_ties`` on every traversal
    route against its plain version. Returns (details, the runs whose
    launches count)."""
    import numpy as np

    steps, runs, out = {}, {}, {}
    say("[phase 15a] engine 'tiled' (the traversal's twin) at the headline "
        "size")
    for k, shards, ref in ((8, 1, "k8"), (100, 1, "k100"), (8, 4, "k8_r4")):
        label = f"tiled k={k} R={shards}"
        dst = WORK / f"tiled_{ref}.float"
        with timed_step(steps, label):
            t, _ = cli_in_process([str(pts_path), "-o", str(dst), "-k",
                                   str(k), "--shards", str(shards),
                                   "--engine", "tiled"], "unordered_main")
        check_engine_launches(label, "tiled", t)
        if dst.read_bytes() != (WORK / f"{ref}.float").read_bytes():
            fail(f"phase 15a: {label} differs from the auto file {ref}")
        say(f"  {label}: run {t['run_seconds']:.3f} s (the CLI's main "
            f"{t['process_seconds']:.1f} s), byte-equal to auto; "
            + engine_work(t))
        say("    stages: " + ", ".join(
            f"{name} {v['seconds']:.4f} s" for name, v in t.items()
            if isinstance(v, dict) and "seconds" in v))
        runs[label] = t
    hd = sub[:N_ENGINE_HD]
    label = f"auto f32 k={HD_K} R=1 D={HD_DIM} on {N_ENGINE_HD}"
    with timed_step(steps, label):
        t, hd_ref = engine_run(label, hd, HD_K, 1, "auto")
    runs[label] = t
    hd_auto_s = t["run_seconds"]
    for sd in ("f32", "bf16"):
        label = f"tiled {sd} k={HD_K} R=1 D={HD_DIM}"
        with timed_step(steps, label):
            t, d = engine_run(label, hd, HD_K, 1, "tiled", sd)
        runs[label] = t
        if d.tobytes() != hd_ref.tobytes():
            fail(f"phase 15a: {label} differs from auto f32")
        say(f"    {t['run_seconds'] / hd_auto_s:.1f}x auto's run time, "
            "byte-equal")

    say(f"[phase 15b] engine 'bruteforce': {N_ENGINE} uniform points, "
        f"k=8; 15a's {N_ENGINE_HD} points at D={HD_DIM} in bf16")
    pts = seeded_points("uniform", N_ENGINE, SEED + 15)
    refs, auto_s = {}, {}
    for shards in (1, 4):
        label = f"auto k=8 R={shards} on {N_ENGINE}"
        with timed_step(steps, label):
            t, refs[shards] = engine_run(label, pts, 8, shards, "auto")
        runs[label] = t
        auto_s[shards] = t["run_seconds"]
    for shards in (1, 4):
        label = f"bruteforce k=8 R={shards}"
        with timed_step(steps, label):
            t, d = engine_run(label, pts, 8, shards, "bruteforce")
        runs[label] = t
        if d.tobytes() != refs[shards].tobytes():
            fail(f"phase 15b: {label} differs from auto")
        say(f"    {t['run_seconds'] / auto_s[shards]:.1f}x auto's run "
            "time, byte-equal")
    label = f"bruteforce bf16 k={HD_K} R=1 D={HD_DIM}"
    with timed_step(steps, label):
        t, d = engine_run(label, hd, HD_K, 1, "bruteforce", "bf16")
    runs[label] = t
    if d.tobytes() != hd_ref.tobytes():
        fail(f"phase 15b: {label} differs from auto f32")
    say("    byte-equal to auto f32")

    say(f"[phase 15c] engine 'tree': {N_ENGINE} uniform points, k=8")
    for shards in (1, 4):
        label = f"tree k=8 R={shards}"
        with timed_step(steps, label):
            t, d = engine_run(label, pts, 8, shards, "tree")
        runs[label] = t
        if d.tobytes() != refs[shards].tobytes():
            fail(f"phase 15c: {label} differs from auto")
        say(f"    {t['run_seconds'] / auto_s[shards]:.1f}x auto's run "
            "time, byte-equal")

    say(f"[phase 15d] the pre-partitioned CLI on {N_ENGINE} points in 4 "
        "Morton parts, k=8")
    src = WORK / "engines.float3"
    pts.tofile(src)
    parts = WORK / "parts"
    parts.mkdir(exist_ok=True)
    from io import StringIO

    from mpi_cuda_largescaleknn_torch.cli import partition_main

    with timed_step(steps, "partition_main"), redirect_stdout(StringIO()):
        if partition_main.main([str(src), "-n", "4", "-o",
                                str(parts / "e4")]) != 0:
            fail("phase 15d: partition_main failed")
    lst = parts / "e4.txt"
    joined = {}
    for engine in ("auto",) + XLA_ENGINES:
        label = f"pre-partitioned --engine {engine}"
        prefix = parts / f"e4_{engine}"
        with timed_step(steps, label):
            t, _ = cli_in_process([str(lst), "-o", str(prefix), "-k", "8",
                                   "--engine", engine], "prepartitioned_main")
        check_engine_launches(label, engine, t)
        joined[engine] = b"".join(
            Path(f"{prefix}_{r:06d}.float").read_bytes() for r in range(4))
        if joined[engine] != joined["auto"]:
            fail(f"phase 15d: {label} rank files differ from auto")
        say(f"  {label}: run {t['run_seconds']:.3f} s (the CLI's main "
            f"{t['process_seconds']:.1f} s), rounds {t['rounds']}, "
            f"kernels_run {t['kernels_run']}, rotations_run "
            f"{t['rotations_run']}; " + engine_work(t))
        runs[label] = t
    d = np.frombuffer(joined["auto"], dtype=np.float32)
    if d.shape != (N_ENGINE,) or not np.all(np.isfinite(d)):
        fail("phase 15d: the rank files hold no finite distance per point")
    say("  rank files of every engine byte-equal to auto's")

    say("[phase 15e] canonical_ties on every traversal route vs plain on "
        "the card")
    grid = grid_points(32_000, SEED + 7)
    x128 = clustered_nd(32_000, HD_DIM, SEED + 10 + HD_DIM)
    canon = dict(canonical=True)
    with timed_step(steps, "canonical cases"):
        errs = [compare_case(f"canonical integer grid k={k} (ties)", grid, k,
                             route="d3", **canon) for k in (8, 100)]
        errs += [
            compare_case("canonical D=128 k=10 f32", x128, 10, route="ring",
                         **canon),
            compare_case("canonical D=128 k=10 bf16", x128, 10,
                         score_dtype="bf16", route="wgmma", **canon)]
    out["phase15e_max_abs_err"] = max(errs)
    say("  phase 15 steps: " + ", ".join(f"{name} {sec:.1f} s"
                                         for name, sec in steps.items()))
    out["step_seconds"] = steps
    out["runs"] = runs
    return out, runs


def out_of_core_phases(smi):
    """Phase 14: the native out-of-core IO feeding a job the card can run
    only in chunks, all from one raw ``.float3`` file of ``N_BIG`` seeded
    uniform points (14a the read, 14b the partition out of core, 14c both
    pipelines at k=``BIG_K`` in chunks of ``BIG_CHUNK`` rows, 14d the plain
    witness at the new shape). Returns (details, the CLI runs whose
    launches count)."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.io import native
    from mpi_cuda_largescaleknn_torch.io.reader import read_file_portion

    out, runs, steps = {}, {}, {}
    big = WORK / "big"
    big.mkdir(parents=True, exist_ok=True)
    src = big / "pts.float3"
    file_bytes = N_BIG * 12

    say(f"  14a: {N_BIG} seeded uniform points, one {file_bytes}-byte "
        ".float3 file written in slabs")
    with timed_step(steps, "data"):
        rng = np.random.default_rng(SEED + 11)
        with open(src, "wb") as f:
            for lo in range(0, N_BIG, BIG_CHUNK):
                rng.random((min(BIG_CHUNK, N_BIG - lo), 3),
                           dtype=np.float32).tofile(f)
    with timed_step(steps, "native build"):
        if not native.available():
            fail("14a: no g++ here: the native IO library cannot be built")
    lib = native.build_native()
    with timed_step(steps, "native read"):
        got, _, total = read_file_portion(str(src), 0, 1)
    with timed_step(steps, "numpy read"):
        want = np.fromfile(src, dtype=np.float32).reshape(-1, 3)
    if total != N_BIG or got.tobytes() != want.tobytes():
        fail("14a: the native read differs from np.fromfile")
    del got, want
    out["read"] = {"native_seconds": steps["native read"],
                   "numpy_seconds": steps["numpy read"],
                   "library": lib.name}
    say(f"  14a: {lib.name} built or loaded in {steps['native build']:.2f} "
        f"s; read_file_portion (native, 8 threads) "
        f"{steps['native read']:.3f} s, np.fromfile "
        f"{steps['numpy read']:.3f} s, equal bytes ({smi})")

    say(f"  14b: partition_main -n {BIG_PARTS} out of core, each child's "
        "peak RSS")
    with timed_step(steps, "partition children"):
        kids, lines = rss_children(src, big / "p")
    say("  " + " ".join(line.split(" ->")[0] for line in lines
                        if line.startswith("#")))
    if not all(kid["native"] for kid in kids.values()):
        fail("14b: a child could not load the native IO library")
    for r in range(BIG_PARTS):
        if Path(f"{big / 'p_native'}_{r:06d}.float3").read_bytes() != \
                Path(f"{big / 'p_numpy'}_{r:06d}.float3").read_bytes():
            fail(f"14b: part {r} differs between the native and numpy paths")
    base = kids["baseline"]["max_rss_kib"] * 1024
    above = {m: kids[m]["max_rss_kib"] * 1024 - base
             for m in ("native", "numpy")}
    out["partition"] = {**kids, "rss_above_baseline": above,
                        "file_bytes": file_bytes}
    say(f"  14b: peak RSS (ru_maxrss) baseline {base / 2**20:.1f} MiB; "
        f"native {above['native'] / 2**20:+.1f} MiB in "
        f"{kids['native']['seconds']:.2f} s; numpy "
        f"{above['numpy'] / 2**20:+.1f} MiB in "
        f"{kids['numpy']['seconds']:.2f} s (the three children together); "
        f"parts byte-equal ({smi})")
    if above["native"] >= file_bytes / 4:
        fail(f"14b: the native partition took {above['native']} B above the "
             f"baseline, not under a quarter of the {file_bytes}-byte file")
    # the numpy child's parts are no longer needed
    for r in range(BIG_PARTS):
        Path(f"{big / 'p_numpy'}_{r:06d}.float3").unlink()

    say(f"  14c: both pipelines at k={BIG_K}, chunks of {BIG_CHUNK} query "
        "rows")
    torch.cuda.empty_cache()    # the children need the card's memory
    lst = big / "p_native.txt"
    label = (f"14c pre-partitioned CLI, {BIG_PARTS} parts, --query-chunk "
             f"{BIG_PART_CHUNK} (a shard)")
    with timed_step(steps, "pre-partitioned CLI"):
        runs[label], pre_bytes = prepartitioned_run(
            label, lst, big / "pre", BIG_K, "auto", BIG_PARTS,
            selfcheck=BIG_SELFCHECK,
            extra=["--query-chunk", str(BIG_PART_CHUNK)])
    say(f"    rounds_per_chunk {runs[label]['rounds_per_chunk']}")
    joined = big / "joined.float3"
    with timed_step(steps, "joined file"):
        with open(joined, "wb") as f:
            for name in lst.read_text().split():
                with open(name, "rb") as part:
                    shutil.copyfileobj(part, f, 1 << 24)
    label = f"14c unordered CLI on the joined parts, --query-chunk {BIG_CHUNK}"
    with timed_step(steps, "unordered CLI"):
        t, _ = run_cli([str(joined), "-o", str(big / "joined.float"), "-k",
                        str(BIG_K), "--query-chunk", str(BIG_CHUNK)])
    report_run(label, t, "knn_tiled_launches", selfcheck=False)
    check_d3_route(label, t)
    runs[label] = t
    d = np.fromfile(big / "joined.float", dtype=np.float32)
    if d.shape != (N_BIG,) or not np.all(np.isfinite(d)) or np.any(d <= 0):
        fail(f"14c: {label}: output has shape {d.shape} or non-finite/zero "
             "values")
    if d.tobytes() != pre_bytes:
        fail("14c: the pre-partitioned rank files differ from the unordered "
             "CLI on the joined parts")
    del d, pre_bytes
    out["runs"] = runs
    say(f"  14c: rank files == unordered CLI on the joined parts, byte for "
        f"byte; peak device memory "
        + " / ".join(f"{r['peak_device_bytes']} B" for r in runs.values())
        + f" ({smi})")

    say(f"  14d: the D=3 kernel on one chunk of {BIG_CHUNK} rows against the "
        f"whole {N_BIG}-point side, k={BIG_K}, vs plain")
    with timed_step(steps, "witness"):
        pts, _, _ = read_file_portion(str(joined), 0, 1)
        fns, resident, group, _last, chunk = chunk_sides(pts, 1, BIG_K,
                                                         BIG_CHUNK)
        del pts
        _lo, _hi, qp, qi = chunk(0)
        q, cold = fns.query_init_fn(qp[0], qi[0])
        del qp, qi
        out["witness_max_abs_err"], out["witness_ms"] = bucket_witness(
            f"chunk 0 ({q.num_buckets} buckets of {q.bucket_size}) vs the "
            f"side G{group} ({resident[0].num_buckets} buckets of "
            f"{resident[0].bucket_size}) k={BIG_K} cold", cold, q,
            resident[0], group)
        del fns, resident, chunk, q, cold
        torch.cuda.empty_cache()
    out["step_seconds"] = steps
    say("  phase 14 steps: " + ", ".join(f"{name} {sec:.1f} s"
                                         for name, sec in steps.items()))
    return out, runs


def served_batch(rng, n, draw, radius_range):
    """A served batch of ``n`` rows (the last tenth pad rows at
    ``PAD_SENTINEL``) and its per-row init radii: a third +inf, the rest
    finite seeds drawn from ``radius_range`` (some above a row's k-th
    distance, some below it: underfull rows)."""
    import numpy as np

    from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL

    q = draw(rng, n)
    r = rng.uniform(*radius_range, n).astype(np.float32)
    r[::3] = np.inf
    pads = n // 10
    if pads:
        q[-pads:] = PAD_SENTINEL
        r[-pads:] = np.inf
    return q, r


def query_side(q_np, r_np, s_q, sort):
    """The engine's query side of one padded batch on the card
    (``serve.engine.batch_buckets``): ``s_q``-row buckets of the rows
    (Morton-sorted over the unit box at D=3); returns it and the per-row
    radii in its row order, on the card."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.serve.engine import batch_buckets
    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    if sort:
        perm = morton_argsort(q_np, np.zeros(3), np.ones(3))
        q_np, r_np = q_np[perm], r_np[perm]
    q = torch.from_numpy(np.ascontiguousarray(q_np)).cuda()
    return (batch_buckets(q, len(q_np) // s_q),
            torch.from_numpy(np.ascontiguousarray(r_np)).cuda())


def served_shape_cases(wall, hd):
    """Phase 3f: the traversal kernels at the shapes the serving engine
    gives them, with the point side resident (``prepare_points``) and
    ``canonical_ties``, per-row init radii mixing +inf, finite seeds and
    pad rows. D=3: served batches of 1024 rows cut into query buckets of
    8, 16 and 128 rows (``resolve_query_buckets`` at k=8, 16 and 100), in
    a sub-cube of side 1/4, against 8,388,608 points at T=256 in one
    shard and in each of 4, each against the plain traversal, bit for bit
    (visits equal: a bucket is one block); and a batch of 12 rows over the
    whole cube at k=100 in one bucket of 16 rows (what 16a serves a
    narrow request), whose walk visits most buckets, against the plain
    traversal of the same rows each in a bucket of its own (the same bits
    under canonical ties, a short walk a row), in one shard and in each
    of 4.
    D=128: one query bucket of 8, 64 and 1024 rows against 1M points, f32
    on the ring kernel and bf16 on ``wgmma``, against the plain flat fold
    (``knn_update_bruteforce``, the exact k nearest by the same d2 bits:
    the plain traversal's eager walk of 3,907 buckets would take minutes),
    d2 bitwise (bf16: equal to f32), ids equal where no exact tie
    (``tie_rows``). Each launch on its planned route. Returns the max abs
    error over the cases by route."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.models.sharding import slab_bounds
    from mpi_cuda_largescaleknn_torch.ops.brute_force import (
        knn_update_bruteforce,
    )
    from mpi_cuda_largescaleknn_torch.ops.candidates import (
        init_candidates,
        sort_rows_canonical,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda,
        knn_update_tiled_plain,
        prepare_points,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
    from mpi_cuda_largescaleknn_torch.parallel.ring import (
        resolve_query_buckets,
    )
    from mpi_cuda_largescaleknn_torch.serve.engine import batch_buckets

    errs = {"d3": [], "ring": [], "wgmma": []}
    rng = np.random.default_rng(SEED + 30)

    def uniform(g, n):
        # a batch in a sub-cube of side 1/4: the plain traversal then walks
        # hundreds of steps, not the 32,768 of a bucket whose box spans the
        # cube (the kernels' long walks are phases 3-6's)
        return (0.375 + 0.25 * g.random((n, 3), dtype=np.float32)).astype(
            np.float32)

    def whole_cube(name, q, r, side, prep, k):
        # the kernel's walk of one bucket spanning the cube against the
        # plain walk of each row alone: canonical ties make the rows the
        # same bits under any bucketing
        state = init_candidates(len(r), k, r)
        before = route_counts()
        got, vis = knn_update_tiled_cuda(state, q, side, with_stats=True,
                                         canonical_ties=True, prepared=prep)
        torch.cuda.synchronize()
        ran = {rt: c - before[rt] for rt, c in route_counts().items()}
        if ran["d3"] != 1 or sum(ran.values()) != 1:
            fail(f"3f {name}: launches by route {ran}, not one on d3")
        rows = q.pts.reshape(-1, 3)
        want = knn_update_tiled_plain(state, batch_buckets(rows, len(rows)),
                                      side, canonical_ties=True)
        if not (torch.equal(got.dist2, want.dist2)
                and torch.equal(got.idx, want.idx)):
            fail(f"3f {name}: differs from the plain traversal in "
                 f"{int((got.dist2 != want.dist2).any(1).sum())} rows' d2, "
                 f"{int((got.idx != want.idx).any(1).sum())} rows' ids")
        if int(vis.max()) > side.num_buckets:
            fail(f"3f {name}: {int(vis.max())} visits of "
                 f"{side.num_buckets} buckets")
        say(f"  served {name}: one bucket of {len(r)} rows over the whole "
            f"cube, d3, visits {int(vis.sum())} of {side.num_buckets} "
            "buckets: d2 and ids bit-equal to the plain traversal of each "
            "row alone")
        return max_abs_err(got.dist2, want.dist2)

    wall_t = torch.from_numpy(wall).cuda()
    ids_t = torch.arange(len(wall), dtype=torch.int32).cuda()
    batches = {k: served_batch(rng, SERVE_MAX_BATCH, uniform, (0.004, 0.02))
               for k in (8, 16, 100)}
    # a request of 12 rows over the whole cube, padded to its shape bucket
    # of 16 rows: one query bucket at k=100, as the engine cuts it
    narrow_k, narrow_qpad = 100, 16
    narrow_qb = resolve_query_buckets(0, narrow_qpad, narrow_k)
    q_np, r_np = served_batch(
        rng, narrow_qpad,
        lambda g, n: g.random((n, 3), dtype=np.float32), (0.01, 0.03))
    q_np[12:] = q_np[-1]
    r_np[12:] = np.inf
    narrow = query_side(q_np, r_np, narrow_qpad // narrow_qb, sort=True)
    for shards in (1, 4):
        sides = [partition_points(wall_t[b:e], ids_t[b:e], bucket_size=256)
                 for b, e in slab_bounds(len(wall), shards)]
        preps = [prepare_points(side) for side in sides]
        for k, s_q in ((8, 8), (16, 16), (100, 128)):
            q_np, r_np = batches[k]
            qb, r = query_side(q_np, r_np, s_q, sort=True)
            for s, (side, prep) in enumerate(zip(sides, preps)):
                state = init_candidates(SERVE_MAX_BATCH, k, r)
                errs["d3"].append(check_traversal(
                    f"served D=3 k={k} buckets of {s_q} rows, shard {s} of "
                    f"{shards}", state, qb, side, wall_t, skip_self=False,
                    group=1, route="d3", canonical=True, prepared=prep))
        for s, (side, prep) in enumerate(zip(sides, preps)):
            errs["d3"].append(whole_cube(
                f"D=3 k={narrow_k} 12 rows, shard {s} of {shards}",
                *narrow, side, prep, narrow_k))
        del sides, preps
    del wall_t, ids_t

    hd_t = torch.from_numpy(hd).cuda()
    hd_ids = torch.arange(len(hd), dtype=torch.int32).cuda()
    side = partition_points(hd_t, hd_ids, bucket_size=256)

    def near_index(g, n):
        rows = g.integers(0, len(hd), n)
        return hd[rows] + g.normal(0.0, 0.1, (n, HD_DIM)).astype(np.float32)

    cases = {n: served_batch(rng, n, near_index, (10.0, 16.0))
             for n in (8, 64, 1024)}
    # the exact rows of all three batches in one plain flat fold
    q_all = np.concatenate([cases[n][0] for n in cases])
    r_all = np.concatenate([cases[n][1] for n in cases])
    ref = knn_update_bruteforce(
        init_candidates(len(q_all), HD_K, torch.from_numpy(r_all).cuda()),
        torch.from_numpy(q_all).cuda(), hd_t, hd_ids, query_tile=len(q_all),
        point_tile=16_384)
    ref = sort_rows_canonical(ref.dist2, ref.idx)
    for score_dtype, route in (("f32", "ring"), ("bf16", "wgmma")):
        prep = prepare_points(side, score_dtype)
        lo = 0
        for n, (q_np, r_np) in cases.items():
            qb, r = query_side(q_np, r_np, n, sort=False)
            state = init_candidates(n, HD_K, r)
            before = route_counts()
            got, vis = knn_update_tiled_cuda(
                state, qb, side, with_stats=True, canonical_ties=True,
                score_dtype=score_dtype, prepared=prep)
            torch.cuda.synchronize()
            ran = {rt: c - before[rt] for rt, c in route_counts().items()}
            if ran[route] != 1 or sum(ran.values()) != 1:
                fail(f"3f D={HD_DIM} {score_dtype} {n} rows: launches by "
                     f"route {ran}, not one on {route}")
            # the flat fold's pad rows adopt its pad lanes (d2 0, id -1), the
            # traversal leaves them at their init: real rows only
            real = qb.ids.view(n) >= 0
            want_d2 = ref[0][lo:lo + n][real]
            want_idx = ref[1][lo:lo + n][real]
            lo += n
            pad_rows = got.dist2[~real]
            if not bool(torch.isinf(pad_rows).all()) or \
                    not bool((got.idx[~real] == -1).all()):
                fail(f"3f D={HD_DIM} {score_dtype} {n} rows: a pad row "
                     "adopted a point")
            got = type(got)(got.dist2[real], got.idx[real])
            if not torch.equal(got.dist2, want_d2):
                fail(f"3f D={HD_DIM} {score_dtype} {n} rows: d2 differ from "
                     "the plain fold in "
                     f"{int((got.dist2 != want_d2).any(1).sum())} rows")
            ties = tie_rows(got.idx, want_idx, qb.pts.view(n, HD_DIM)[real],
                            hd_t)
            errs[route].append(max_abs_err(got.dist2, want_d2))
            say(f"  served D={HD_DIM} {score_dtype} k={HD_K}: one bucket of "
                f"{n} rows x {side.num_buckets} buckets of "
                f"{side.bucket_size}, {route}, visits {int(vis.sum())}: d2 "
                f"bit-equal to the plain fold; ids of {ties} rows differ only "
                "among equally distant points")
        del prep
    return {route: max(v) for route, v in errs.items()}


def knn_post(port, q, binary, timeout=300):
    """One POST /knn of the rows ``q`` (JSON with neighbors, or binary):
    (status, body bytes, seconds on the host's clock)."""
    return tier_post(port, "/knn", q, binary, timeout=timeout)[:3]


def decode_knn(body, binary, n, k):
    """(dists f32[n], ids i32[n, k] or None) of a /knn response body."""
    import numpy as np

    if binary:
        return np.frombuffer(body, "<f4").copy(), None
    obj = json.loads(body)
    return (np.asarray(obj["dists"], np.float32),
            np.asarray(obj["neighbors"], np.int32).reshape(n, k))


def closed_loop(port, draw, seconds, k, seed):
    """``SERVE_CLIENTS`` client threads post batches of 1-1024 rows (sizes
    log-uniform, drawn from ``seed``) back to back for ``seconds``; one
    client in four sends binary; one batch in eight repeats or perturbs
    one of the client's earlier batches (the query cache's hits and
    seeds). A 429 waits 10 ms and counts. Returns every answered batch
    ``(queries, dists, ids or None)``, the latencies and the counts."""
    import threading

    import numpy as np

    deadline = time.perf_counter() + seconds
    out = [None] * SERVE_CLIENTS

    def client(i):
        rng = np.random.default_rng(seed + i)
        binary = i % 4 == 3
        sent, recs, lats, rejected = [], [], [], 0
        try:
            while time.perf_counter() < deadline:
                if sent and rng.random() < 1 / 8:
                    q = sent[int(rng.integers(len(sent)))]
                    if rng.random() < 0.5:
                        q = q + rng.normal(0.0, 1e-4, q.shape).astype(
                            np.float32)
                else:
                    q = draw(rng, int(SERVE_MAX_BATCH ** rng.uniform(0, 1)))
                status, body, sec = knn_post(port, q, binary)
                if status == 429:
                    rejected += 1
                    time.sleep(0.01)
                    continue
                if status != 200:
                    raise RuntimeError(f"HTTP {status}: {body[:300]!r}")
                d, idx = decode_knn(body, binary, len(q), k)
                sent = (sent + [q])[-32:]
                recs.append((q, d, idx))
                lats.append(sec)
            out[i] = (recs, lats, rejected, None)
        except Exception as e:  # noqa: BLE001 - reported after the join
            out[i] = (recs, lats, rejected, e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("phase 16: a client did not finish")
    for o in out:
        if o[3] is not None:
            fail(f"phase 16: a client failed: {o[3]}")
    recs = [r for o in out for r in o[0]]
    lats = np.array([x for o in out for x in o[1]])
    return {"records": recs, "latencies": lats, "wall": wall,
            "rejected": sum(o[2] for o in out)}


def exact_reference(ref, q_np, k):
    """The exact answer for the rows ``q_np`` over the whole index by a
    plain version on the card: at D=3 the plain traversal with canonical
    ties over one partition of the index (``ref`` a BucketedPoints, queries
    in buckets of 8), else the plain flat fold (``ref`` = (points, ids)).
    Returns (dists f32[n], ids i32[n, k]) as torch tensors on the card."""
    import torch

    from mpi_cuda_largescaleknn_torch.ops.brute_force import (
        knn_update_bruteforce,
    )
    from mpi_cuda_largescaleknn_torch.ops.candidates import (
        extract_final_result,
        init_candidates,
        sort_rows_canonical,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_plain,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        partition_points,
        scatter_back,
    )

    q = torch.from_numpy(q_np).cuda()
    n = len(q_np)
    if q_np.shape[1] == 3:
        qb = partition_points(q, bucket_size=8)
        st = knn_update_tiled_plain(init_candidates(qb.ids.numel(), k,
                                                    device=q.device),
                                    qb, ref, canonical_ties=True)
        d = scatter_back(extract_final_result(st).view(qb.ids.shape),
                         qb.pos, n)
        idx = scatter_back(st.idx.view(*qb.ids.shape, k), qb.pos, n)
        return d, idx
    st = knn_update_bruteforce(init_candidates(n, k, device=q.device), q,
                               *ref, query_tile=n, point_tile=16_384)
    d2, idx = sort_rows_canonical(st.dist2, st.idx)
    return extract_final_result(type(st)(d2, idx)), idx


def check_served_rows(label, traffic, ref, k, points_t, seed):
    """Check 1: ``SERVE_SAMPLE`` served rows drawn from ``seed``: their
    distances byte-equal to the exact answer, their ids (JSON answers)
    equal wherever the row has no tie at the k-th distance
    (``tie_rows``). Returns (rows checked, id rows checked, id rows
    differing only among ties)."""
    import numpy as np
    import torch

    q = np.concatenate([r[0] for r in traffic["records"]])
    d = np.concatenate([r[1] for r in traffic["records"]])
    has = np.concatenate([np.full(len(r[0]), r[2] is not None)
                          for r in traffic["records"]])
    idx = np.concatenate([r[2] if r[2] is not None
                          else np.full((len(r[0]), k), -2, np.int32)
                          for r in traffic["records"]])
    pick = np.random.default_rng(seed).choice(
        len(q), min(SERVE_SAMPLE, len(q)), replace=False)
    want_d, want_idx = exact_reference(ref, np.ascontiguousarray(q[pick]), k)
    want_d = want_d.cpu().numpy()
    bad = int(np.count_nonzero(d[pick].view(np.int32)
                               != want_d.view(np.int32)))
    if bad:
        fail(f"{label}: {bad} of {len(pick)} sampled served distances "
             "differ from the exact answer")
    sel = has[pick]
    ties = tie_rows(torch.from_numpy(idx[pick][sel]).cuda(),
                    want_idx[torch.from_numpy(sel).cuda()],
                    torch.from_numpy(q[pick][sel]).cuda(), points_t)
    return len(pick), int(sel.sum()), ties


def fixed_requests(draw, seed, count):
    """Check 2's request list: ``count`` requests (at least 6) of 1-1024
    rows, every fourth binary; the last three repeat one earlier batch,
    send another again as binary and perturb a third."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = [min(n, SERVE_MAX_BATCH) for n in (1, 1024, 9, 100, 513, 8, 16,
                                               129, 1000, 64, 7, 128)]
    sizes = (sizes + [int(SERVE_MAX_BATCH ** rng.uniform(0, 1))
                      for _ in range(count)])[:count - 3]
    reqs = [(draw(rng, n), i % 4 == 3) for i, n in enumerate(sizes)]
    reqs += [reqs[1], (reqs[2][0], True),
             (reqs[0][0] + rng.normal(0.0, 1e-4, reqs[0][0].shape)
              .astype(np.float32), False)]
    return reqs


def replay(port, reqs):
    """The fixed list posted one request at a time: the response bodies."""
    bodies = []
    for q, binary in reqs:
        status, body, _ = knn_post(port, q, binary)
        if status != 200:
            fail(f"16: fixed request of {len(q)} rows: HTTP {status}")
        bodies.append(body)
    return bodies


def same_answers(label, reqs, want, got, k, points_t, ties_ok):
    """Two replays of the fixed list: byte-equal bodies, and nothing else
    unless ``ties_ok`` (``query_buckets`` 1 against auto): then byte-equal
    distances and ids that differ only among equally distant points (the
    kernel keeps strict-< adoption, so at an exact k-th distance tie
    across query buckets the kept ids follow the visit order). Returns
    (bodies byte-equal, rows whose ids differ by ties)."""
    import torch

    equal, ties = 0, 0
    for (q, binary), a, b in zip(reqs, want, got):
        if a == b:
            equal += 1
            continue
        if not ties_ok:
            fail(f"{label}: the response bodies differ on a fixed request "
                 f"of {len(q)} rows")
        da, ia = decode_knn(a, binary, len(q), k)
        db, ib = decode_knn(b, binary, len(q), k)
        if da.tobytes() != db.tobytes():
            fail(f"{label}: distances differ on a fixed request of "
                 f"{len(q)} rows")
        ties += tie_rows(torch.from_numpy(ib).cuda(),
                         torch.from_numpy(ia).cuda(),
                         torch.from_numpy(q).cuda(), points_t)
    return equal, ties


def batch_kernel_times(engine, draw, seed, reps=3):
    """The per-batch costs at each shape bucket, a full bucket of rows
    through ``engine.dispatch`` / ``complete``, ``reps`` times (the
    median): the traversal kernel's CUDA-event time summed over the
    shards' launches, its query-side layout, the pairs it scored (tile
    rows x lanes) and its bounds on them; the host's time in ``dispatch``
    (Morton sort, padding, pinned staging, the enqueue) and over the whole
    batch; the visit schedule's box distances and sort
    (``nearest_first_order`` against every shard) and, over R > 1 shards,
    the device merge (``device_merge_final``) on the card and the host
    merge (``_merge_shard_candidates``), each on rows of the batch's
    shape."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import (
        knn_update_tiled_cuda as kt,
    )
    from mpi_cuda_largescaleknn_torch.ops.partition import (
        nearest_first_order,
    )
    from mpi_cuda_largescaleknn_torch.parallel.ring import device_merge_final
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        _merge_shard_candidates,
        batch_buckets,
    )

    rng = np.random.default_rng(seed)
    mxu = engine.score_mode == "mxu"
    attr = "mxu_events" if mxu else "layout_events"
    t_p = engine._buckets[0].ids.shape[1]
    dim, k, shards = engine.dim, engine.k, engine.num_shards
    out = {}
    for qpad in engine.shape_buckets:
        runs = []
        for _ in range(reps):
            q = draw(rng, qpad)
            setattr(kt, attr, [])
            tiles0 = engine.timers.counter("tiles_executed")
            t0 = time.perf_counter()
            handle = engine.dispatch(q)
            t1 = time.perf_counter()
            engine.complete(handle)
            t2 = time.perf_counter()
            events = getattr(kt, attr)
            setattr(kt, attr, None)
            tile_rows = engine.timers.counter("tiles_executed") - tiles0
            runs.append((sum(m[1].elapsed_time(m[2]) for m in events),
                         sum(m[0].elapsed_time(m[1]) for m in events),
                         tile_rows * t_p, len(events), (t1 - t0) * 1e3,
                         (t2 - t0) * 1e3))
        ms, prep_ms, pairs, launches, dispatch_ms, batch_ms = \
            sorted(runs)[reps // 2]
        qside = batch_buckets(torch.from_numpy(q).cuda(),
                              engine.query_buckets[qpad])
        cuda_ms(lambda: nearest_first_order(
            qside.lower, qside.upper, engine._buckets[0].lower,
            engine._buckets[0].upper))
        schedule_ms, _ = cuda_ms(lambda: [nearest_first_order(
            qside.lower, qside.upper, b.lower, b.upper)
            for b in engine._buckets])
        merge = {}
        if shards > 1:
            states = [CandidateState(
                torch.sort(torch.rand(qpad, k).cuda(), dim=1).values,
                torch.randint(0, 1 << 24, (qpad, k),
                              dtype=torch.int32).cuda())
                for _ in range(shards)]
            cuda_ms(lambda: device_merge_final(states))
            merge["device_merge_ms"], _ = cuda_ms(
                lambda: device_merge_final(states))
            d2 = torch.cat([st.dist2 for st in states]).cpu().numpy()
            ids = torch.cat([st.idx for st in states]).cpu().numpy()
            t0 = time.perf_counter()
            _merge_shard_candidates(d2, ids, shards, qpad, k)
            merge["host_merge_ms"] = (time.perf_counter() - t0) * 1e3
        if mxu:
            dp = -(-dim // 16) * 16
            tc, epi = pairs * 3 * 2 * dp, pairs * 4
            op_s = (max(tc / PEAK_BF16, epi / PEAK_F32),
                    max(tc / PEAK_BF16, epi / PEAK_F32_ISSUE))
            lane_bytes = 4 * dim + 4
        else:
            ops = pairs * (OPS_PER_PAIR if dim == 3 else 3 * dim + 1)
            op_s = (ops / PEAK_F32, ops / PEAK_F32_ISSUE)
            lane_bytes = 16 if dim == 3 else 4 * dim
        # bytes: the queries and their rows read and written once, and the
        # lanes of the buckets visited (a bucket visit reads its T lanes)
        s_q = qpad // engine.query_buckets[qpad]
        nbytes = (qpad * 4 * dim + 2 * qpad * k * 8
                  + pairs // max(s_q, 1) * lane_bytes)
        out[qpad] = {"ms": ms, "query_layout_ms": prep_ms, "pairs": pairs,
                     "launches": launches, "dispatch_host_ms": dispatch_ms,
                     "batch_ms": batch_ms, "schedule_ms": schedule_ms,
                     **merge, **bounds(max(ms, 1e-9), *op_s, nbytes)}
    return out


def serve_config(label, engine_kw, points, draw, seconds, k, ref, points_t,
                 seed, variants, smi, fixed=SERVE_FIXED, kernel_reps=3):
    """One served configuration (16a / 16b): the engine built and warmed,
    the server on 127.0.0.1:0 (pipeline depth 2, the query cache on,
    ``max_batch`` 1024), ``closed_loop`` traffic with every count set to 0
    just before it and read just after, then checks 1-5 and the timings.
    ``variants`` names check 2's other servers: "depth1", "nocache",
    "qb1" (query_buckets=1), "host" (merge on the host); ``smi`` is the
    card's name and power limit, printed beside the numbers. Returns (the
    configuration's record, its launch counts)."""
    import threading

    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.server import build_server

    def start(engine, **kw):
        srv = build_server(engine, port=0,
                           max_queue_rows=SERVE_CLIENTS * SERVE_MAX_BATCH,
                           **kw)
        srv.ready = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    steps = {}
    torch.cuda.reset_peak_memory_stats()
    with timed_step(steps, "build"):
        engine = ResidentKnnEngine(points, k, max_batch=SERVE_MAX_BATCH,
                                   **engine_kw)
    with timed_step(steps, "warmup"):
        warm = engine.warmup()
    compiles = engine.compile_count
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import prepare_points

    point_side_ms, _ = cuda_ms(lambda: prepare_points(engine._buckets[0],
                                                      engine.score_dtype))
    srv = start(engine)
    port = srv.server_address[1]
    kt_key = ("knn_tiled_mxu_launches" if engine.score_mode == "mxu"
              else "knn_tiled_launches")
    stats0 = engine.stats()
    b0 = srv.batcher.stats()
    torch.cuda.synchronize()
    reset_counts()
    with timed_step(steps, "traffic"):
        traffic = closed_loop(port, draw, seconds, k, seed)
    torch.cuda.synchronize()
    counts = launch_counts()
    b1 = srv.batcher.stats()
    stats1 = engine.stats()
    batches = b1["batches"] - b0["batches"]
    rows = b1["rows_served"] - b0["rows_served"]
    served = sum(len(r[0]) for r in traffic["records"])
    lats = traffic["latencies"]
    server_lat = json.loads(knn_get(port, "/stats"))["server"][
        "request_latency"]
    rec = {
        "engine": dict(engine_kw, k=k, max_batch=SERVE_MAX_BATCH),
        "warmup_seconds": warm["per_bucket_s"],
        "query_buckets": warm["query_buckets"],
        "requests": len(lats), "rows": served,
        "rejected_429": traffic["rejected"],
        "seconds": traffic["wall"],
        "queries_per_second": served / traffic["wall"],
        "requests_per_second": len(lats) / traffic["wall"],
        "p50_ms": float(np.percentile(lats, 50)) * 1e3,
        "p99_ms": float(np.percentile(lats, 99)) * 1e3,
        "server_request_latency": server_lat,
        "batches": batches, "mean_batch_rows": rows / max(batches, 1),
        "tiles_executed": stats1["tiles_executed"]
        - stats0["tiles_executed"],
        "tiles_skipped": stats1["tiles_skipped"] - stats0["tiles_skipped"],
        "qcache": srv.qcache.stats(),
        "launches": counts,
    }
    # check 5: one traversal launch a shard for every dispatched batch
    if counts[kt_key] != batches * engine.num_shards:
        fail(f"{label}: {counts[kt_key]} traversal launches for "
             f"{batches} batches over {engine.num_shards} shards")
    route_key = {"d3": "knn_tiled_d3_launches",
                 "ring": "knn_tiled_ring_launches",
                 "wgmma": "knn_tiled_wgmma_launches"}
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import prepared_kind

    want_route = route_key[prepared_kind(engine.dim, engine.score_dtype)]
    if counts[want_route] != counts[kt_key] or counts["knn_bf_launches"]:
        fail(f"{label}: launches off the planned route: {counts}")
    # check 1: sampled rows against the exact answer
    with timed_step(steps, "check 1"):
        checked, id_rows, ties = check_served_rows(
            label, traffic, ref, k, points_t, seed + 100)
    rec["check1"] = {"rows": checked, "id_rows": id_rows,
                     "id_rows_differing_by_ties": ties}
    # check 2: the fixed request list through every variant
    reqs = fixed_requests(draw, seed + 200, fixed)
    with timed_step(steps, "check 2"):
        want = replay(port, reqs)
        rec["check2"] = {}
        for name in variants:
            if name in ("depth1", "nocache"):
                other = start(engine, **({"pipeline_depth": 1}
                                         if name == "depth1"
                                         else {"qcache_rows": 0}))
                eng2 = None
            else:
                eng2 = ResidentKnnEngine(
                    points, k, max_batch=SERVE_MAX_BATCH,
                    **dict(engine_kw, **({"query_buckets": 1}
                                         if name == "qb1"
                                         else {"merge": "host"})))
                eng2.warmup()
                other = start(eng2)
            try:
                got = replay(other.server_address[1], reqs)
            finally:
                other.close()
            equal, tied = same_answers(f"{label} {name}", reqs, want, got, k,
                                       points_t, ties_ok=name == "qb1")
            rec["check2"][name] = {"bodies_equal": equal,
                                   "requests": len(reqs),
                                   "id_rows_differing_by_ties": tied}
            if eng2 is not None:
                if eng2.stats()["degraded_reason"] is not None:
                    fail(f"{label} {name}: the engine degraded")
                del eng2
    # checks 3 and 4
    if engine.compile_count != compiles:
        fail(f"{label}: {engine.compile_count - compiles} launch plans "
             "built after warmup")
    st = engine.stats()
    if st["degraded_reason"] is not None or st["engine"] != "pallas_tiled":
        fail(f"{label}: engine {st['engine']}, degraded: "
             f"{st['degraded_reason']}")
    with timed_step(steps, "kernel times"):
        rec["kernel_per_batch"] = batch_kernel_times(engine, draw,
                                                     seed + 300, kernel_reps)
    rec["point_side_prep_ms"] = point_side_ms
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["device_bytes"] = st["device_bytes"]
    rec["step_seconds"] = steps
    srv.close()
    del engine
    torch.cuda.empty_cache()
    say(f"  {label}: {rec['queries_per_second']:.0f} queries/s, "
        f"{rec['requests_per_second']:.1f} requests/s over "
        f"{rec['seconds']:.1f} s ({rec['requests']} requests, {served} "
        f"rows, {rec['rejected_429']} refused 429); client latency p50 "
        f"{rec['p50_ms']:.2f} ms p99 {rec['p99_ms']:.2f} ms; server "
        f"p50 {1e3 * (server_lat['p50'] or 0):.2f} ms p99 "
        f"{1e3 * (server_lat['p99'] or 0):.2f} ms; mean batch "
        f"{rec['mean_batch_rows']:.1f} rows over {batches} batches; tiles "
        f"executed/skipped {rec['tiles_executed']}/{rec['tiles_skipped']}; "
        f"qcache hits {rec['qcache']['hits']} seeds {rec['qcache']['seeds']}"
        f"; peak device memory {rec['peak_device_bytes'] / 2**20:.1f} MiB "
        f"({smi})")
    say(f"    check 1: {checked} sampled rows byte-equal to the exact "
        f"answer, ids of {id_rows} rows equal up to {ties} rows of exact "
        "ties; check 2: " + ", ".join(
            f"{n} {v['bodies_equal']}/{v['requests']} bodies byte-equal "
            f"({v['id_rows_differing_by_ties']} rows differ by ties)"
            for n, v in rec["check2"].items())
        + f"; checks 3-5: {compiles} plans, no degradation, "
        f"{counts[kt_key]} launches = {batches} batches x "
        f"{st['num_shards']} shards")
    say(f"    the resident point side, laid out once at build: "
        f"{rec['point_side_prep_ms']:.3f} ms a shard (what every launch "
        "would pay without it)")
    for qpad, r in rec["kernel_per_batch"].items():
        merge = ("" if "device_merge_ms" not in r else
                 f", device merge {r['device_merge_ms']:.3f} ms, host merge "
                 f"{r['host_merge_ms']:.3f} ms")
        say(f"    a batch of {qpad}: kernel {r['ms']:.3f} ms over "
            f"{r['launches']} launches (query-side layout "
            f"{r['query_layout_ms']:.3f} ms), {r['pairs']} pairs, "
            f"{bound_txt(r)}; schedule {r['schedule_ms']:.3f} ms{merge}; "
            f"host in dispatch {r['dispatch_host_ms']:.3f} ms, the batch "
            f"{r['batch_ms']:.3f} ms")
    say("    steps: " + ", ".join(f"{name} {sec:.1f} s"
                                   for name, sec in steps.items()))
    return rec, counts


def knn_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.read()


def serving_phases(smi, pts_path, k8_path, hd):
    """Phases 3f and 16: the serving core on the card. 3f
    (``served_shape_cases``) holds the kernels at the served shapes; 16a
    serves phase 13's 8,388,608 uniform points at k=100 over 1 shard and
    at k=8 over 4 (merged on the card; check 2 also on the host); 16b
    phase 10's 1M points at D=128, k=10, f32 and bf16; 16c runs
    ``cli/serve_main.main`` in this process on phase 4's file at k=8 and
    answers one JSON and one binary request, held against phase 4's k=8
    output. Returns (details, the served runs' launch counts)."""
    import queue
    import threading

    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts
    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points

    details, runs = {}, {}
    t0 = time.perf_counter()
    wall = seeded_points("uniform", N_WALL, SEED + 8)
    say("[phase 3f] the traversal kernels at the served shapes vs plain on "
        "the card, the point side resident")
    details["phase3f_max_abs_err"] = served_shape_cases(wall, hd)
    details["phase3f_seconds"] = time.perf_counter() - t0

    say(f"[phase 16a] serving {N_WALL} uniform points on the card")
    wall_t = torch.from_numpy(wall).cuda()
    ref3 = partition_points(wall_t, bucket_size=256)
    uniform = lambda g, n: g.random((n, 3), dtype=np.float32)  # noqa: E731
    for label, k, shards, variants in (
            ("k=100 R=1", WALL_K, 1, ("depth1", "nocache", "qb1")),
            ("k=8 R=4", 8, 4, ("depth1", "nocache", "qb1", "host"))):
        rec, counts = serve_config(
            f"16a {label}", {"num_shards": shards}, wall, uniform,
            SERVE_SECONDS, k, ref3, wall_t, SEED + 40 + k, variants, smi)
        details[f"16a {label}"] = rec
        runs[f"16a {label}"] = counts
    del ref3, wall_t, wall
    torch.cuda.empty_cache()

    say(f"[phase 16b] serving {len(hd)} points at D={HD_DIM} on the card")
    hd_t = torch.from_numpy(hd).cuda()
    ref_hd = (hd_t, torch.arange(len(hd), dtype=torch.int32).cuda())

    def near_index(g, n):
        rows = g.integers(0, len(hd), n)
        return hd[rows] + g.normal(0.0, 0.1, (n, HD_DIM)).astype(np.float32)

    for sd in ("f32", "bf16"):
        label = f"D={HD_DIM} k={HD_K} {sd}"
        rec, counts = serve_config(
            f"16b {label}", {"score_dtype": sd}, hd, near_index,
            SERVE_SECONDS_HD, HD_K, ref_hd, hd_t, SEED + 60 + len(sd),
            ("depth1", "nocache"), smi, fixed=SERVE_FIXED_HD,
            kernel_reps=1)
        details[f"16b {label}"] = rec
        runs[f"16b {label}"] = counts
    del hd_t, ref_hd
    torch.cuda.empty_cache()

    say("[phase 16c] the serving CLI in this process on phase 4's file, k=8")
    from mpi_cuda_largescaleknn_torch.cli import serve_main

    ready = queue.Queue()
    rc = []
    t1 = time.perf_counter()
    reset_counts()
    th = threading.Thread(target=lambda: rc.append(serve_main.main(
        [str(pts_path), "-k", "8", "--port", "0"], ready=ready.put)),
        daemon=True)
    th.start()
    try:
        srv = ready.get(timeout=600)
    except queue.Empty:
        fail("16c: the serving CLI did not become ready")
    try:
        port = srv.server_address[1]
        pts = np.fromfile(pts_path, np.float32).reshape(-1, 3)
        want = np.fromfile(k8_path, np.float32)
        rows = np.random.default_rng(SEED + 80).choice(len(pts), 200,
                                                       replace=False)
        answers = []
        for binary, sel in ((False, rows[:100]), (True, rows[100:])):
            status, body, sec = knn_post(port, pts[sel], binary)
            if status != 200:
                fail(f"16c: HTTP {status}")
            d, idx = decode_knn(body, binary, len(sel), 8)
            # a query on an index point: its k-th distance is the
            # self-join's (itself at distance 0 the first neighbor)
            if d.tobytes() != want[sel].tobytes():
                fail("16c: served distances differ from phase 4's k=8 "
                     "self-join")
            if idx is not None and not (idx[:, 0] == sel).all():
                fail("16c: a query's first neighbor is not its own point")
            answers.append(sec)
        st = srv.engine.stats()
    finally:
        srv.shutdown()
    th.join(timeout=120)
    if th.is_alive() or rc != [0]:
        fail(f"16c: the serving CLI did not stop cleanly ({rc})")
    runs["16c serve_main"] = launch_counts()
    details["16c"] = {"seconds": time.perf_counter() - t1,
                      "request_seconds": answers,
                      "engine": st["engine"],
                      "compile_count": st["compile_count"]}
    say(f"  16c: serve_main on {len(pts)} points ({st['engine']}, "
        f"{st['compile_count']} plans): a JSON and a binary request of 100 "
        f"rows each ({answers[0] * 1e3:.1f} / {answers[1] * 1e3:.1f} ms), "
        "distances byte-equal to phase 4's k=8 output; stopped in "
        f"{time.perf_counter() - t1:.1f} s all told")
    details["seconds"] = time.perf_counter() - t0
    say(f"  phases 3f and 16 took {details['seconds']:.1f} s")
    return details, runs



def slab_shape_cases(pts_sorted):
    """Phase 3g: the D=3 traversal kernel at the slab engines' shapes,
    against its plain version on the card, bit for bit (d2 and ids). The
    point side is the one a slab engine keeps: a ``ResidentKnnEngine`` with
    ``emit="candidates"``, global ids and ``pad_shard_rows`` at the pool's
    shape class (a slab of 1,048,576 rows, and one 1,000 rows short padded
    to it); sub-batches of 1, 37 and 1024 rows routed to that slab (a fifth
    of them outside its box: escalation rows), staged as the engine stages
    them (Morton-sorted, padded to the shape bucket, in its query buckets),
    per-row radii a third +inf and the rest seeds, k=100. Returns the max
    abs error."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        ResidentKnnEngine,
        batch_buckets,
    )
    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    rows_a_slab = N_WALL // TIER_SLABS
    rng = np.random.default_rng(SEED + 95)
    errs = []
    begin = 3 * rows_a_slab
    for label, end in (("slab 3 of 8", begin + rows_a_slab),
                       ("a slab 1,000 rows short, padded",
                        begin + rows_a_slab - 1000)):
        rows = pts_sorted[begin:end]
        eng = ResidentKnnEngine(rows, WALL_K, max_batch=SERVE_MAX_BATCH,
                                id_offset=begin, emit="candidates",
                                pad_shard_rows=rows_a_slab)
        side, prep = eng._buckets[0], eng._prepared[0]
        if side.num_buckets * side.bucket_size < rows_a_slab:
            fail(f"3g {label}: the point side holds "
                 f"{side.num_buckets * side.bucket_size} rows, not the "
                 f"class's {rows_a_slab}")
        lo, hi = rows.min(axis=0), rows.max(axis=0)
        for n in (1, 37, 1024):
            q = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
            out = rng.random(n) < 0.2
            q[out] = rng.random((int(out.sum()), 3), dtype=np.float32)
            r = rng.uniform(0.005, 0.03, n).astype(np.float32)
            r[::3] = np.inf
            qpad = eng.bucket_for(n)
            perm = (morton_argsort(q, eng._index_lo, eng._index_hi)
                    if n > 1 else np.arange(n))
            q_st = np.full((qpad, 3), PAD_SENTINEL, np.float32)
            r_st = np.full(qpad, np.inf, np.float32)
            q_st[:n], r_st[:n] = q[perm], r[perm]
            qb = batch_buckets(torch.from_numpy(q_st).cuda(),
                               eng.query_buckets[qpad])
            state = init_candidates(qpad, WALL_K,
                                    torch.from_numpy(r_st).cuda())
            errs.append(check_traversal(
                f"3g {label}: {n} rows in {qb.num_buckets} query buckets "
                f"of {qb.bucket_size}", state, qb, side, None,
                skip_self=False, group=1, route="d3", canonical=True,
                prepared=prep))
        del eng, side, prep
    torch.cuda.empty_cache()
    return max(errs)


def tier_post(port, path, q, binary, headers=None, tenant=None,
              timeout=300):
    """One POST of the rows ``q`` to ``path`` (JSON with neighbors and,
    given, the ``tenant`` field; or binary), extra ``headers``: (status,
    body, seconds, Retry-After)."""
    import urllib.error
    import urllib.request

    if binary:
        body, ctype = q.astype("<f4").tobytes(), "application/octet-stream"
    else:
        obj = {"queries": q.tolist(), "neighbors": True}
        if tenant is not None:
            obj["tenant"] = tenant
        body, ctype = json.dumps(obj).encode(), "application/json"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers=dict({"Content-Type": ctype}, **(headers or {})))
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, out, retry = resp.status, resp.read(), None
    except urllib.error.HTTPError as e:
        status, out, retry = e.code, e.read(), e.headers["Retry-After"]
    return status, out, time.perf_counter() - t0, retry


def probe_rows(pts, seed):
    """``TIER_PROBE`` fixed rows: a quarter index points (distance 0 to
    themselves), a quarter around the box's center (where all eight
    Morton octants meet), half uniform in the box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n4 = TIER_PROBE // 4
    own = pts[rng.choice(len(pts), n4, replace=False)]
    mid = (0.5 + rng.normal(0.0, 0.01, (n4, 3))).astype(np.float32)
    uni = rng.random((TIER_PROBE - 2 * n4, 3), dtype=np.float32)
    return np.ascontiguousarray(np.concatenate([own, mid, uni]))


def probe_check(label, port, path, q, want, headers=None):
    """The probe through the server (JSON with neighbors): distances and
    ids byte-equal to ``want`` (a resident engine's answer)."""
    import numpy as np

    status, body, _, _ = tier_post(port, path, q, False, headers)
    if status != 200:
        fail(f"{label}: HTTP {status}: {body[:300]!r}")
    d, idx = decode_knn(body, False, len(q), WALL_K)
    if d.tobytes() != want[0].tobytes() or not np.array_equal(idx, want[1]):
        fail(f"{label}: {int((d != want[0]).sum())} distances and "
             f"{int((idx != want[1]).any(1).sum())} rows' ids differ from "
             "the resident engine's")


def promotion_split(rows, begin):
    """One slab engine's build (a promotion's work) split on the host's
    clock, each step ending in a synchronise: the boxes on the host (the
    index box and ``slab_aabbs``, as the build takes them), the host
    padding (``pad_and_flatten``), the pinned upload, the partition and the
    kernel's layout (``prepare_points``) on the card, and the whole
    ``ResidentKnnEngine`` build; the second of two builds (the first pays
    first uses). Returns {step: seconds}."""
    import torch

    from mpi_cuda_largescaleknn_torch.models.sharding import (
        pad_and_flatten,
        slab_aabbs,
    )
    from mpi_cuda_largescaleknn_torch.ops.knn_tiled import prepare_points
    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine

    for _ in range(2):
        steps = {}
        with timed_step(steps, "boxes"):
            rows.min(axis=0), rows.max(axis=0)
            slab_aabbs(rows, [(0, len(rows))])
        with timed_step(steps, "pad"):
            flat, ids, _, _ = pad_and_flatten([rows], [begin], 3,
                                              pad_to=len(rows))
        with timed_step(steps, "upload"):
            f = torch.from_numpy(flat).pin_memory().cuda(non_blocking=True)
            i = torch.from_numpy(ids).pin_memory().cuda(non_blocking=True)
            torch.cuda.synchronize()
        with timed_step(steps, "partition"):
            side = partition_points(f, i, bucket_size=256)
            torch.cuda.synchronize()
        with timed_step(steps, "layout"):
            prepare_points(side)
            torch.cuda.synchronize()
        with timed_step(steps, "engine"):
            ResidentKnnEngine(rows, WALL_K, max_batch=SERVE_MAX_BATCH,
                              id_offset=begin, emit="candidates",
                              pad_shard_rows=len(rows))
        del f, i, side
    return steps


def tiered_serving(smi, pts_sorted, path):
    """Phase 16s: ``pts_sorted`` (N_WALL uniform points in Morton order)
    from the raw file ``path`` as ``TIER_SLABS`` slabs through a
    ``StreamingKnnEngine`` at k=100, R=1, a device budget of
    ``TIER_BUDGET_SLABS`` slabs' ``slab_device_bytes`` (one slab's, from
    ``materialize_slab_engine``), a host pool of ``TIER_HOST_SLABS`` slabs'
    bytes, prefetch depth ``TIER_PREFETCH``, the query cache off; the
    server (``build_server``) in this process and ``closed_loop`` traffic
    of a sweep (blobs of sigma ``SWEEP_SIGMA`` whose center drifts along
    the box diagonal every ``SWEEP_PERIOD`` s), every launch count set to 0
    just before and read just after. Checks: a probe before the churn and
    after it byte-equal to a ``ResidentKnnEngine`` over the same points and
    knobs; ``SERVE_SAMPLE`` served rows against the exact answer;
    promotions and evictions during the traffic; ``compile_count`` flat
    from warmup to the end; the pool's device bytes never over the budget
    but by counted overcommit; every launch on the D=3 kernel. Returns
    (record, launch counts)."""
    import threading

    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts
    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        ResidentKnnEngine,
        materialize_slab_engine,
    )
    from mpi_cuda_largescaleknn_torch.serve.server import build_server
    from mpi_cuda_largescaleknn_torch.serve.slabpool import (
        StreamingKnnEngine,
    )

    steps = {}
    probe = probe_rows(pts_sorted, SEED + 96)
    with timed_step(steps, "resident reference"):
        ref = ResidentKnnEngine(pts_sorted, WALL_K, max_batch=SERVE_MAX_BATCH)
        want = ref.query(probe)
        del ref
        torch.cuda.empty_cache()
    with timed_step(steps, "slab bytes"):
        one, _, _ = materialize_slab_engine(str(path), 0, TIER_SLABS,
                                            k=WALL_K,
                                            max_batch=SERVE_MAX_BATCH)
        slab_bytes = one.device_bytes
        del one
        torch.cuda.empty_cache()
    budget = TIER_BUDGET_SLABS * slab_bytes
    host_bytes = TIER_HOST_SLABS * (N_WALL // TIER_SLABS) * 12
    torch.cuda.reset_peak_memory_stats()
    with timed_step(steps, "build"):
        eng = StreamingKnnEngine(
            str(path), num_slabs=TIER_SLABS, k=WALL_K,
            device_slab_budget=budget, host_pool_bytes=host_bytes,
            prefetch_depth=TIER_PREFETCH, max_batch=SERVE_MAX_BATCH)
    if eng.slab_device_bytes != slab_bytes:
        fail(f"16s: a slab engine holds {eng.slab_device_bytes} bytes, "
             f"materialize_slab_engine's {slab_bytes}")
    with timed_step(steps, "warmup"):
        warm = eng.warmup()
    compiles = eng.stats()["compile_count"]
    srv = build_server(eng, port=0, qcache_rows=0,
                       max_queue_rows=SERVE_CLIENTS * SERVE_MAX_BATCH)
    srv.ready = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        probe_check("16s probe before the churn", port, "/knn", probe, want)
        t_start = time.perf_counter()

        def sweep(g, n):
            frac = ((time.perf_counter() - t_start) / SWEEP_PERIOD) % 1.0
            return np.clip(frac + g.normal(0.0, SWEEP_SIGMA, (n, 3)),
                           0.0, 1.0).astype(np.float32)

        p0 = eng.stats()["slab_pool"]
        b0 = srv.batcher.stats()
        torch.cuda.synchronize()
        reset_counts()
        with timed_step(steps, "traffic"):
            traffic = closed_loop(port, sweep, SERVE_SECONDS, WALL_K,
                                  SEED + 97)
        torch.cuda.synchronize()
        counts = launch_counts()
        b1 = srv.batcher.stats()
        p1 = eng.stats()["slab_pool"]
        probe_check("16s probe after the churn", port, "/knn", probe, want)
        st = eng.stats()
    finally:
        srv.close()
        eng.close()
    if counts["knn_tiled_launches"] < 1 or \
            counts["knn_tiled_d3_launches"] != counts["knn_tiled_launches"] \
            or counts["knn_bf_launches"]:
        fail(f"16s: launches off the D=3 traversal kernel: {counts}")
    delta = {key: p1[key] - p0[key] for key in (
        "promotions", "evictions", "cold_reads", "host_hits",
        "device_hits", "stream_stalls", "stream_stall_seconds",
        "overcommits", "prefetch_enqueued")}
    if delta["promotions"] < 1 or delta["evictions"] < 1:
        fail(f"16s: the pool did not churn: {delta}")
    if st["compile_count"] != compiles:
        fail(f"16s: {st['compile_count'] - compiles} launch plans built "
             "after warmup")
    pool = st["slab_pool"]
    if pool["device_bytes_peak"] > budget and pool["overcommits"] < 1:
        fail(f"16s: {pool['device_bytes_peak']} device bytes held, over "
             f"the budget {budget}, with no overcommit counted")
    if pool["device_bytes_used"] > budget:
        fail(f"16s: {pool['device_bytes_used']} device bytes held after "
             f"the traffic, over the budget {budget}")
    if pool["promotion_errors"] or pool["prefetch_errors"] or \
            st["degraded_reason"] is not None:
        fail(f"16s: promotion errors {pool['promotion_errors']}, prefetch "
             f"errors {pool['prefetch_errors']}, degraded "
             f"{st['degraded_reason']}: {pool['last_error']}")
    slab = N_WALL // TIER_SLABS
    split = promotion_split(pts_sorted[3 * slab:4 * slab], 3 * slab)
    with timed_step(steps, "check rows"):
        pts_t = torch.from_numpy(pts_sorted).cuda()
        ref_side = partition_points(pts_t, bucket_size=256)
        checked, id_rows, ties = check_served_rows(
            "16s", traffic, ref_side, WALL_K, pts_t, SEED + 98)
        del pts_t, ref_side
        torch.cuda.empty_cache()
    lats = traffic["latencies"]
    served = sum(len(r[0]) for r in traffic["records"])
    build = st["timers"].get("index_build", {})
    rec = {
        "slab_device_bytes": slab_bytes, "device_budget_bytes": budget,
        "host_pool_bytes": host_bytes, "warm_slabs": warm["warm_slabs"],
        "requests": len(lats), "rows": served,
        "rejected_429": traffic["rejected"],
        "seconds": traffic["wall"],
        "queries_per_second": served / traffic["wall"],
        "p50_ms": float(np.percentile(lats, 50)) * 1e3,
        "p99_ms": float(np.percentile(lats, 99)) * 1e3,
        "batches": b1["batches"] - b0["batches"],
        "pool_delta": delta,
        "stall_fraction": delta["stream_stall_seconds"] / traffic["wall"],
        "device_bytes_peak": pool["device_bytes_peak"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "promotion_build": build, "promotion_split": split,
        "streaming": st["streaming"], "compile_count": compiles,
        "check1": {"rows": checked, "id_rows": id_rows,
                   "id_rows_differing_by_ties": ties},
        "launches": counts, "step_seconds": steps,
    }
    say(f"  16s: {rec['queries_per_second']:.0f} queries/s over "
        f"{rec['seconds']:.1f} s ({rec['requests']} requests, {served} rows,"
        f" {rec['batches']} batches); p50 {rec['p50_ms']:.2f} ms p99 "
        f"{rec['p99_ms']:.2f} ms; stall fraction {rec['stall_fraction']:.4f}"
        f" ({delta['stream_stalls']} stalls, "
        f"{delta['stream_stall_seconds']:.3f} s); promotions "
        f"{delta['promotions']}, evictions {delta['evictions']}, cold reads "
        f"{delta['cold_reads']}, host hits {delta['host_hits']}, device hits"
        f" {delta['device_hits']}, overcommits {delta['overcommits']}; "
        f"escalation waves {st['streaming']['escalation_waves']}; a slab "
        f"{slab_bytes} B, budget {budget} B, the pool's high water "
        f"{pool['device_bytes_peak']} B, max_memory_allocated "
        f"{rec['max_memory_allocated']} B ({smi})")
    say(f"    slab builds (index_build): {build.get('calls', 0)} in "
        f"{build.get('seconds', 0.0):.3f} s; one build split: " + ", ".join(
            f"{name} {1e3 * sec:.1f} ms" for name, sec in split.items())
        + f"; probe of {TIER_PROBE} rows "
        "byte-equal to the resident engine before and after the churn; "
        f"{checked} sampled rows byte-equal to the exact answer, ids of "
        f"{id_rows} rows equal up to {ties} rows of exact ties; "
        f"{compiles} plans, none after warmup; "
        f"{counts['knn_tiled_d3_launches']} launches on the D=3 kernel")
    say("    steps: " + ", ".join(f"{name} {sec:.1f} s"
                                   for name, sec in steps.items()))
    return rec, counts


def tenancy_serving(smi):
    """Phase 16t: ``cli/serve_main.main`` in this process with
    ``TENANTS`` ``--tenant NAME=PATH`` flags (``TENANT_POINTS`` Morton-sorted
    uniform points each from its own seed; the last as ``.npy``),
    ``--num-slabs TENANT_SLABS``, one ``--device-slab-budget`` of
    ``TENANT_BUDGET_SLABS`` slabs and ``--tenant-quota-rows TENANT_QUOTA``,
    k=100. Checks: each tenant's probe through ``/v1/<t>/knn`` byte-equal
    to its own ``ResidentKnnEngine``; legacy ``/knn`` answering as the
    default tenant; an unknown tenant's 404 listing the tenants; a request
    over its tenant's quota a 429 with Retry-After; then zipf-skewed
    traffic (rank i gets 1/(i+1)^``TENANT_SKEW`` of the requests, each
    through the URL, the JSON field or the binary codec's header) with
    every launch count set to 0 just before and read just after, and
    ``compile_count`` flat. Returns (record, launch counts)."""
    import queue
    import threading

    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.cli import serve_main
    from mpi_cuda_largescaleknn_torch.cli.common import launch_counts
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        ResidentKnnEngine,
        materialize_slab_engine,
    )
    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    steps = {}
    names = [f"t{i}" for i in range(TENANTS)]
    paths, probes, wants = {}, {}, {}
    with timed_step(steps, "data and resident references"):
        for i, name in enumerate(names):
            pts = seeded_points("uniform", TENANT_POINTS, SEED + 110 + i)
            pts = np.ascontiguousarray(
                pts[morton_argsort(pts, pts.min(0), pts.max(0))])
            if i == TENANTS - 1:
                paths[name] = WORK / f"tenant_{name}.npy"
                np.save(paths[name], pts)
            else:
                paths[name] = WORK / f"tenant_{name}.float3"
                pts.tofile(paths[name])
            probes[name] = probe_rows(pts, SEED + 120 + i)
            ref = ResidentKnnEngine(pts, WALL_K, max_batch=SERVE_MAX_BATCH)
            wants[name] = ref.query(probes[name])
            if i == 0:
                legacy_q = np.ascontiguousarray(probes[name][::-1])
                legacy_want = ref.query(legacy_q)
            del ref
        torch.cuda.empty_cache()
        one, _, _ = materialize_slab_engine(str(paths[names[0]]), 0,
                                            TENANT_SLABS, k=WALL_K,
                                            max_batch=SERVE_MAX_BATCH)
        budget = TENANT_BUDGET_SLABS * one.device_bytes
        del one
        torch.cuda.empty_cache()
    argv = ["-k", str(WALL_K), "--port", "0", "--num-slabs",
            str(TENANT_SLABS), "--device-slab-budget", str(budget),
            "--tenant-quota-rows", str(TENANT_QUOTA)]
    for name in names:
        argv += ["--tenant", f"{name}={paths[name]}"]
    ready, rc = queue.Queue(), []
    t1 = time.perf_counter()
    th = threading.Thread(target=lambda: rc.append(serve_main.main(
        argv, ready=ready.put)), daemon=True)
    th.start()
    try:
        srv = ready.get(timeout=600)
    except queue.Empty:
        fail("16t: the serving CLI did not become ready")
    steps["start"] = time.perf_counter() - t1
    try:
        port = srv.server_address[1]
        compiles = srv.engine.stats()["compile_count"]
        for name in names:
            probe_check(f"16t {name}", port, f"/v1/{name}/knn",
                        probes[name], wants[name])
        probe_check("16t legacy /knn", port, "/knn", legacy_q, legacy_want)
        status, body, _, _ = tier_post(port, "/v1/nobody/knn",
                                       probes[names[0]][:4], False)
        if status != 404 or json.loads(body).get("tenants") != names:
            fail(f"16t: an unknown tenant got HTTP {status}: {body[:300]!r}")
        over = np.random.default_rng(SEED + 130).random(
            (TENANT_QUOTA + 88, 3), dtype=np.float32)
        status, body, _, retry = tier_post(port, f"/v1/{names[1]}/knn",
                                           over, False)
        if status != 429 or retry is None or float(retry) <= 0:
            fail(f"16t: a request of {len(over)} rows over the quota "
                 f"{TENANT_QUOTA} got HTTP {status}, Retry-After {retry}: "
                 f"{body[:300]!r}")
        w = np.array([1.0 / (i + 1) ** TENANT_SKEW for i in range(TENANTS)])
        w /= w.sum()
        deadline = time.perf_counter() + TENANT_SECONDS
        out = [None] * SERVE_CLIENTS

        def client(c):
            g = np.random.default_rng(SEED + 140 + c)
            n_req, n_rows, rejected, lats = 0, 0, 0, []
            per = dict.fromkeys(names, 0)
            try:
                while time.perf_counter() < deadline:
                    name = names[int(g.choice(TENANTS, p=w))]
                    n = int(TENANT_MAX_ROWS ** g.uniform(0, 1))
                    q = g.random((n, 3), dtype=np.float32)
                    # the URL, the binary codec's header, the JSON field
                    route = n_req % 3
                    if route == 0:
                        status, _b, sec, _r = tier_post(
                            port, f"/v1/{name}/knn", q, False)
                    elif route == 1:
                        status, _b, sec, _r = tier_post(
                            port, "/knn", q, True, {"X-Knn-Tenant": name})
                    else:
                        status, _b, sec, _r = tier_post(
                            port, "/knn", q, False, tenant=name)
                    n_req += 1
                    if status == 429:
                        rejected += 1
                        time.sleep(0.01)
                        continue
                    if status != 200:
                        raise RuntimeError(f"HTTP {status}")
                    n_rows += n
                    per[name] += 1
                    lats.append(sec)
                out[c] = (n_req, n_rows, rejected, lats, per, None)
            except Exception as e:  # noqa: BLE001 - reported after join
                out[c] = (n_req, n_rows, rejected, lats, per, e)

        torch.cuda.synchronize()
        reset_counts()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TENANT_SECONDS + 600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = launch_counts()
        if any(t.is_alive() for t in threads):
            fail("16t: a client did not finish")
        for o in out:
            if o[5] is not None:
                fail(f"16t: a client failed: {o[5]}")
        st = srv.engine.stats()
    finally:
        srv.shutdown()
    th.join(timeout=120)
    if th.is_alive() or rc != [0]:
        fail(f"16t: the serving CLI did not stop cleanly ({rc})")
    if st["compile_count"] != compiles:
        fail(f"16t: {st['compile_count'] - compiles} launch plans built "
             "after warmup")
    if counts["knn_tiled_launches"] < 1 or \
            counts["knn_tiled_d3_launches"] != counts["knn_tiled_launches"]:
        fail(f"16t: launches off the D=3 traversal kernel: {counts}")
    lats = np.array([x for o in out for x in o[3]])
    per = {name: sum(o[4][name] for o in out) for name in names}
    pool = st["slab_pool"]
    rec = {"device_budget_bytes": budget, "compile_count": compiles,
           "requests": sum(o[0] for o in out),
           "rows": sum(o[1] for o in out),
           "rejected_429": sum(o[2] for o in out),
           "answered_by_tenant": per, "seconds": wall,
           "queries_per_second": sum(o[1] for o in out) / wall,
           "p50_ms": float(np.percentile(lats, 50)) * 1e3,
           "p99_ms": float(np.percentile(lats, 99)) * 1e3,
           "pool_tenants": pool.get("tenants", {}),
           "promotions": pool["promotions"],
           "evictions": pool["evictions"],
           "stream_stall_seconds": pool["stream_stall_seconds"],
           "device_bytes_peak": pool["device_bytes_peak"],
           "launches": counts, "step_seconds": steps}
    say(f"  16t: {TENANTS} tenants of {TENANT_POINTS} points "
        f"({TENANTS * TENANT_SLABS} slabs on a budget of "
        f"{TENANT_BUDGET_SLABS}): probes byte-equal to each tenant's "
        "resident engine, legacy /knn the default tenant's, 404 for a "
        f"stranger, 429 over the quota; {rec['queries_per_second']:.0f} "
        f"queries/s over {wall:.1f} s ({rec['requests']} requests, "
        f"{rec['rejected_429']} refused 429, by tenant {per}); p50 "
        f"{rec['p50_ms']:.2f} ms p99 {rec['p99_ms']:.2f} ms; promotions "
        f"{pool['promotions']}, evictions {pool['evictions']}, stalls "
        f"{pool['stream_stall_seconds']:.3f} s; {compiles} plans, none "
        f"after warmup ({smi})")
    say("    steps: " + ", ".join(f"{name} {sec:.1f} s"
                                   for name, sec in steps.items()))
    return rec, counts


def tiered_phases(smi):
    """Phases 3g, 16s and 16t: the tiered slab index and tenancy on the
    card. N_WALL seeded uniform points (16a's) in Morton order, written to
    one raw file under ``build/``; 3g (``slab_shape_cases``) holds the
    traversal kernel at the slab engines' shapes; 16s
    (``tiered_serving``) serves the file 4x over its device budget; 16t
    (``tenancy_serving``) serves four indexes through the CLI. Returns
    (details, the served runs' launch counts)."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    details, runs = {}, {}
    t0 = time.perf_counter()
    wall = seeded_points("uniform", N_WALL, SEED + 8)
    wall = np.ascontiguousarray(
        wall[morton_argsort(wall, wall.min(0), wall.max(0))])
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "tier.float3"
    wall.tofile(path)
    details["data_seconds"] = time.perf_counter() - t0
    say("[phase 3g] the traversal kernel at the slab engines' shapes vs "
        "plain on the card")
    details["phase3g_max_abs_err"] = slab_shape_cases(wall)
    say(f"[phase 16s] the tiered slab index: {N_WALL} points in "
        f"{TIER_SLABS} slabs, {TIER_SLABS // TIER_BUDGET_SLABS}x over the "
        "device budget")
    details["16s"], runs["16s"] = tiered_serving(smi, wall, path)
    del wall
    torch.cuda.empty_cache()
    say(f"[phase 16t] tenancy through the serving CLI: {TENANTS} tenants")
    details["16t"], runs["16t"] = tenancy_serving(smi)
    details["seconds"] = time.perf_counter() - t0
    say(f"  phases 3g, 16s and 16t took {details['seconds']:.1f} s")
    return details, runs


MH_HOSTS = 4                     # 17a: processes, one ring position each
MH_CHUNK = 262_144               # 17b: --query-chunk (one chunk a shard)
MH_CHILD_SECONDS = 240           # phase 17: a child's wall-clock limit


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_hosts(label, module, args, hosts, groups):
    """``hosts`` copies of a CLI joined through ``--coordinator`` on a
    free port (``start_children``, output under ``build/smoke/multihost``)."""
    cmd = [sys.executable, "-m", f"mpi_cuda_largescaleknn_torch.cli.{module}",
           *args, "--timings", "--coordinator", f"127.0.0.1:{free_port()}",
           "--num-hosts", str(hosts)]
    return start_children(label, [cmd + ["--host-id", str(i)]
                                  for i in range(hosts)], groups,
                          "multihost")


def start_children(label, cmds, groups, logs_dir):
    """One process a command, all started at once with the port on
    ``PYTHONPATH``, their output in files under ``build/smoke/<logs_dir>``
    named by ``label``; the group is appended to ``groups`` (every group
    still running, which a failure kills)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    logs = WORK / logs_dir
    logs.mkdir(parents=True, exist_ok=True)
    tag = label.replace(" ", "_").replace("=", "").replace("-", "")
    procs, files = [], []
    for i, cmd in enumerate(cmds):
        out = open(logs / f"{tag}_{i}.out", "w+")
        err = open(logs / f"{tag}_{i}.err", "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                      stderr=err, text=True))
    group = (label, procs, files, time.perf_counter())
    groups.append(group)
    return group


def kill_groups(groups) -> None:
    """Kill every child of every group still running, and reap it."""
    for _label, procs, _files, _t0 in groups:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def finish_hosts(group, groups):
    """Waits for a group's children, each within ``MH_CHILD_SECONDS`` of
    the group's start; a child that fails or outlives it kills every child
    of ``groups`` and fails the phase. Returns each host's timings (its
    stderr's last line) and stdout."""
    label, procs, files, t0 = group
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, MH_CHILD_SECONDS
                               - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            kill_groups(groups)
            fail(f"{label}: host {i} outlived {MH_CHILD_SECONDS} s")
    wall = time.perf_counter() - t0
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    for i, (p, (out, err)) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            kill_groups(groups)
            fail(f"{label}: host {i} exited {p.returncode}:\n{out[-2000:]}\n"
                 f"{err[-3000:]}")
    groups.remove(group)
    timings = []
    for out, err in texts:
        t = json.loads(err.strip().splitlines()[-1])
        t["process_seconds"] = wall
        timings.append(t)
    return timings, [out for out, _ in texts]


def report_hosts(label, hosts, outs, smi) -> None:
    """Each host's backend, stages, exchange, the ring's GB/s and peak
    device memory, beside the card's name and power limit."""
    for i, (t, out) in enumerate(zip(hosts, outs)):
        say(f"  {label} host {i} ({smi}): {out.splitlines()[0][2:]}")
        say(f"    run {t['run_seconds']:.3f} s, process "
            f"{t['process_seconds']:.1f} s, peak device memory "
            f"{t['peak_device_bytes'] / 2**20:.1f} MiB, knn_tiled launches "
            f"{t['knn_tiled_launches']}, knn_bf launches "
            f"{t['knn_bf_launches']}; ring exchange "
            f"{t['exchange_seconds']:.4f} s, {t['exchange_bytes_sent']} B "
            "sent")
        say("    stages: " + ", ".join(
            f"{name} {v['seconds']:.4f} s"
            + (f" ({v['GB/s']} GB/s)" if "GB/s" in v else "")
            for name, v in t.items()
            if isinstance(v, dict) and "seconds" in v))
        if "exchange" in t:
            ex = t["exchange"]
            say(f"    exchange: {ex['exchange_GB_per_sec_per_link']} GB/s "
                f"a link, {ex['exchange_GB_per_sec_aggregate']} GB/s in all "
                f"(round {ex['round_seconds']} s, control "
                f"{ex['control_seconds']} s, shard {ex['shard_bytes']} B; "
                f"{ex['method']})")


def same_demand_stats(label, hosts, want) -> None:
    """Each host's rounds and its positions' kernels_run / rotations_run
    equal to the one-process run's ``want``."""
    for t in hosts:
        for key in ("kernels_run", "rotations_run"):
            got = t[key]
            exp = [want[key][s] for s in t["positions"]]
            if got != exp:
                fail(f"{label}: host {t['host']} {key} {got}, one process "
                     f"{exp}")
        if t["rounds"] != want["rounds"]:
            fail(f"{label}: host {t['host']} ran {t['rounds']} rounds, one "
                 f"process {want['rounds']}")


def nccl_group_phase(pts_np, k8_r4, parts_list, auto8, pre_k8):
    """Phase 17d: an NCCL group of world size 1 in this process on the
    card. The collectives the drivers use, on CUDA tensors (the gathered
    boxes, the need all-reduce, the device merge's exchange against
    ``device_merge_final``), then the drivers through the group path:
    ``ring_knn`` and ``ring_knn_chunked`` (device merge) at R=4 on phase
    4's points, k=8, byte-equal to phase 5's file, and ``demand_knn`` on
    phase 8's parts, byte-equal to phase 8's k=8 rank files with its
    ``kernels_run`` and ``rotations_run``. Returns the drivers' launch
    counts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mpi_cuda_largescaleknn_torch.core.types import CandidateState
    from mpi_cuda_largescaleknn_torch.io.reader import read_points
    from mpi_cuda_largescaleknn_torch.models.sharding import (
        pad_and_flatten,
        slab_bounds,
    )
    from mpi_cuda_largescaleknn_torch.parallel.demand import demand_knn
    from mpi_cuda_largescaleknn_torch.parallel.mesh import (
        Mesh,
        initialize_distributed,
    )
    from mpi_cuda_largescaleknn_torch.parallel.ring import (
        device_merge_final,
        merge_over_mesh,
        ring_knn,
        ring_knn_chunked,
    )

    dev, _backend, _ = initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    runs = {}
    try:
        mesh = Mesh(4, dev)
        if not mesh.grouped or mesh.backend != "nccl":
            fail(f"17d: a {mesh.backend} mesh, grouped={mesh.grouped}")
        boxes = torch.rand((4, 6), device=dev)
        if not torch.equal(mesh.gather_positions(boxes), boxes):
            fail("17d: the gathered boxes differ from the group's own")
        if mesh.any(True, False) != [True, False]:
            fail("17d: the need all-reduce changed the flags")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        states = [CandidateState(
            torch.randint(0, 9, (4 * 1000, 8), generator=gen,
                          device=dev).float(),
            torch.randint(0, 1 << 20, (4 * 1000, 8), generator=gen,
                          device=dev, dtype=torch.int32)) for _ in range(4)]
        d, st = merge_over_mesh(mesh, states, 1000)
        wd, wst = device_merge_final(states)
        if not (torch.equal(d, wd) and torch.equal(st.dist2, wst.dist2)
                and torch.equal(st.idx, wst.idx)):
            fail("17d: the device merge's exchange differs from "
                 "device_merge_final")
        say("  17d NCCL: the gathered boxes, the need all-reduce and the "
            "device merge's all_to_all (4 x 4,000 rows, k=8, tied "
            "distances) bit-equal to the one-process answers")
        bnds = slab_bounds(len(pts_np), 4)
        flat, ids, counts, npad = pad_and_flatten(
            [pts_np[b:e] for b, e in bnds], [b for b, _ in bnds], 3)
        want = Path(k8_r4).read_bytes()

        def joined(rows, cnts):
            return b"".join(rows[s].cpu().numpy()[:c].tobytes()
                            for s, c in enumerate(cnts))

        for name, call in (
                ("ring_knn", lambda: ring_knn(flat, ids, 8, 4, mesh=mesh)),
                ("ring_knn_chunked --merge device", lambda: ring_knn_chunked(
                    flat, ids, 8, 4, chunk_rows=MH_CHUNK, merge="device",
                    mesh=mesh))):
            rows, runs[name] = counted_call(call)
            check_d3_route(f"17d {name}", runs[name])
            if joined(rows, counts) != want:
                fail(f"17d: {name} through the NCCL group differs from "
                     "phase 5's file")
            say(f"  17d {name} R=4 through the NCCL group: byte-equal to "
                f"phase 5's file, run {runs[name]['run_seconds']:.3f} s")
        parts = [read_points(f) for f in Path(parts_list).read_text().split()]
        sizes = np.cumsum([0] + [len(p) for p in parts])
        flat, ids, counts, _ = pad_and_flatten(
            parts, [int(x) for x in sizes[:-1]], 3)
        (rows, _c, stats), t = counted_call(lambda: demand_knn(
            flat, ids, 8, 4, mesh=mesh, return_stats=True))
        runs["demand_knn"] = t
        check_d3_route("17d demand_knn", t)
        if joined(rows, counts) != auto8:
            fail("17d: demand_knn through the NCCL group differs from phase "
                 "8's rank files")
        same_demand_stats("17d demand_knn", [dict(stats, host=0,
                                                  positions=[0, 1, 2, 3])],
                          pre_k8)
        say(f"  17d demand_knn on phase 8's parts through the NCCL group: "
            f"byte-equal to phase 8's rank files, kernels_run "
            f"{stats['kernels_run']}, rotations_run {stats['rotations_run']}")
    finally:
        dist.destroy_process_group()
    return runs


def multihost_phases(smi, pts_path, k8_r4, parts_list, auto8, pre):
    """Phase 17: the ring across processes (``cli/multihost.py``), each
    child a real CLI process with ``--coordinator 127.0.0.1:<free port>
    --num-hosts P --host-id i`` on the one card (gloo, copies staged
    through pinned host memory), each with a wall-clock limit, every child
    killed when one fails. 17a: phase 13's N_WALL points as one raw file in
    input order, k=100, ``--shards 4`` in 4 processes, byte-equal to
    ``unordered_main --shards 4`` in this process, every traversal launch
    on the D=3 kernel; 17b: phase 4's file at k=8, ``--shards 4`` in 2
    processes (two positions each), ``--query-chunk 262144`` with the host
    and the device merge, and ``--engine pallas``, each byte-equal to the
    same flags in this process; 17c: ``prepartitioned_main`` in 2
    processes on phase 8's 4 parts at k=8 and k=100, byte-equal to phase
    8's rank files with its ``kernels_run`` and ``rotations_run``; 17d
    (``nccl_group_phase``). Returns (details, the runs' launch counts)."""
    import numpy as np
    import torch

    details, runs = {}, {}
    mh = WORK / "multihost"
    mh.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    groups = []
    try:
        say(f"[phase 17a] {N_WALL} points, k={WALL_K}, --shards 4 in "
            f"{MH_HOSTS} processes on one card")
        big = mh / "wall.float3"
        seeded_points("uniform", N_WALL, SEED + 8).tofile(big)
        one = mh / "wall_one.float"
        t, _ = cli_in_process([str(big), "-o", str(one), "-k", str(WALL_K),
                               "--shards", "4"], "unordered_main")
        runs["17a one process"] = t
        report_run("17a one process, --shards 4", t, "knn_tiled_launches",
                   selfcheck=False)
        check_d3_route("17a one process", t)
        torch.cuda.empty_cache()
        many = mh / "wall_many.float"
        hosts, outs = finish_hosts(start_hosts(
            "17a", "unordered_main", [str(big), "-o", str(many), "-k",
                                      str(WALL_K), "--shards", "4"],
            MH_HOSTS, groups), groups)
        report_hosts("17a", hosts, outs, smi)
        for t in hosts:
            check_d3_route(f"17a host {t['host']}", t)
            runs[f"17a host {t['host']}"] = t
        if many.read_bytes() != one.read_bytes():
            fail("17a: 4 processes wrote other bytes than one process")
        d = np.fromfile(many, np.float32)
        if d.shape != (N_WALL,) or not np.all(np.isfinite(d)):
            fail(f"17a: output of shape {d.shape}, or not finite")
        say(f"  17a: {MH_HOSTS} processes byte-equal to one process "
            f"({N_WALL} distances)")
        details["17a"] = hosts
        big.unlink()

        say("[phase 17b] phase 4's file, k=8, --shards 4 in 2 processes; "
            "[phase 17c] phase 8's parts in 2 processes")
        # label -> (the runs' file name, their flags); the groups run at
        # once, so each writes a file of its own
        jobs = {
            "17b host merge": ("host", ["--query-chunk", str(MH_CHUNK),
                                        "--merge", "host"]),
            "17b device merge": ("device", ["--query-chunk", str(MH_CHUNK),
                                            "--merge", "device"]),
            "17b --engine pallas": ("pallas", ["--engine", "pallas"]),
        }
        started = {}
        for label, (name, flags) in jobs.items():
            out = mh / f"{name}_many.float"
            started[label] = (out, start_hosts(
                label, "unordered_main",
                [str(pts_path), "-o", str(out), "-k", "8", "--shards", "4",
                 *flags], 2, groups))
        for k in (8, 100):
            started[f"17c k={k}"] = (mh / f"c_k{k}", start_hosts(
                f"17c k={k}", "prepartitioned_main",
                [str(parts_list), "-o", str(mh / f"c_k{k}"), "-k", str(k)],
                2, groups))
        # the one-process counterparts, while the children start
        singles = {}
        for label, (name, flags) in jobs.items():
            out = mh / f"{name}_one.float"
            t, _ = cli_in_process([str(pts_path), "-o", str(out), "-k", "8",
                                   "--shards", "4", *flags], "unordered_main")
            check_d3_route(f"{label} one process", t)
            runs[f"{label} one process"] = t
            singles[label] = out.read_bytes()
        for label, (out, group) in started.items():
            hosts, outs = finish_hosts(group, groups)
            report_hosts(label, hosts, outs, smi)
            for t in hosts:
                check_d3_route(f"{label} host {t['host']}", t)
                runs[f"{label} host {t['host']}"] = t
            details[label] = hosts
            if label.startswith("17b"):
                if out.read_bytes() != singles[label]:
                    fail(f"{label}: 2 processes wrote other bytes than one")
                say(f"  {label}: byte-equal to the same flags in one process")
                continue
            k = int(label.split("=")[1])
            got = b"".join(Path(f"{out}_{r:06d}.float").read_bytes()
                           for r in range(4))
            want = b"".join(Path(f"{WORK / 'parts' / f'auto_k{k}'}_"
                                 f"{r:06d}.float").read_bytes()
                            for r in range(4))
            if got != want:
                fail(f"{label}: rank files differ from phase 8's")
            same_demand_stats(label, hosts, pre[f"auto_k{k}"])
            say(f"  {label}: rank files byte-equal to phase 8's, kernels_run "
                "and rotations_run equal to its one process")

        say("[phase 17d] an NCCL group of world size 1 in this process")
        pts_np = np.fromfile(pts_path, np.float32).reshape(-1, 3)
        for name, t in nccl_group_phase(pts_np, k8_r4, parts_list, auto8,
                                        pre["auto_k8"]).items():
            runs[f"17d {name}"] = t
    finally:
        kill_groups(groups)
    details["seconds"] = time.perf_counter() - t_start
    say(f"  phase 17 took {details['seconds']:.1f} s")
    return details, runs


POD_HOSTS = 4                    # phase 18: routed hosts, a slab each
POD_DUPS = 4                     # 18a: rows copied across the slab 0/1 edge
POD_SECONDS = 4.0                # 18b: closed-loop traffic a mix
POD_CHILD_SECONDS = 300          # phase 18: a child's wall-clock limit
POD_FIXED = 12                   # 18a: requests of each mix's fixed list
HANDOFF_SECONDS = 120            # 18e: the drain, adoption and bind
REP_HOSTS = 4                    # phase 19: processes, one position each
REP_SECONDS = 4.0                # 19b: closed-loop traffic
REP_REQUEST_TIMEOUT_MS = 10_000  # 19: the front end's per-try budget


def routed_shape_cases(pts, slab, begin):
    """Phase 3h: the D=3 traversal kernel at a routed host's shapes, against
    its plain version on the card, bit for bit (d2 and ids): the point side
    of the host's engine (``ResidentKnnEngine(emit="candidates",
    id_offset=begin)``, as ``serve_main --routing bounds`` builds it, a slab
    of ``slab`` rows), sub-batches of 1, 7, 300 and 1024 rows staged as the
    engine stages them (Morton-sorted, padded to the shape bucket, in its
    query buckets; radii +inf, the routed host's), k=100; then the engine's
    ``refetch_exact`` of a subset of a batch's rows, byte-equal to those
    rows of the batch. Returns the max abs error."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL
    from mpi_cuda_largescaleknn_torch.ops.candidates import init_candidates
    from mpi_cuda_largescaleknn_torch.serve.engine import (
        ResidentKnnEngine,
        batch_buckets,
    )
    from mpi_cuda_largescaleknn_torch.utils.math import morton_argsort

    rows = pts[begin:begin + slab]
    eng = ResidentKnnEngine(rows, WALL_K, max_batch=SERVE_MAX_BATCH,
                            id_offset=begin, emit="candidates")
    side, prep = eng._buckets[0], eng._prepared[0]
    rng = np.random.default_rng(SEED + 130)
    lo, hi = rows.min(axis=0), rows.max(axis=0)
    errs = []
    for n in (1, 7, 300, 1024):
        q = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
        q[::5] = rng.random((len(q[::5]), 3), dtype=np.float32)
        qpad = eng.bucket_for(n)
        perm = (morton_argsort(q, eng._index_lo, eng._index_hi)
                if n > 1 else np.arange(n))
        q_st = np.full((qpad, 3), PAD_SENTINEL, np.float32)
        q_st[:n] = q[perm]
        qb = batch_buckets(torch.from_numpy(q_st).cuda(),
                           eng.query_buckets[qpad])
        state = init_candidates(qpad, WALL_K, device=qb.pts.device)
        errs.append(check_traversal(
            f"3h slab of {slab} rows at id_offset {begin}: {n} rows in "
            f"{qb.num_buckets} query buckets of {qb.bucket_size}", state,
            qb, side, None, skip_self=False, group=1, route="d3",
            canonical=True, prepared=prep))
    q = (lo + (hi - lo) * rng.random((300, 3))).astype(np.float32)
    d2, idx = eng.complete_candidates(eng.dispatch(q))
    sub = np.sort(rng.choice(300, 7, replace=False))
    rd2, ridx = eng.refetch_exact(q[sub])
    if rd2.tobytes() != d2[sub].tobytes() or \
            ridx.tobytes() != idx[sub].tobytes():
        fail("3h: refetch_exact of 7 rows differs from their batch's rows")
    say("  3h refetch_exact of 7 of a batch's 300 rows: byte-equal to "
        "those rows")
    del eng, side, prep
    torch.cuda.empty_cache()
    return max(errs)


def child_tail(group, i) -> str:
    out, err = group[2][i]
    texts = []
    for f in (out, err):
        f.flush()
        f.seek(0)
        texts.append(f.read()[-3000:])
    return "\n".join(texts)


def wait_serving(group, urls, groups):
    """Polls each child's /healthz until it answers 200, within
    ``POD_CHILD_SECONDS`` of the group's start; a child that exits or
    outlives it kills every child of ``groups`` and fails the phase.
    Returns the seconds each took."""
    import urllib.request

    label, procs, _files, t0 = group
    took = [None] * len(urls)
    while None in took:
        for i, (p, url) in enumerate(zip(procs, urls)):
            if took[i] is not None:
                continue
            if p.poll() is not None:
                kill_groups(groups)
                fail(f"{label} {i} exited {p.returncode}:\n"
                     f"{child_tail(group, i)}")
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as r:
                    if r.status == 200:
                        took[i] = time.perf_counter() - t0
            except OSError:
                pass
        if time.perf_counter() - t0 > POD_CHILD_SECONDS:
            kill_groups(groups)
            fail(f"{label}: not serving after {POD_CHILD_SECONDS} s")
        time.sleep(0.2)
    return took


def stop_children(groups) -> None:
    """SIGINT every child (the CLIs shut down on it), then kill what is
    left after 30 s, and reap all."""
    for _label, procs, files, _t0 in groups:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
    deadline = time.perf_counter() + 30
    for _label, procs, files, _t0 in groups:
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    groups.clear()


def get_json(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def post_json(url, obj):
    """POST ``obj`` as JSON to ``url``; the decoded answer."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def pod_launches(host_urls) -> dict:
    """Every host process's kernel launch counts (its /stats
    ``launches``), summed."""
    total = {}
    for url in host_urls:
        for key, n in get_json(url + "/stats")["launches"].items():
            total[key] = total.get(key, 0) + n
    return total


def wait_standby(group, url, groups):
    """Polls a standby's /healthz until it answers (503 with status
    ``standby``: no slab yet), within ``POD_CHILD_SECONDS`` of the group's
    start; returns the seconds it took."""
    import urllib.error
    import urllib.request

    label, procs, _files, t0 = group
    while True:
        if procs[0].poll() is not None:
            kill_groups(groups)
            fail(f"{label} exited {procs[0].returncode}:\n"
                 f"{child_tail(group, 0)}")
        try:
            urllib.request.urlopen(url + "/healthz", timeout=5)
        except urllib.error.HTTPError as e:
            if e.code == 503 and json.loads(e.read())["status"] == "standby":
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > POD_CHILD_SECONDS:
            kill_groups(groups)
            fail(f"{label}: not waiting for an adoption after "
                 f"{POD_CHILD_SECONDS} s")
        time.sleep(0.2)


def handoff_phase(smi, host_urls, sb_url, reqs, base, steps):
    """Phase 18e: one more front end (``serve.frontend.main`` in this
    process, ``--standbys sb_url --handoff-floor 1``, its monitor running)
    over the routed hosts; host 2 made to answer 503; the monitor drains
    it, its replica manager directs the standby to adopt slab 2 (from the
    file: no member of the slab is live) and binds it once its fingerprint
    matches; then, with host 2 still down, the fixed list answered as 18a
    answered it. Returns the details."""
    import queue
    import threading

    from mpi_cuda_largescaleknn_torch.serve import frontend

    lost = host_urls[2]
    ready = queue.Queue()
    rc = []
    th = threading.Thread(target=lambda: rc.append(frontend.main(
        ["--hosts", ",".join(host_urls), "--port", "0", "--qcache-rows",
         "0", "--probe-interval-s", "1", "--standbys", sb_url,
         "--handoff-floor", "1", "--wait-ready-s", "60"],
        ready=ready.put)), daemon=True)
    th.start()
    try:
        fe = ready.get(timeout=120)
    except queue.Empty:
        fail("18e: the front end with a standby did not start")
    try:
        post_json(lost + "/faults", {"spec": "error:code=503"})
        t0 = time.perf_counter()
        with timed_step(steps, "18e handoff"):
            while True:
                ho = fe.monitor.stats()["handoff"]
                if ho["handoffs"] == 1:
                    break
                if ho["handoff_failures"] or ho["handoff_rejections"] or \
                        time.perf_counter() - t0 > HANDOFF_SECONDS:
                    fail(f"18e: no handoff: {ho}")
                time.sleep(0.1)
        handoff_wall = time.perf_counter() - t0
        adopt = get_json(sb_url + "/healthz")["adopt"]
        state = fe.fanout.health_snapshot()[lost]["state"]
        if state != "drained" or ho["standbys"][0]["slab"] != 2:
            fail(f"18e: host 2 {state}, the standby adopted "
                 f"{ho['standbys'][0]}")
        with timed_step(steps, "18e list"):
            got = replay_port(fe.server_address[1], reqs)
        if [g[:2] for g in got] != [b[:2] for b in base]:
            fail("18e: with host 2 down and the standby bound, the bodies "
                 "differ from 18a's")
        metrics = knn_get(fe.server_address[1], "/metrics").decode()
        if "knn_handoffs_total 1\n" not in metrics:
            fail("18e: /metrics does not read knn_handoffs_total 1")
        members = fe.fanout.stats()["routing"]["replicas"]["per_slab"][2]
    finally:
        post_json(lost + "/faults", {"spec": ""})
        fe.shutdown()
        th.join(timeout=60)
    if th.is_alive() or rc != [0]:
        fail(f"18e: the front end did not stop cleanly ({rc})")
    say(f"  18e: host 2 answering 503, drained; the standby adopted slab 2 "
        f"from the file in {adopt['seconds']:.2f} s and was bound "
        f"{handoff_wall:.2f} s after the fault (handoff_seconds_total "
        f"{ho['handoff_seconds_total']}); with host 2 down the list of "
        f"{len(reqs)} requests byte-equal to 18a, exact true on every row; "
        f"knn_handoffs_total 1; slab 2's members {members['members']} "
        f"({smi})")
    return {"adopt_seconds": adopt["seconds"],
            "handoff_seconds_total": ho["handoff_seconds_total"],
            "fault_to_bound_seconds": handoff_wall, "handoff": ho,
            "slab2": members}


def replay_port(port, reqs):
    """The list posted one request at a time to the front end on
    ``port``: [(status, body, Retry-After)]."""
    out = []
    for q, binary in reqs:
        status, body, _sec, retry = tier_post(port, "/knn", q, binary)
        out.append((status, body, retry))
    return out


def routed_pod_phases(smi, next_groups):
    """Phases 3h and 18: the routed pod on the card. 16s's N_WALL
    Morton-sorted points (its raw file), with the ``POD_DUPS`` rows after
    the first slab edge replaced by copies of the rows before it; four
    ``serve_main --routing bounds --num-hosts 4 --host-id i`` processes on
    the one card (a slab of 2,097,152 rows each) and three front ends
    (``python -m ...serve.frontend``: ``--on-host-loss fail``, the same
    with ``--wire f32``, and ``--on-host-loss degrade``; the query cache
    off, so every request reaches the hosts), all started together, each
    with a wall-clock limit, every child killed on a failure. 18a: a fixed
    list of requests (uniform, clustered, rows ON the copies; JSON and
    binary) answered as one ``ResidentKnnEngine`` over the whole file
    answers, ids among distance-0 ties ascending, ``exact`` true; 18b:
    closed-loop clients, a sweep then uniform rows, 1,000 served rows
    against the exact answer, every launch on the D=3 kernel; 18c: the
    ``--wire f32`` front end byte-equal, and ``pull_slab_rows`` with d16,
    f32 and the single-shot body bit-equal; 18d: one host answering 503
    (``POST /faults``): bodies of requests whose certified set misses it
    byte-equal to 18a, the others 503 with Retry-After (fail) or the
    surviving slabs' exact answer flagged ``exact: false`` (degrade), then
    the fault cleared, the host back through the monitor's rejoin and the
    list byte-equal again; 18e (``handoff_phase``): a warm standby started
    with the hosts adopts slab 2 for a front end with ``--standbys`` while
    host 2 answers 503, and the list stays byte-equal to 18a. When 18b's
    traffic ends, phase 19's processes start (``start_replicate_pod``,
    into ``next_groups``, which a failure here kills too). Returns
    (details, the hosts' summed launch counts during 18b, phase 19's
    started processes)."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.frontend import (
        PodBoundsTable,
        pod_config_from_hosts,
        routing_cert_slack,
    )
    from mpi_cuda_largescaleknn_torch.serve.replica import pull_slab_rows

    details, steps = {}, {}
    t_phase = time.perf_counter()
    slab = N_WALL // POD_HOSTS
    with timed_step(steps, "data"):
        pts = np.fromfile(WORK / "tier.float3", np.float32).reshape(-1, 3)
        pts[slab:slab + POD_DUPS] = pts[slab - POD_DUPS:slab]
        path = WORK / "pod.float3"
        pts.tofile(path)
    groups = []
    host_ports = [free_port() for _ in range(POD_HOSTS)]
    host_urls = [f"http://127.0.0.1:{p}" for p in host_ports]
    fe_ports = [free_port() for _ in range(3)]
    fe_urls = [f"http://127.0.0.1:{p}" for p in fe_ports]
    sb_url = f"http://127.0.0.1:{free_port()}"
    py = sys.executable
    host_cmd = [py, "-m", "mpi_cuda_largescaleknn_torch.cli.serve_main",
                str(path), "-k", str(WALL_K), "--routing", "bounds",
                "--num-hosts", str(POD_HOSTS)]
    hosts = start_children("host", [
        host_cmd + ["--host-id", str(i), "--port", str(p)]
        for i, p in enumerate(host_ports)], groups, "pod")
    standby = start_children("standby", [
        host_cmd + ["--standby", "--port", sb_url.rsplit(":", 1)[1]]],
        groups, "pod")
    fe_cmd = [py, "-m", "mpi_cuda_largescaleknn_torch.serve.frontend",
              "--hosts", ",".join(host_urls), "--qcache-rows", "0",
              "--probe-interval-s", "1",
              "--wait-ready-s", str(POD_CHILD_SECONDS)]
    fes = start_children("frontend", [
        fe_cmd + ["--port", str(fe_ports[0])],
        fe_cmd + ["--port", str(fe_ports[1]), "--wire", "f32"],
        fe_cmd + ["--port", str(fe_ports[2]), "--on-host-loss", "degrade"]],
        groups, "pod")
    try:
        # meanwhile, in this process: phase 3h and the references
        say("[phase 3h] the traversal kernel at a routed host's shapes vs "
            "plain on the card")
        with timed_step(steps, "3h"):
            details["phase3h_max_abs_err"] = routed_shape_cases(
                pts, slab, 2 * slab)
        say(f"[phase 18] the routed pod: {POD_HOSTS} host processes of "
            f"{slab} rows and 3 front ends on the card, k={WALL_K}")
        with timed_step(steps, "references"):
            ref = ResidentKnnEngine(pts, WALL_K, max_batch=SERVE_MAX_BATCH)
            surv = ResidentKnnEngine(pts[:3 * slab], WALL_K,
                                     max_batch=SERVE_MAX_BATCH,
                                     emit="candidates")
        with timed_step(steps, "start-up"):
            took = wait_serving(hosts, host_urls, groups)
            fe_took = wait_serving(fes, fe_urls, groups)
            sb_took = wait_standby(standby, sb_url, groups)
        say(f"  hosts serving after {', '.join(f'{t:.1f}' for t in took)} s"
            f", front ends after {', '.join(f'{t:.1f}' for t in fe_took)} "
            f"s, the standby waiting after {sb_took:.1f} s (started "
            "together)")
        details["host_start_seconds"] = took
        details["frontend_start_seconds"] = fe_took
        details["standby_start_seconds"] = sb_took

        # -- 18a: the fixed list against one engine ------------------------
        rng = np.random.default_rng(SEED + 131)

        def uniform(g, n):
            return g.random((n, 3), dtype=np.float32)

        def blobs(g, n):
            c = g.random(3)
            return np.clip(c + g.normal(0.0, SWEEP_SIGMA / 2, (n, 3)), 0.0,
                           1.0).astype(np.float32)

        edge = pts[slab - POD_DUPS:slab + POD_DUPS]
        reqs = (fixed_requests(uniform, SEED + 132, POD_FIXED)
                + fixed_requests(blobs, SEED + 133, POD_FIXED)
                + [(edge.copy(), False), (edge.copy(), True),
                   (np.concatenate([edge, uniform(rng, 24)]), False),
                   (np.clip(0.2 + rng.normal(0.0, 0.02, (64, 3)), 0, 1)
                    .astype(np.float32), False)])
        with timed_step(steps, "18a"):
            base = replay_port(fe_ports[0], reqs)
            for (q, binary), (status, body, _r) in zip(reqs, base):
                if status != 200:
                    fail(f"18a: a request of {len(q)} rows: HTTP {status}: "
                         f"{body[:300]!r}")
                want_d, want_i = ref.query(q)
                if binary:
                    if body != want_d.tobytes():
                        fail(f"18a: the binary body of {len(q)} rows differs"
                             " from one engine's")
                    continue
                obj = json.loads(body)
                if obj.get("exact") is not True or \
                        np.asarray(obj["dists"], np.float32).tobytes() \
                        != want_d.tobytes() or not np.array_equal(
                            np.asarray(obj["neighbors"], np.int32), want_i):
                    fail(f"18a: the JSON body of {len(q)} rows differs from "
                         "one engine's")
            # the copies: each answers itself and its twin at distance 0,
            # ids ascending across the slab edge
            obj = json.loads(base[2 * POD_FIXED][1])
            for row, nb in zip(edge, obj["neighbors"]):
                zero = [j for j in nb if np.array_equal(pts[j], row)]
                if len(zero) < 2 or zero != sorted(zero) or \
                        not (zero[0] < slab <= zero[-1]):
                    fail(f"18a: distance-0 ids {zero} of a row on the "
                         "slab edge are not its two copies, ascending")
        say(f"  18a: {len(reqs)} requests ({sum(len(q) for q, _ in reqs)} "
            "rows; uniform, blobs, rows on the copies across the slab "
            "edge), JSON and binary bodies byte-equal to one "
            "ResidentKnnEngine over all the points, exact true, distance-0 "
            "ids ascending across hosts")

        # -- 18b: closed-loop traffic --------------------------------------
        traffic = {}
        fe0 = fe_urls[0]
        st0 = get_json(fe0 + "/stats")["fanout"]
        hs0 = [get_json(u + "/stats") for u in host_urls]
        l0 = pod_launches(host_urls)
        t_start = time.perf_counter()

        def sweep(g, n):
            frac = ((time.perf_counter() - t_start) / SWEEP_PERIOD) % 1.0
            return np.clip(frac + g.normal(0.0, SWEEP_SIGMA, (n, 3)),
                           0.0, 1.0).astype(np.float32)

        mixes = {}
        for name, draw, seed in (("sweep", sweep, SEED + 134),
                                 ("uniform", uniform, SEED + 135)):
            a = get_json(fe0 + "/stats")["fanout"]
            with timed_step(steps, f"18b {name}"):
                traffic[name] = closed_loop(fe_ports[0], draw, POD_SECONDS,
                                            WALL_K, seed)
            b = get_json(fe0 + "/stats")["fanout"]
            lats = traffic[name]["latencies"]
            rows = sum(len(r[0]) for r in traffic[name]["records"])
            batches = b["batches"] - a["batches"]
            hpq = {c: b["routing"]["hosts_per_query"].get(c, 0)
                   - a["routing"]["hosts_per_query"].get(c, 0)
                   for c in b["routing"]["hosts_per_query"]}
            wire = {c: v["bytes"] - a["wire"]["traffic"].get(
                        "candidates", {}).get(c, {}).get("bytes", 0)
                    for c, v in b["wire"]["traffic"]
                    .get("candidates", {}).items()}
            mixes[name] = {
                "requests": len(lats), "rows": rows,
                "seconds": traffic[name]["wall"],
                "queries_per_second": rows / traffic[name]["wall"],
                "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                "p99_ms": float(np.percentile(lats, 99)) * 1e3,
                "batches": batches,
                "waves_per_batch": 1 + (b["routing"]["escalation_waves"]
                                        - a["routing"]["escalation_waves"])
                / max(1, batches),
                "certified_after_one_host": hpq.get("1", 0)
                / max(1, sum(hpq.values())),
                "hosts_per_query": hpq, "wire_bytes": wire,
                "rejected_429": traffic[name]["rejected"]}
            m = mixes[name]
            say(f"  18b {name}: {m['queries_per_second']:.0f} queries/s "
                f"over "
                f"{m['seconds']:.1f} s ({m['requests']} requests, {rows} "
                f"rows, {batches} batches); p50 {m['p50_ms']:.2f} ms p99 "
                f"{m['p99_ms']:.2f} ms; {m['waves_per_batch']:.3f} waves a "
                f"batch; {m['certified_after_one_host']:.4f} of rows "
                f"certified after one host; wire bytes {wire} ({smi})")
        l1 = pod_launches(host_urls)
        hs1 = [get_json(u + "/stats") for u in host_urls]
        counts = {key: l1[key] - l0.get(key, 0) for key in l1}
        # phase 19's processes start now: their start-up overlaps 18c-18e
        started = start_replicate_pod(path, next_groups)
        per_host = [h1["server"].get("knn_requests_total", 0)
                    - h0["server"].get("knn_requests_total", 0)
                    for h0, h1 in zip(hs0, hs1)]
        say(f"  18b: sub-batches each host served {per_host}; launches in "
            f"the host processes {counts['knn_tiled_launches']}, on the D=3 "
            f"kernel {counts['knn_tiled_d3_launches']}")
        if counts["knn_tiled_launches"] < 1 or \
                counts["knn_tiled_d3_launches"] \
                != counts["knn_tiled_launches"] or counts["knn_bf_launches"]:
            fail(f"18b: launches off the D=3 traversal kernel: {counts}")
        with timed_step(steps, "check rows"):
            pts_t = torch.from_numpy(pts).cuda()
            ref_side = partition_points(pts_t, bucket_size=256)
            both = {"records": traffic["sweep"]["records"]
                    + traffic["uniform"]["records"]}
            checked, id_rows, ties = check_served_rows(
                "18b", both, ref_side, WALL_K, pts_t, SEED + 136)
            del pts_t, ref_side
            torch.cuda.empty_cache()
        say(f"  18b: {checked} sampled served rows byte-equal to the exact "
            f"answer, ids of {id_rows} rows equal up to {ties} rows of exact"
            " ties")
        details["18b"] = {"mixes": mixes, "host_sub_batches": per_host,
                          "launches": counts,
                          "check": {"rows": checked, "id_rows": id_rows,
                                    "id_rows_differing_by_ties": ties}}

        # -- 18c: the wire --------------------------------------------------
        with timed_step(steps, "18c"):
            f32 = replay_port(fe_ports[1], reqs)
            if [b for _s, b, _r in f32] != [b for _s, b, _r in base]:
                fail("18c: the --wire f32 front end's bodies differ from "
                     "the auto front end's")
            wst = get_json(fe_urls[1] + "/stats")["fanout"]["wire"]
            if set(wst["traffic"].get("candidates", {})) != {"f32"}:
                fail(f"18c: the f32 front end moved {wst['traffic']}")
            pulls = {}
            for wire in ("d16", "f32", "none"):
                t0 = time.perf_counter()
                rows, off = pull_slab_rows(host_urls[1], wire=wire)
                pulls[wire] = time.perf_counter() - t0
                if off != slab or rows.tobytes() != \
                        pts[slab:2 * slab].tobytes():
                    fail(f"18c: pull_slab_rows(wire={wire}) differs from "
                         "host 1's slab")
            slab_wire = get_json(host_urls[1] + "/stats")["wire_traffic"][
                "slab_rows"]
        d16, raw = slab_wire["d16"]["bytes"], slab * 12
        say(f"  18c: the --wire f32 front end byte-equal on all "
            f"{len(reqs)} requests; pull_slab_rows d16 / f32 / single-shot "
            f"bit-equal to host 1's {slab} rows: d16 {d16} B "
            f"({d16 / raw:.3f} of the f32 rows' {raw} B), seconds "
            + ", ".join(f"{w} {s:.2f}" for w, s in pulls.items()))
        details["18c"] = {"slab_wire": slab_wire, "pull_seconds": pulls}

        # -- 18d: failover --------------------------------------------------
        with timed_step(steps, "18d"):
            cfg = pod_config_from_hosts(host_urls)
            table = PodBoundsTable(cfg["bounds_hosts"], 3)
            slack = routing_cert_slack(3)
            flags, surv_out = [], []
            for q, _binary in reqs:
                d2, idx = surv.complete_candidates(surv.dispatch(q))
                lb = table.lower_bounds(q)[:, POD_HOSTS - 1] * (1.0 - slack)
                flags.append(np.isfinite(lb) & (
                    lb <= d2[:, WALL_K - 1].astype(np.float64)))
                surv_out.append((np.sqrt(d2[:, WALL_K - 1]), idx))
            touched = [bool(f.any()) for f in flags]
            if all(touched) or not any(touched):
                fail(f"18d: the list does not split on host "
                     f"{POD_HOSTS - 1}: {touched}")
            lost = host_urls[POD_HOSTS - 1]
            post_json(lost + "/faults", {"spec": "error:code=503"})
            got_fail = replay_port(fe_ports[0], reqs)
            got_deg = replay_port(fe_ports[2], reqs)
            for i, ((q, binary), hit) in enumerate(zip(reqs, touched)):
                if not hit:
                    for got in (got_fail[i], got_deg[i]):
                        if got[:2] != base[i][:2]:
                            fail(f"18d: a request of {len(q)} rows away "
                                 "from the lost host changed")
                    continue
                status, body, retry = got_fail[i]
                if status != 503 or retry is None:
                    fail(f"18d fail: a request touching the lost host got "
                         f"HTTP {status}, Retry-After {retry}")
                status, body, _r = got_deg[i]
                sd, si = surv_out[i]
                if status != 200:
                    fail(f"18d degrade: HTTP {status}")
                if binary:
                    if body != sd.tobytes():
                        fail("18d degrade: binary body is not the "
                             "surviving slabs' answer")
                    continue
                obj = json.loads(body)
                if obj["exact"] is not False or obj["exact_per_query"] != \
                        [not f for f in flags[i].tolist()] or \
                        np.asarray(obj["dists"], np.float32).tobytes() != \
                        sd.tobytes() or not np.array_equal(
                            np.asarray(obj["neighbors"], np.int32), si):
                    fail("18d degrade: body is not the surviving slabs' "
                         "answer with the predicted exact flags")
            drained = [get_json(u + "/stats")["pod"]["health"][lost]["state"]
                       for u in (fe_urls[0], fe_urls[2])]
            post_json(lost + "/faults", {"spec": ""})
            t_clear = time.perf_counter()
            while True:
                states = [get_json(u + "/stats")["pod"]["health"][lost]
                          ["state"] for u in (fe_urls[0], fe_urls[2])]
                if states == ["healthy", "healthy"]:
                    break
                if time.perf_counter() - t_clear > 60:
                    fail(f"18d: the host did not rejoin in 60 s: {states}")
                time.sleep(0.25)
            rejoin = time.perf_counter() - t_clear
            for port in (fe_ports[0], fe_ports[2]):
                again = replay_port(port, reqs)
                if [g[:2] for g in again] != [b[:2] for b in base]:
                    fail("18d: after the rejoin the bodies differ from 18a")
        say(f"  18d: host {POD_HOSTS - 1} answering 503: "
            f"{touched.count(False)} of {len(reqs)} requests away from it "
            f"byte-equal; {touched.count(True)} touching it 503 with "
            "Retry-After (fail) and the surviving slabs' answer flagged "
            f"exact:false as predicted (degrade); the host {drained} in the "
            f"front ends; rejoined {rejoin:.2f} s after the fault cleared, "
            "the list byte-equal again")
        details["18d"] = {"touched": touched, "rejoin_seconds": rejoin,
                          "drained_states": drained}
        fstats = get_json(fe0 + "/stats")
        with timed_step(steps, "18e"):
            details["18e"] = handoff_phase(smi, host_urls, sb_url, reqs,
                                           base, steps)
        details["frontend_stats"] = {"fanout": fstats["fanout"],
                                     "batcher": fstats["batcher"]}
    except BaseException:
        kill_groups(groups)
        kill_groups(next_groups)
        raise
    stop_children(groups)
    del ref, surv
    torch.cuda.empty_cache()
    details["step_seconds"] = steps
    details["seconds"] = time.perf_counter() - t_phase
    say("  steps: " + ", ".join(f"{name} {sec:.1f} s"
                                for name, sec in steps.items()))
    say(f"  phases 3h and 18 took {details['seconds']:.1f} s")
    return details, counts, started


def start_replicate_pod(path, groups):
    """Phase 19's processes, started together: ``REP_HOSTS`` ``serve_main
    --merge device --coordinator`` hosts on ``path`` (one gloo group on
    the one card) and their front end (``--qcache-rows 0``, a per-try
    budget of ``REP_REQUEST_TIMEOUT_MS``), into ``groups``. Returns
    (hosts' group, front end's group, host urls, front-end port)."""
    py = sys.executable
    host_ports = [free_port() for _ in range(REP_HOSTS)]
    host_urls = [f"http://127.0.0.1:{p}" for p in host_ports]
    fe_port = free_port()
    cmd = [py, "-m", "mpi_cuda_largescaleknn_torch.cli.serve_main",
           str(path), "-k", str(WALL_K), "--merge", "device",
           "--coordinator", f"127.0.0.1:{free_port()}", "--num-hosts",
           str(REP_HOSTS)]
    hosts = start_children("replicate host", [
        cmd + ["--host-id", str(i), "--port", str(p)]
        for i, p in enumerate(host_ports)], groups, "replicate")
    fe = start_children("replicate frontend", [[
        py, "-m", "mpi_cuda_largescaleknn_torch.serve.frontend", "--hosts",
        ",".join(host_urls), "--qcache-rows", "0", "--port", str(fe_port),
        "--request-timeout-ms", str(REP_REQUEST_TIMEOUT_MS),
        "--wait-ready-s", str(POD_CHILD_SECONDS)]], groups, "replicate")
    return hosts, fe, host_urls, fe_port


def replicate_pod_phases(smi, started, groups):
    """Phase 19: the replicate pod on the card (see the module's
    docstring); ``started`` and ``groups`` from ``start_replicate_pod``.
    Returns (details, the hosts' summed launch counts during 19b)."""
    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine

    hosts, fe, host_urls, fe_port = started
    fe_url = f"http://127.0.0.1:{fe_port}"
    details, steps = {}, {}
    t_phase = time.perf_counter()
    say(f"[phase 19] the replicate pod: {REP_HOSTS} processes of one "
        f"position each and a front end on the card, k={WALL_K}")
    try:
        with timed_step(steps, "reference"):
            pts = np.fromfile(WORK / "pod.float3", np.float32).reshape(-1, 3)
            edge_at = len(pts) // REP_HOSTS
            ref = ResidentKnnEngine(pts, WALL_K, num_shards=REP_HOSTS,
                                    merge="device",
                                    max_batch=SERVE_MAX_BATCH)
        with timed_step(steps, "start-up"):
            took = wait_serving(hosts, host_urls, groups)
            fe_took = wait_serving(fe, [fe_url], groups)
        say(f"  hosts serving {', '.join(f'{t:.1f}' for t in took)} s after"
            f" their start, the front end {fe_took[0]:.1f} s")
        details["host_start_seconds"] = took
        details["frontend_start_seconds"] = fe_took[0]
        cfg = get_json(host_urls[0] + "/stats")["engine"]
        if cfg["merge"] != "device" or not cfg["multihost"] or \
                [get_json(u + "/stats")["engine"]["my_positions"]
                 for u in host_urls] != [[i] for i in range(REP_HOSTS)]:
            fail(f"19: the hosts do not own one position each: {cfg}")

        # -- 19a: the fixed list against one engine ------------------------
        rng = np.random.default_rng(SEED + 140)
        edge = pts[edge_at - POD_DUPS:edge_at + POD_DUPS]

        def uniform(g, n):
            return g.random((n, 3), dtype=np.float32)

        def with_edge(n):
            q = uniform(rng, n)
            q[rng.choice(n, len(edge), replace=False)] = edge
            return q

        reqs = [(uniform(rng, 1), False), (uniform(rng, 7), True),
                (with_edge(300), False), (with_edge(1024), True),
                (with_edge(1024), False), (uniform(rng, 300), True),
                (edge.copy(), False), (uniform(rng, 1), True),
                (with_edge(7 + len(edge)), False)]
        f0 = [get_json(u + "/stats")["engine"] for u in host_urls]
        with timed_step(steps, "19a"):
            base = replay_port(fe_port, reqs)
        f1 = [get_json(u + "/stats")["engine"] for u in host_urls]
        for (q, binary), (status, body, _r) in zip(reqs, base):
            if status != 200:
                fail(f"19a: a request of {len(q)} rows: HTTP {status}: "
                     f"{body[:300]!r}")
            want_d, want_i = ref.query(q)
            if binary:
                if body != want_d.tobytes():
                    fail(f"19a: the binary body of {len(q)} rows differs "
                         "from one engine's")
                continue
            obj = json.loads(body)
            if np.asarray(obj["dists"], np.float32).tobytes() \
                    != want_d.tobytes() or not np.array_equal(
                        np.asarray(obj["neighbors"], np.int32), want_i):
                fail(f"19a: the JSON body of {len(q)} rows differs from one "
                     "engine's")
        obj = json.loads(base[6][1])
        for row, nb in zip(edge, obj["neighbors"]):
            zero = [j for j in nb if np.array_equal(pts[j], row)]
            if len(zero) < 2 or zero != sorted(zero) or \
                    not (zero[0] < edge_at <= zero[-1]):
                fail(f"19a: distance-0 ids {zero} of a row on the position "
                     "edge are not its two copies, ascending")
        fetched = [b["fetch_bytes"] - a["fetch_bytes"]
                   for a, b in zip(f0, f1)]
        one = sum(ref.bucket_for(len(q)) for q, _b in reqs) \
            * 4 * (1 + WALL_K)
        if sum(fetched) != one or len(set(fetched)) != 1:
            fail(f"19a: the hosts fetched {fetched} B for {len(reqs)} "
                 f"batches, one result each is {one} B in all")
        say(f"  19a: {len(reqs)} requests ({sum(len(q) for q, _ in reqs)} "
            "rows: 1, 7, 300 and 1024, rows on the copies across the first "
            "position edge), JSON and binary bodies byte-equal to one "
            f"ResidentKnnEngine(num_shards={REP_HOSTS}, merge='device'), "
            "distance-0 ids ascending across the edge; the hosts fetched "
            f"{fetched} B, one result a batch ({one} B) in all")
        details["19a"] = {"requests": len(reqs), "host_fetch_bytes": fetched,
                          "one_result_bytes": one}

        # -- 19b: closed-loop traffic --------------------------------------
        a = get_json(fe_url + "/stats")["fanout"]
        hs0 = [get_json(u + "/stats")["engine"] for u in host_urls]
        l0 = pod_launches(host_urls)
        with timed_step(steps, "19b"):
            traffic = closed_loop(fe_port, uniform, REP_SECONDS, WALL_K,
                                  SEED + 141)
        b = get_json(fe_url + "/stats")["fanout"]
        hs1 = [get_json(u + "/stats")["engine"] for u in host_urls]
        l1 = pod_launches(host_urls)
        counts = {key: l1[key] - l0.get(key, 0) for key in l1}
        lats = traffic["latencies"]
        rows = sum(len(r[0]) for r in traffic["records"])
        batches = b["batches"] - a["batches"]
        fetched = [h1["fetch_bytes"] - h0["fetch_bytes"]
                   for h0, h1 in zip(hs0, hs1)]
        returned = sum(h1["result_rows"] - h0["result_rows"]
                       for h0, h1 in zip(hs0, hs1))
        straggler = b["straggler_seconds_total"] \
            - a["straggler_seconds_total"]
        exchange = [h1["exchange_seconds"] - h0["exchange_seconds"]
                    for h0, h1 in zip(hs0, hs1)]
        m = {"requests": len(lats), "rows": rows, "seconds": traffic["wall"],
             "queries_per_second": rows / traffic["wall"],
             "p50_ms": float(np.percentile(lats, 50)) * 1e3,
             "p99_ms": float(np.percentile(lats, 99)) * 1e3,
             "batches": batches, "straggler_seconds": straggler,
             "host_exchange_seconds_per_batch": [e / max(1, batches)
                                                 for e in exchange],
             "host_fetch_bytes_per_batch": [f / max(1, batches)
                                            for f in fetched],
             "rejected_429": traffic["rejected"], "launches": counts}
        if len(set(fetched)) != 1 or returned != rows or \
                sum(fetched) < rows * 4 * (1 + WALL_K):
            fail(f"19b: the hosts fetched {fetched} B and returned "
                 f"{returned} of {rows} rows")
        say(f"  19b: {m['queries_per_second']:.0f} queries/s over "
            f"{m['seconds']:.1f} s ({m['requests']} requests, {rows} rows, "
            f"{batches} batches); p50 {m['p50_ms']:.2f} ms p99 "
            f"{m['p99_ms']:.2f} ms; straggler {straggler:.3f} s in all; "
            f"each host fetched {fetched[0] / max(1, batches):.0f} B a batch"
            f" (a quarter of a result each), rows returned once; the "
            "merge's all_to_all took "
            + "/".join(f"{e * 1e3:.1f}" for e in
                       m["host_exchange_seconds_per_batch"])
            + f" ms a batch in hosts 0-3 ({smi})")
        say(f"  19b: launches in the host processes "
            f"{counts['knn_tiled_launches']}, on the D=3 kernel "
            f"{counts['knn_tiled_d3_launches']}")
        if counts["knn_tiled_launches"] < 1 or \
                counts["knn_tiled_d3_launches"] \
                != counts["knn_tiled_launches"] or counts["knn_bf_launches"]:
            fail(f"19b: launches off the D=3 traversal kernel: {counts}")
        with timed_step(steps, "check rows"):
            pts_t = torch.from_numpy(pts).cuda()
            ref_side = partition_points(pts_t, bucket_size=256)
            checked, id_rows, ties = check_served_rows(
                "19b", traffic, ref_side, WALL_K, pts_t, SEED + 142)
            del pts_t, ref_side
            torch.cuda.empty_cache()
        say(f"  19b: {checked} sampled served rows byte-equal to the exact "
            f"answer, ids of {id_rows} rows equal up to {ties} rows of exact"
            " ties")
        m["check"] = {"rows": checked, "id_rows": id_rows,
                      "id_rows_differing_by_ties": ties}
        details["19b"] = m

        # -- 19c: a host lost --------------------------------------------
        with timed_step(steps, "19c"):
            lost = hosts[1][REP_HOSTS - 1]
            lost.send_signal(signal.SIGTERM)
            lost.wait(timeout=30)
            status, body, sec, retry = tier_post(fe_port, "/knn",
                                                 uniform(rng, 16), False,
                                                 timeout=120)
            if status != 503 or b"PodBrokenError" not in body or \
                    retry is None:
                fail(f"19c: after SIGTERM to host {REP_HOSTS - 1}: HTTP "
                     f"{status}, {body[:300]!r}")
            hz = get_json_any(fe_url + "/healthz")
            if hz[0] != 503 or hz[1]["status"] != "broken" or \
                    not hz[1]["broken"]:
                fail(f"19c: /healthz after the loss: {hz}")
            kill_groups(groups)
        say(f"  19c: host {REP_HOSTS - 1} sent SIGTERM: the next request "
            f"answered 503 in {sec:.2f} s ({json.loads(body)['error'][:80]}"
            "...), /healthz status broken; every child killed")
        details["19c"] = {"request_seconds": sec,
                          "error": json.loads(body)["error"]}
    except BaseException:
        kill_groups(groups)
        raise
    stop_children(groups)
    del ref
    torch.cuda.empty_cache()
    details["step_seconds"] = steps
    details["seconds"] = time.perf_counter() - t_phase
    say("  steps: " + ", ".join(f"{name} {sec:.1f} s"
                                for name, sec in steps.items()))
    say(f"  phase 19 took {details['seconds']:.1f} s")
    return details, counts


TOOL_SECONDS = 8.0               # 20a: loadgen traffic a workload
TOOL_CLIENTS = 8                 # 20a: loadgen's closed-loop workers
TOOL_BATCH = 1024                # 20a: rows a request
TOOL_CHILD_SECONDS = 300         # phase 20: a child's wall-clock limit
RECALL_K = 16                    # 20b: the recall harness's defaults
RECALL_POINTS, RECALL_QUERIES = 16_384, 512


def load_tool(name):
    """A script of ``tools/`` as a module (the tools are not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finish_child(group, groups, seconds):
    """Waits for a group's one child within ``seconds`` of the group's
    start; a child that fails or outlives it kills every child of
    ``groups`` and fails the phase. Returns its stdout."""
    label, procs, files, t0 = group
    try:
        procs[0].wait(timeout=max(1.0, seconds - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        kill_groups(groups)
        fail(f"{label}: outlived {seconds} s")
    out = child_tail(group, 0)
    if procs[0].returncode != 0:
        kill_groups(groups)
        fail(f"{label} exited {procs[0].returncode}:\n{out}")
    files[0][0].seek(0)
    text = files[0][0].read()
    for f in files[0]:
        f.close()
    groups.remove(group)
    return text


def wait_url(group, groups):
    """The URL a ``serve_main`` child prints once it serves (``--port 0``:
    ``serving kNN on http://127.0.0.1:<port>``), within
    ``TOOL_CHILD_SECONDS``; returns (url, seconds it took)."""
    label, procs, files, t0 = group
    while True:
        if procs[0].poll() is not None:
            kill_groups(groups)
            fail(f"{label} exited {procs[0].returncode}:\n"
                 f"{child_tail(group, 0)}")
        files[0][0].flush()
        files[0][0].seek(0)
        for line in files[0][0].read().splitlines():
            if line.startswith("serving kNN on http://"):
                return (line.split()[3], time.perf_counter() - t0)
        if time.perf_counter() - t0 > TOOL_CHILD_SECONDS:
            kill_groups(groups)
            fail(f"{label}: not serving after {TOOL_CHILD_SECONDS} s")
        time.sleep(0.2)


def tooling_phases(smi, in_thread_qps, phase4):
    """Phase 20: the port's tools on the card. A ``serve_main`` child
    serves 16s's raw file (16a's N_WALL points, in Morton order) at
    k=WALL_K, R=1, on 127.0.0.1:0, and ``tools/torch_lskcheck.py`` runs in
    another child, both started at once; meanwhile, in this process, 20c
    (``obs/cost.py`` over phase 4's two runs) and 20b
    (``tools/torch_recall_harness.py`` on the card at its defaults); then
    20d (the gate's exit) and 20a: a 64-row probe, ``tools/
    torch_loadgen.py`` in a child process twice (closed loop, 8 workers,
    binary rows of 1024, uniform then sweep), the probe again, both
    answers byte-equal and exact. ``in_thread_qps`` is 16a's in-thread
    q/s at the same configuration, printed beside 20a's. Returns
    (details, the server's launch counts during 20a's traffic)."""
    import io

    import numpy as np
    import torch

    from mpi_cuda_largescaleknn_torch.obs.cost import cost_report
    from mpi_cuda_largescaleknn_torch.ops.partition import partition_points
    from mpi_cuda_largescaleknn_torch.serve.engine import ResidentKnnEngine
    from mpi_cuda_largescaleknn_torch.serve.recall import (
        RecallPolicy,
        measured_recall,
    )

    details, steps = {}, {}
    t_phase = time.perf_counter()
    say(f"[phase 20] the port's tools: serve_main and torch_loadgen in "
        f"processes of their own, the recall harness, the cost model, the "
        "analyzer")
    path = WORK / "tier.float3"
    logs = WORK / "tools"
    logs.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    groups = []
    server = start_children("serve_main", [[
        py, "-u", "-m", "mpi_cuda_largescaleknn_torch.cli.serve_main",
        str(path), "-k", str(WALL_K), "--port", "0",
        "--max-queue-rows", str(TOOL_CLIENTS * TOOL_BATCH),
        "--timeout-ms", "60000"]], groups, "tools")
    lint = start_children("torch_lskcheck", [[
        py, str(ROOT / "tools" / "torch_lskcheck.py"), "-q"]], groups,
        "tools")
    try:
        # -- 20c: the cost model over phase 4's runs ------------------------
        say("[phase 20c] obs/cost.py cost_report over phase 4's --timings "
            "runs")
        kind = torch.cuda.get_device_name()
        details["20c"] = {}
        for label in ("k100", "k8"):
            t = phase4[label]
            rep = cost_report(t["pair_evals"], t["ring"]["seconds"], "gpu",
                              kind)
            if not 0.0 < rep["mfu_estimate"] <= 1.0 or (
                    "h100" in kind.lower()
                    and rep["assumed_peak_flops"] != 67e12):
                fail(f"20c: {label}: {rep}")
            details["20c"][label] = rep
            say(f"  phase 4 {label}: {rep['pair_evals']} pair evaluations "
                f"in {t['ring']['seconds']:.4f} s of ring, "
                f"{rep['pair_evals_per_sec']:.4e} pairs/s, mfu_estimate "
                f"{rep['mfu_estimate']} of {rep['assumed_peak_flops']:.3e} "
                f"FP32 FLOP/s ({rep['device_kind']}; {smi})")

        # -- 20b: the recall harness on the card ----------------------------
        say(f"[phase 20b] tools/torch_recall_harness.py on the card: "
            f"{RECALL_POINTS} points, k={RECALL_K}, {RECALL_QUERIES} queries")
        harness = load_tool("torch_recall_harness")
        policy_path = logs / "recall_policy.json"
        with timed_step(steps, "20b harness"), redirect_stdout(io.StringIO()):
            rc = harness.main(["--out", str(policy_path)])
        report = json.loads(policy_path.read_text())
        if rc != 0 or report["fixture"]["device"].split(":")[0] != "cuda":
            fail(f"20b: the harness returned {rc} on "
                 f"{report['fixture']['device']}")
        for plan, per in report["measured"].items():
            if not all(0.0 <= v <= 1.0 for v in per.values()):
                fail(f"20b: {plan}: a measured recall outside [0, 1]: {per}")
        policy = RecallPolicy.from_file(str(policy_path))
        if [p.name for p in policy.plans] != [
                p["name"] for p in report["plans"]]:
            fail("20b: the policy file loads other plans than it holds")
        # the exact plan: the harness's oracle against the plain traversal
        with timed_step(steps, "20b exact plan"):
            pts = np.random.default_rng(0).random(
                (RECALL_POINTS, 3)).astype(np.float32)
            exact = ResidentKnnEngine(pts, RECALL_K, engine="tiled",
                                      bucket_size=64, max_batch=256,
                                      min_batch=16)
            ref = partition_points(torch.from_numpy(pts).cuda(),
                                   bucket_size=256)
            exact_recall = {}
            for wl in report["fixture"]["workloads"]:
                q = harness.workload_queries(wl, RECALL_QUERIES, 0)
                got = np.concatenate([exact.query(q[i:i + 256])[1]
                                      for i in range(0, len(q), 256)])
                want = exact_reference(ref, q, RECALL_K)[1].cpu().numpy()
                exact_recall[wl] = measured_recall(got, want)
            del exact, ref
        if any(v != 1.0 for v in exact_recall.values()):
            fail(f"20b: the exact plan's recall is {exact_recall}")
        details["20b"] = {"measured": report["measured"],
                          "plans": report["plans"],
                          "exact_plan_recall": exact_recall}
        say("  measured recall (worst workload): " + ", ".join(
            f"{name} {min(per.values()):.4f}"
            for name, per in report["measured"].items())
            + f"; the exact plan 1.0 on {', '.join(exact_recall)}; the "
            f"policy file loads {len(policy.plans)} plans "
            f"({steps['20b harness']:.1f} s; {smi})")

        # -- 20d: the analyzer's full gate ----------------------------------
        say("[phase 20d] tools/torch_lskcheck.py, the full gate")
        lint_out = finish_child(lint, groups, TOOL_CHILD_SECONDS)
        summary = lint_out.strip().splitlines()[-1]
        if not (summary.startswith("torch_lskcheck: ")
                and " 0 finding(s)" in summary and summary.endswith("OK")):
            fail(f"20d: {summary}")
        details["20d"] = summary
        say(f"  exit 0: {summary}")

        # -- 20a: serve_main driven by torch_loadgen ------------------------
        url, ready_s = wait_url(server, groups)
        port = int(url.rsplit(":", 1)[1])
        say(f"[phase 20a] serve_main on {N_WALL} points, k={WALL_K}, R=1, "
            f"at {url} (serving {ready_s:.1f} s after its start), driven by "
            "tools/torch_loadgen.py in a process of its own")
        with timed_step(steps, "20a reference"):
            pts = np.fromfile(path, np.float32).reshape(-1, 3)
            pts_t = torch.from_numpy(pts).cuda()
            ref = partition_points(pts_t, bucket_size=256)
            probe = probe_rows(pts, SEED + 500)
            want_d, want_idx = exact_reference(ref, probe, WALL_K)
            del ref

        def probe_body(label):
            status, body, _, _ = tier_post(port, "/knn", probe, False)
            if status != 200:
                fail(f"20a: {label} probe: HTTP {status}: {body[:300]!r}")
            return body

        before = probe_body("first")
        s0 = get_json(url + "/stats")
        if "launches" not in s0:
            fail("20a: the server's engine is not on the card")
        runs = {}
        for wl in ("uniform", "sweep"):
            out = logs / f"loadgen_{wl}.json"
            g = start_children(f"loadgen {wl}", [[
                py, str(ROOT / "tools" / "torch_loadgen.py"), "--url", url,
                "--duration", str(TOOL_SECONDS), "--concurrency",
                str(TOOL_CLIENTS), "--batch", str(TOOL_BATCH), "--binary",
                "--server-stats", "--workload", wl, "--seed",
                str(SEED + 510), "--timeout", "60", "--out", str(out)]],
                groups, "tools")
            with timed_step(steps, f"20a {wl}"):
                finish_child(g, groups, TOOL_SECONDS + 120)
            rep = json.loads(out.read_text())
            errors = {key: rep[key] for key in (
                "net_error", "http_error", "overload", "deadline",
                "unavailable", "degraded") if rep[key]}
            if errors or rep["requests"] < 1 or rep["ok"] != rep["requests"]:
                fail(f"20a {wl}: errors {errors} in {rep['requests']} "
                     f"requests: {rep['status_counts']}")
            runs[wl] = rep
        s1 = get_json(url + "/stats")
        after = probe_body("second")
        d, idx = decode_knn(before, False, len(probe), WALL_K)
        if after != before:
            fail("20a: the probe's answers before and after the traffic "
                 "differ")
        if d.tobytes() != want_d.cpu().numpy().tobytes():
            fail("20a: the probe's distances differ from the exact answer")
        ties = tie_rows(torch.from_numpy(idx).cuda(), want_idx,
                        torch.from_numpy(probe).cuda(), pts_t)
        del pts_t
        batches = s1["batcher"]["batches"] - s0["batcher"]["batches"]
        counts = {key: s1["launches"][key] - s0["launches"].get(key, 0)
                  for key in s1["launches"]}
        if s1["engine"]["compile_count"] != s0["engine"]["compile_count"] \
                or s0["engine"]["compile_count"] != len(
                    s0["engine"]["shape_buckets"]):
            fail(f"20a: {s0['engine']['compile_count']} plans at warmup, "
                 f"{s1['engine']['compile_count']} after the traffic, "
                 f"{len(s0['engine']['shape_buckets'])} shape buckets")
        if batches < 1 or counts["knn_tiled_launches"] != batches or \
                counts["knn_tiled_d3_launches"] != batches or \
                counts["knn_bf_launches"] or \
                s1["engine"]["engine"] != "pallas_tiled":
            fail(f"20a: {batches} batches, launches {counts}, engine "
                 f"{s1['engine']['engine']}")
        peak = s1["device_memory"]["peak_allocated_bytes"]
        details["20a"] = {
            "url": url, "ready_seconds": ready_s, "runs": runs,
            "batches": batches, "launches": counts,
            "compile_count": s1["engine"]["compile_count"],
            "probe_id_rows_differing_by_ties": ties,
            "peak_device_bytes": peak,
            "device_bytes": s1["engine"]["device_bytes"],
            "in_thread_16a_queries_per_second": in_thread_qps}
        for wl, rep in runs.items():
            say(f"  20a {wl}: {rep['rows_per_s']:.0f} queries/s "
                f"({rep['qps']:.2f} requests/s of {TOOL_BATCH} rows, "
                f"{rep['requests']} requests, 0 errors) over "
                f"{rep['duration_s']:.1f} s; client latency p50 "
                f"{rep['p50_ms']} ms p99 {rep['p99_ms']} ms; mean batch "
                f"{rep['server']['mean_batch_rows']} rows ({smi})")
        say(f"  16a in-thread, k={WALL_K} R=1: {in_thread_qps:.0f} queries/s "
            f"({smi}); the server's peak device memory "
            f"{peak / 2**20:.1f} MiB ({smi})")
        say(f"  {batches} batches dispatched, {counts['knn_tiled_launches']} "
            f"traversal launches, all {counts['knn_tiled_d3_launches']} on "
            f"knn_tiled_d3; {s1['engine']['compile_count']} plans, none "
            f"built after warmup; the {len(probe)}-row probe byte-equal "
            f"before and after, distances equal to the exact answer, ids up "
            f"to {ties} rows of exact ties")
    except BaseException:
        kill_groups(groups)
        raise
    stop_children(groups)
    if server[1][0].returncode != 0:
        fail(f"20a: serve_main exited {server[1][0].returncode} on SIGINT")
    torch.cuda.empty_cache()
    details["step_seconds"] = steps
    details["seconds"] = time.perf_counter() - t_phase
    say("  steps: " + ", ".join(f"{name} {sec:.1f} s"
                                for name, sec in steps.items()))
    say(f"  phase 20 took {details['seconds']:.1f} s")
    return details, counts


def get_json_any(url):
    """(status, decoded body) of a GET, an HTTP error status included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from mpi_cuda_largescaleknn_torch.utils.cuda_build import (
            build_library,
        )
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    details = {}

    # -- phase 1 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    say(smi)
    say(json.dumps({"kernels": list(KERNELS)}))
    details["nvidia_smi"] = smi
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # -- phase 2 ------------------------------------------------------------
    say("[phase 2] build")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build_library, KERNELS))
    say(f"  wall {time.perf_counter() - t0:.1f} s")
    details["build_seconds"] = {}
    for name, (lib, log, secs) in zip(KERNELS, built):
        say(f"  built {lib.name} in {secs:.1f} s")
        for line in log.splitlines():
            # each kernel's name, registers and spills, and any warning but
            # the C7519 notes where ptxas fences wgmma accumulators (one per
            # product site; C7520 would mean serialized products)
            if any(key in line for key in ("registers", "spill", "smem",
                                           "entry function", "arning")) \
                    and "C7519" not in line:
                say(f"  ptxas: {line.strip()[:160]}")
        details["build_seconds"][name] = secs

    # -- phase 3 ------------------------------------------------------------
    say("[phase 3] kernel vs plain on the card, bit for bit")
    uni = seeded_points("uniform", 32_000, SEED)
    clu = seeded_points("clustered", 32_000, SEED + 1)
    grid = grid_points(32_000, SEED + 7)
    d3 = dict(route="d3")
    errs = [compare_case(f"uniform k={k} skip_self G2", uni, k, **d3)
            for k in (1, 8, 31, 32, 33, 64, 65, 100, 200)]
    errs += [compare_case(f"integer grid k={k} skip_self G2 (ties)", grid, k,
                          **d3) for k in (8, 32, 33, 65, 100)]
    errs += [
        compare_case("uniform k=8 -r 0.02 cold G1", uni, 8, radius=0.02,
                     group=1, warm=False, **d3),
        compare_case("clustered k=8 skip_self G2", clu, 8, **d3),
        compare_case("clustered k=100 -r 1.5 skip_self G2", clu, 100,
                     radius=1.5, **d3),
        compare_case("uniform k=8 T=2000 (partial last tile)", uni, 8,
                     bucket_size=1024, **d3),
        compare_case("integer grid k=33 S=1000 T=2000 (ties, partial last "
                     "tile)", grid, 33, bucket_size=1000, **d3),
        compare_case("integer grid k=300 (16 slots a lane)", grid[:16_000],
                     300, **d3),
        compare_case("uniform k=903 (32 slots a lane, the largest k)",
                     uni[:16_000], 903, **d3),
    ]
    errs.append(grid_split_cases(uni))
    details["phase3_max_abs_err"] = max(errs)

    # -- phase 3b -----------------------------------------------------------
    say("[phase 3b] brute-force kernel vs plain on the card, bit for bit")
    from mpi_cuda_largescaleknn_torch.core.types import PAD_SENTINEL

    padded = np.concatenate([uni, np.full((1000, 3), PAD_SENTINEL,
                                          np.float32)])
    odd = seeded_points("uniform", 32_777, SEED + 3)
    grid_odd = grid_points(32_777, SEED + 8)
    bf_errs = [compare_bf_case(f"uniform k={k}", uni, uni, k)
               for k in (1, 8, 31, 32, 33, 64, 65, 100, 200)]
    bf_errs += [compare_bf_case(f"integer grid k={k} (ties)", grid, grid, k)
                for k in (8, 32, 33, 65, 100)]
    bf_errs += [
        compare_bf_case("uniform k=8 -r 0.02", uni, uni, 8, radius=0.02),
        compare_bf_case("clustered k=8", clu, clu, 8),
        compare_bf_case("clustered k=100 -r 1.5", clu, clu, 100,
                        radius=1.5),
        compare_bf_case("uniform k=8, 1000 sentinel points and queries",
                        padded, padded, 8),
        compare_bf_case("uniform k=8 ids from 1,000,000", uni, uni, 8,
                        id_base=1_000_000),
        compare_bf_case("uniform k=8 in two calls (12,345 + rest)", uni, uni,
                        8, split=12_345),
        compare_bf_case("uniform k=8 N=32,777 (partial last tile)", odd,
                        odd, 8),
        compare_bf_case("integer grid k=65 N=32,777 (ties, partial last "
                        "tile)", grid_odd, grid_odd, 65),
        compare_bf_case("uniform k=100 query_tile=96 point_tile=300", uni,
                        uni, 100, tiles=(96, 300)),
        compare_bf_case("integer grid k=300 (16 slots a lane)", grid[:4096],
                        grid, 300),
        compare_bf_case("uniform k=903 (32 slots a lane, the largest k)",
                        uni[:2048], uni[:20_000], 903),
    ]
    details["phase3b_max_abs_err"] = max(bf_errs)

    # -- phase 3c -----------------------------------------------------------
    say("[phase 3c] the ring kernel (f32, D != 3) vs plain on the card, bit "
        "for bit")
    nd = {d: clustered_nd(32_000, d, SEED + 10 + d)
          for d in (4, 5, 16, 32, 64, 128, 130)}
    # a finite -r for k=10
    radius = {4: 0.6, 5: 0.7, 16: 4.0, 128: 14.5, 130: 14.6}
    ring = dict(route="ring")
    nd_errs = []
    for d in (4, 16, 128):
        x = nd[d]
        nd_errs += [
            compare_case(f"D={d} k=1 skip_self G2", x, 1, **ring),
            compare_case(f"D={d} k=10 skip_self G2", x, 10, **ring),
            compare_case(f"D={d} k=100 skip_self G2", x, 100, **ring),
            compare_case(f"D={d} k=10 -r {radius[d]} cold G1", x, 10,
                         radius=radius[d], group=1, warm=False, **ring),
        ]
    # Dp4 pads (D=5: 8 components, D=130: 132)
    for d in (5, 130):
        nd_errs += [
            compare_case(f"D={d} k=10 skip_self G2", nd[d], 10, **ring),
            compare_case(f"D={d} k=10 -r {radius[d]} cold G1", nd[d], 10,
                         radius=radius[d], group=1, warm=False, **ring),
        ]
    nd_errs += [
        compare_case("D=16 k=10 T=2000 (two staged tiles)", nd[16], 10,
                     bucket_size=1024, **ring),
        compare_case("D=64 k=10 S=1000 (rows over 8 blocks, T=2000)",
                     nd[64], 10, bucket_size=1000, **ring),
        compare_case("D=128 k=1000 (rows in device memory)", nd[128][:8_000],
                     1000, **ring),
    ]
    # above RESIDENT_MAX_DP4: D streamed in slices (D=228 and 256 just
    # above the resident route, D=960 GIST's width)
    wide = {d: clustered_nd(8_000, d, SEED + 10 + d)
            for d in (228, 240, 256, 960)}
    stream = dict(route="stream")
    for d, x in wide.items():
        nd_errs += [compare_case(f"D={d} k={k} skip_self G2", x, k, **stream)
                    for k in (1, 10, 100)]
    nd_errs += [
        compare_case("D=240 k=10 -r 22 cold G1", wide[240], 10, radius=22.0,
                     group=1, warm=False, **stream),
        compare_case("D=240 k=10 S=1000 (rows over 8 blocks, T=2000)",
                     wide[240], 10, bucket_size=1000, **stream),
    ]
    nd_errs += [compare_case(f"D={d} k=1000 (rows in device memory)",
                             wide[d], 1000, **stream) for d in (240, 960)]
    # the flat fold on the ring kernel
    for d in (4, 16, 128):
        x = nd[d]
        qx = x[:4096] if d == 128 else x   # keeps the plain version short
        nd_errs += [
            compare_bf_case(f"D={d} k=1", qx, x, 1),
            compare_bf_case(f"D={d} k=10", qx, x, 10),
            compare_bf_case(f"D={d} k=100", qx, x, 100),
            compare_bf_case(f"D={d} k=10 -r {radius[d]}", qx, x, 10,
                            radius=radius[d]),
        ]
    sent = np.concatenate([nd[128][:20_000],
                           np.full((500, 128), PAD_SENTINEL, np.float32)])
    nd_errs += [
        compare_bf_case("D=128 k=10, 500 sentinel points and queries "
                        "(N=20,500: a partial last chunk)", sent[-4_500:],
                        sent, 10),
        compare_bf_case("D=240 k=10", wide[240][:2_000], wide[240], 10),
    ]
    nd_errs += [compare_bf_case(f"D={d} k=1000", x[:2_000], x, 1000)
                for d, x in ((128, nd[128][:8_000]), (240, wide[240]),
                             (960, wide[960]))]
    del wide
    details["phase3c_max_abs_err"] = max(nd_errs)

    # -- phase 3d -----------------------------------------------------------
    say("[phase 3d] the tensor-core bf16 kernel vs plain on the card")
    mxu_radius = {16: 4.0, 32: 6.0, 64: 10.0, 128: 14.5}
    mxu_errs = []
    for d in (16, 32, 64, 128):
        x = nd[d]
        bf = dict(score_dtype="bf16", route="wgmma")
        mxu_errs += [
            compare_case(f"bf16 D={d} k=1 skip_self G2", x, 1, **bf),
            compare_case(f"bf16 D={d} k=10 skip_self G2", x, 10, **bf),
            compare_case(f"bf16 D={d} k=100 skip_self G2", x, 100, **bf),
            compare_case(f"bf16 D={d} k=10 -r {mxu_radius[d]} cold G1", x,
                         10, radius=mxu_radius[d], group=1, warm=False,
                         **bf),
        ]
    mxu_errs += [
        compare_case("bf16 D=64 k=10 S=1000 (rows over 8 blocks, T=2000)",
                     nd[64], 10, bucket_size=1000, score_dtype="bf16",
                     route="wgmma"),
        compare_case("bf16 D=200 k=10 skip_self G2 (2-stage ring)",
                     clustered_nd(8_000, 200, SEED + 220), 10,
                     score_dtype="bf16", route="wgmma"),
    ]
    # above WGMMA_MAX_DP, D streamed in K-slices: D=240 just above, D=600
    # (Dp=608) and D=1000 (Dp=1008) with a short last slice, D=960 GIST's
    # width
    wide = {d: clustered_nd(8_000, d, SEED + 20 + d)
            for d in (240, 600, 960, 1000)}
    bfs = dict(score_dtype="bf16", route="wgmma_stream")
    mxu_errs += [compare_case(f"bf16 D={d} k=10 skip_self G2", wide[d], 10,
                              **bfs) for d in (240, 600, 1000)]
    mxu_errs += [compare_case(f"bf16 D=960 k={k} skip_self G2", wide[960], k,
                              **bfs) for k in (1, 10, 100)]
    mxu_errs += [
        compare_case("bf16 D=960 k=1000 (W=2000, rows in device memory)",
                     wide[960], 1000, **bfs),
        compare_case("bf16 D=600 k=10 S=1000 (rows over 8 blocks, T=2000)",
                     wide[600], 10, bucket_size=1000, **bfs),
    ]
    details["phase3d_max_abs_err"] = max(mxu_errs)
    del nd, wide

    # -- phase 3e -----------------------------------------------------------
    say("[phase 3e] the kernels on the chunked loops' query sides vs plain "
        "on the card")
    details["phase3e_max_abs_err"] = chunk_cases()

    # -- phase 4 ------------------------------------------------------------
    say(f"[phase 4] main path: {N_MAIN} uniform points through the CLI")
    WORK.mkdir(parents=True, exist_ok=True)
    pts_np = seeded_points("uniform", N_MAIN, SEED + 2)
    pts_path = WORK / "pts.float3"
    pts_np.tofile(pts_path)
    runs = {}
    runs["k100"] = main_path_run("k=100 R=1", pts_path, WORK / "k100.float",
                                 100, 1, N_MAIN)
    runs["k8"] = main_path_run("k=8 R=1", pts_path, WORK / "k8.float", 8, 1,
                               N_MAIN)

    # -- phase 5 ------------------------------------------------------------
    say("[phase 5] k=8 over 4 virtual shards")
    runs["k8_r4"] = main_path_run("k=8 R=4", pts_path, WORK / "k8_r4.float",
                                  8, 4, N_MAIN)
    if (WORK / "k8_r4.float").read_bytes() != (WORK / "k8.float").read_bytes():
        fail("R=4 distances differ from R=1")
    say("  R=4 output is byte-equal to R=1")
    details["main_path"] = runs

    # -- phase 5b -----------------------------------------------------------
    say("[phase 5b] the traverse stage of phases 4-5 split, in a fresh "
        "process")
    details["first_launch_split"] = first_launch_split()

    # -- phase 6 ------------------------------------------------------------
    say("[phase 6] kernel time at the main path's shapes")
    pts = torch.from_numpy(pts_np).cuda()
    timed = {}
    for k in (8, 100):
        r = time_kernel(k, pts)
        timed[k] = r
        say(f"  k={k}: Bq={r['Bq']} S={r['S']} Bp={r['Bp']} T={r['T']} "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"max_abs_err {r['max_abs_err']}")
        say(f"    pairs the kernel's blocks scored {r['pairs']} "
            f"({r['block_visits']} block visits; the most of a bucket's "
            f"blocks: {r['kernel_visits']}): {bound_txt(r)}")
        say(f"    pairs of the plain version's walk {r['plain_walk_pairs']} "
            f"({r['visits']} bucket visits, "
            f"{r['pairs'] / r['plain_walk_pairs']:.4f}x the kernel's): "
            f"{bound_txt(r['plain_walk'])}")
        say(f"    plan {r['plan']}, {r['warps_per_sm']} warps resident per "
            f"SM (the plan counted on {r['planned_warps_per_sm']})")
    details["kernel_timing"] = timed
    del pts

    # -- phase 7 ------------------------------------------------------------
    say("[phase 7] the flat engine through the unordered CLI")
    runs["pallas_k8"] = main_path_run("--engine pallas k=8 R=1", pts_path,
                                      WORK / "pallas_k8.float", 8, 1, N_MAIN,
                                      engine="pallas")
    if (WORK / "pallas_k8.float").read_bytes() != \
            (WORK / "k8.float").read_bytes():
        fail("--engine pallas distances differ from --engine auto")
    say("  --engine pallas output is byte-equal to --engine auto")

    # -- phase 8 ------------------------------------------------------------
    say("[phase 8] the pre-partitioned pipeline")
    parts = WORK / "parts"
    parts.mkdir(exist_ok=True)
    lst = partition_file(pts_path, 4, parts / "u4")
    pre = {}
    pre["auto_k8"], auto8 = prepartitioned_run(
        "R=4 --engine auto k=8", lst, parts / "auto_k8", 8, "auto", 4)
    pre["pallas_k8"], pallas8 = prepartitioned_run(
        "R=4 --engine pallas k=8", lst, parts / "pallas_k8", 8, "pallas", 4)
    pre["auto_k100"], _ = prepartitioned_run(
        "R=4 --engine auto k=100", lst, parts / "auto_k100", 100, "auto", 4)
    if auto8 != pallas8:
        fail("pre-partitioned k=8: --engine pallas differs from auto")
    joined = parts / "u4_joined.float3"
    joined.write_bytes(b"".join(
        Path(f).read_bytes() for f in lst.read_text().split()))
    pre["unordered_joined_k8"] = main_path_run(
        "unordered CLI on the joined parts, k=8", joined,
        parts / "joined_k8.float", 8, 1, N_MAIN)
    if (parts / "joined_k8.float").read_bytes() != auto8:
        fail("pre-partitioned rank files differ from the unordered CLI "
             "on the joined parts")
    say("  k=8 rank files: auto == pallas == unordered CLI on the joined "
        "parts, byte for byte")
    clu_path = WORK / "clustered.float3"
    seeded_points("clustered", N_MAIN, SEED + 4).tofile(clu_path)
    lst8 = partition_file(clu_path, 8, parts / "c8")
    pre["clustered_auto_k8"], _ = prepartitioned_run(
        "clustered R=8 --engine auto k=8", lst8, parts / "c8_k8", 8, "auto",
        8)
    details["prepartitioned"] = pre

    # -- phase 9 ------------------------------------------------------------
    say("[phase 9] brute-force kernel time at the flat path's shape")
    pts = torch.from_numpy(pts_np).cuda()
    bf_timed = {}
    for k in (8, 100):
        r = time_bf_kernel(k, pts)
        bf_timed[k] = r
        say(f"  k={k}: {N_MAIN} x {N_MAIN} rows/block={r['rows_per_block']} "
            f"lanes={r['lanes']} kernel {r['ms']:.3f} ms, {bound_txt(r)}, "
            f"plain {r['plain_ms']:.3f} ms on {r['plain_shape']}, "
            f"max_abs_err {r['max_abs_err']}, {r['warps_per_sm']} warps "
            f"resident per SM (the plan counted on "
            f"{r['planned_warps_per_sm']})")
    details["bf_kernel_timing"] = bf_timed
    del pts

    # -- phase 10 -----------------------------------------------------------
    say(f"[phase 10] high-D main path: {N_MAIN} points, D={HD_DIM}, "
        f"k={HD_K}, 32 Gaussian clusters")
    hd = clustered_nd(N_MAIN, HD_DIM, SEED + 5)
    hd_runs, hd_out = {}, {}
    for label, shards, sd in (("bf16 R=1", 1, "bf16"), ("f32 R=1", 1, "f32"),
                              ("bf16 R=4", 4, "bf16")):
        t, d, idx = unordered_run(label, hd, HD_K, shards, sd)
        hd_runs[label], hd_out[label] = t, (d, idx)
    ref_d, ref_idx = hd_out["f32 R=1"]
    check_ring_route("phase 10: f32 R=1", hd_runs["f32 R=1"])
    hd_pts = torch.from_numpy(hd).cuda()
    for label in ("bf16 R=1", "bf16 R=4"):
        d, idx = hd_out[label]
        rows = int(np.count_nonzero(d.view(np.int32) != ref_d.view(np.int32)))
        if rows:
            fail(f"phase 10: {label} distances differ from f32 R=1 in "
                 f"{rows} rows")
        ties = tie_rows(torch.from_numpy(idx).cuda(),
                        torch.from_numpy(ref_idx).cuda(), hd_pts, hd_pts)
        hd_runs[label]["id_rows_differing_by_ties"] = ties
        say(f"  {label} output is byte-equal to f32 R=1; neighbor ids of "
            f"{ties} rows differ only among equally distant points")
    del hd_pts
    for label in ("bf16 R=1", "bf16 R=4"):
        t = hd_runs[label]
        if t["knn_tiled_wgmma_launches"] != t["knn_tiled_mxu_launches"]:
            fail(f"phase 10: {label} launched the wgmma kernel "
                 f"{t['knn_tiled_wgmma_launches']} of "
                 f"{t['knn_tiled_mxu_launches']} bf16 launches")
    ratio = (hd_runs["bf16 R=1"]["pair_evals"]
             / hd_runs["f32 R=1"]["pair_evals"])
    hd_runs["bf16 R=1"]["pair_evals_over_f32"] = ratio
    say(f"  bf16 R=1 pair_evals are {ratio:.4f}x f32 R=1's")
    if ratio > 1.1:
        fail(f"phase 10: bf16 pair_evals are {ratio:.4f}x f32's (> 1.1x)")
    t0 = time.perf_counter()
    checked = verify_sample_card(hd, ref_d, HD_K, HD_SELFCHECK)
    say(f"  selfcheck OK ({checked} samples, on the card, "
        f"{time.perf_counter() - t0:.1f} s)")
    details["high_d"] = hd_runs

    # -- phase 10b ----------------------------------------------------------
    say(f"[phase 10b] pre-partitioned on 4 .npy slab parts of the first "
        f"{HD_SUB} points")
    sub = hd[:HD_SUB]
    names = []
    t0 = time.perf_counter()
    for r in range(4):
        name = parts / f"hd_{r}.npy"
        np.save(name, sub[r * HD_SUB // 4:(r + 1) * HD_SUB // 4])
        names.append(str(name))
    say(f"  .npy parts written in {time.perf_counter() - t0:.1f} s")
    hd_list = parts / "hd.txt"
    hd_list.write_text("\n".join(names) + "\n")
    pre["highd_auto_k10"], hd_joined = prepartitioned_run(
        f"R=4 .npy D={HD_DIM} --engine auto k={HD_K}", hd_list,
        parts / "hd_k10", HD_K, "auto", 4, selfcheck=0, dim3=False)
    t0 = time.perf_counter()
    checked = verify_sample_card(sub, np.frombuffer(hd_joined, np.float32),
                                 HD_K, HD_SELFCHECK)
    say(f"  rank files: selfcheck OK ({checked} samples, on the card, "
        f"{time.perf_counter() - t0:.1f} s)")
    t_sub, d_sub, _ = unordered_run(f"f32 R=1 on the first {HD_SUB}", sub,
                                    HD_K, 1, "f32")
    hd_runs["f32 R=1 sub"] = t_sub
    check_ring_route("phase 10b: the pre-partitioned CLI",
                     pre["highd_auto_k10"])
    check_ring_route("phase 10b: UnorderedKNN", t_sub)
    if hd_joined != d_sub.astype(np.float32).tobytes():
        fail("phase 10b: pre-partitioned rank files differ from UnorderedKNN "
             "on the same points")
    say("  rank files joined == UnorderedKNN f32 on the same points, byte "
        "for byte")

    # -- phase 10c ----------------------------------------------------------
    say(f"[phase 10c] main paths above RESIDENT_MAX_DP4: {HD_SUB} points at "
        f"D={GIST_DIM}; the flat route at D={HD_DIM}")
    steps = {}    # seconds of each step of the phase, on the host's clock
    with timed_step(steps, "data"):
        gist = clustered_nd(HD_SUB, GIST_DIM, SEED + 6)
    label = f"f32 R=1 D={GIST_DIM}"
    with timed_step(steps, "f32 run"):
        t_gist, d_gist, i_gist = unordered_run(label, gist, HD_K, 1, "f32")
    hd_runs[label] = t_gist
    check_ring_route(f"phase 10c: {label}", t_gist, stream=True)
    label = f"bf16 R=1 D={GIST_DIM}"
    with timed_step(steps, "bf16 run"):
        t_gbf, d_gbf, i_gbf = unordered_run(label, gist, HD_K, 1, "bf16")
    hd_runs[label] = t_gbf
    n = t_gbf["knn_tiled_mxu_launches"]
    if n < 1 or t_gbf["knn_tiled_wgmma_stream_launches"] != n:
        fail(f"phase 10c: {label}: {t_gbf['knn_tiled_wgmma_stream_launches']} "
             f"of {n} bf16 launches on the wgmma kernel's streamed route")
    rows = int(np.count_nonzero(d_gbf.view(np.int32)
                                != d_gist.view(np.int32)))
    if rows:
        fail(f"phase 10c: {label}: distances differ from the f32 run in "
             f"{rows} rows")
    with timed_step(steps, "tie_rows"):
        gist_pts = torch.from_numpy(gist).cuda()
        ties = tie_rows(torch.from_numpy(i_gbf).cuda(),
                        torch.from_numpy(i_gist).cuda(), gist_pts, gist_pts)
        del gist_pts
    t_gbf["id_rows_differing_by_ties"] = ties
    say(f"  all {n} bf16 launches on the streamed route; distances "
        f"byte-equal to the f32 run; neighbor ids of {ties} rows differ only "
        "among equally distant points")
    # one selfcheck holds both runs' distances, which are the same bytes
    with timed_step(steps, "selfcheck"):
        checked = verify_sample_card(gist, d_gbf, HD_K, GIST_SELFCHECK)
    say(f"  selfcheck OK ({checked} samples, on the card) of the distances "
        "both runs share")
    del gist
    label = f"--engine pallas f32 R=1 on the first {HD_SUB}"
    with timed_step(steps, "flat run"):
        t_flat, d_flat, _ = unordered_run(label, sub, HD_K, 1, "f32",
                                          engine="pallas")
    hd_runs[label] = t_flat
    if t_flat["knn_bf_ring_launches"] != t_flat["knn_bf_launches"] or \
            t_flat["knn_tiled_launches"]:
        fail(f"phase 10c: {label}: {t_flat['knn_bf_ring_launches']} of "
             f"{t_flat['knn_bf_launches']} flat launches on the ring kernel, "
             f"{t_flat['knn_tiled_launches']} traversal launches")
    if d_flat.tobytes() != d_sub.tobytes():
        fail(f"phase 10c: {label}: distances differ from the auto run on the "
             "same points")
    say(f"  all {t_flat['knn_bf_launches']} flat launches on the ring kernel; "
        "distances byte-equal to the auto run on the same points")
    # each kernel against its bounds on the pairs it scored: the flat
    # fold's every pair, the traversal's pair_evals less the warm start's
    # own-bucket tiles (auto: buckets of 256, point group 2)
    from mpi_cuda_largescaleknn_torch.ops.partition import choose_buckets

    nqb, s = choose_buckets(HD_SUB, 256)
    warm_pairs = nqb * s * s * 2
    for t, dim, pairs in (
            (t_gist, GIST_DIM, t_gist["pair_evals"] - warm_pairs),
            (t_gbf, GIST_DIM, t_gbf["pair_evals"] - warm_pairs),
            (t_flat, HD_DIM, t_flat["pair_evals"])):
        t["kernel_pairs"] = pairs
        if t is t_gbf:
            # the tensor-core term (bf16 at Dp = D here), or the epilogue's
            tc, epi = pairs * 3 * 2 * GIST_DIM, pairs * 4
            yard = (max(tc / PEAK_BF16, epi / PEAK_F32),
                    max(tc / PEAK_BF16, epi / PEAK_F32_ISSUE))
            what = "bf16"
        else:
            ops = pairs * (3 * dim + 1)
            yard = (ops / PEAK_F32, ops / PEAK_F32_ISSUE)
            what = "f32"
        t["kernel_bounds"] = bounds(t["kernel_ms"], *yard, 0)
        say(f"  {what} D={dim}: kernel {t['kernel_ms']:.3f} ms on {pairs} "
            f"pairs (bucket rows x lanes): {bound_txt(t['kernel_bounds'])}")
    say("  phase 10c steps: " + ", ".join(f"{name} {sec:.1f} s"
                                          for name, sec in steps.items()))
    details["phase10c_step_seconds"] = steps

    # -- phase 11 -----------------------------------------------------------
    say(f"[phase 11] the high-D kernels' time at phase 10's shape")
    hd_timed = time_hd_kernels(hd, HD_K)
    say(f"  f32 ring plan: {hd_timed['f32']['plan']}")
    for mode, name in (("f32", "ring kernel"), ("bf16", "wgmma kernel")):
        r = hd_timed[mode]
        say(f"  {mode} ({name}): kernel {r['ms']:.3f} ms, {bound_txt(r)}, "
            f"visits {r['visits']}, plain {r['plain_ms']:.3f} ms on "
            f"{r['plain_shape']}, max_abs_err {r['max_abs_err']}")
    for mode, what in (("f32", "ring layouts"), ("bf16", "halves, norms")):
        say(f"  {mode} with the wrapper's preparation: "
            f"{hd_timed[mode]['wrapper_ms']:.3f} ms (preparation: {what}, "
            f"{hd_timed[mode]['prep_ms']:.3f} ms)")
    say(f"  shape {hd_timed['shape']}; bf16 on the "
        f"{hd_timed['bf16']['kernel']} kernel, W={hd_timed['bf16']['W']}, "
        f"ids of {hd_timed['bf16']['id_rows_differing_by_ties']} rows differ "
        "from f32 only among equally distant points")
    details["high_d_kernel_timing"] = hd_timed

    # -- phase 11b ----------------------------------------------------------
    say("[phase 11b] the ring kernel's streamed and flat routes and the "
        "wgmma kernel's streamed route at their first kernels' shapes")
    t0 = time.perf_counter()
    off_timed = time_offpath_kernels(hd)
    details["offpath_seconds"] = time.perf_counter() - t0
    for name, r in off_timed.items():
        say(f"  {name}: {r['shape']} kernel {r['ms']:.3f} ms "
            f"({r['wrapper_ms']:.3f} ms with its preparation), "
            f"{bound_txt(r)}, plain {r['plain_ms']:.3f} ms on "
            f"{r['plain_shape']}, max_abs_err {r['max_abs_err']}")
        say(f"    plan {r['plan']}")
        if "padded_tensor_flop" in r:
            say(f"    tensor-core FLOP {r['tensor_flop']:.4e} for D, "
                f"{r['padded_tensor_flop']:.4e} multiplied at Dp "
                f"({r['padded_tensor_flop'] / PEAK_BF16 * 1e3:.3f} ms at "
                "the peak)")
    say(f"  phase 11b took {details['offpath_seconds']:.1f} s")
    details["offpath_kernel_timing"] = off_timed

    # -- phase 13 -----------------------------------------------------------
    say("[phase 13] chunked queries, checkpoint and resume, the device "
        "merge")
    details["chunked"], chunk_runs = chunked_phases(pts_np, lst, auto8, sub,
                                                    d_sub)

    # -- phase 14 -----------------------------------------------------------
    say(f"[phase 14] the native out-of-core IO and a job the card runs only "
        f"in chunks: {N_BIG} points from one raw file, k={BIG_K}")
    details["out_of_core"], ooc_runs = out_of_core_phases(smi)

    # -- phase 15 -----------------------------------------------------------
    details["engines"], engine_runs = engine_phases(pts_path, sub)

    # -- phases 3f and 16 ---------------------------------------------------
    details["serving"], serve_runs = serving_phases(smi, pts_path,
                                                    WORK / "k8.float", hd)

    # -- phases 3g, 16s and 16t ---------------------------------------------
    details["tiers"], tier_runs = tiered_phases(smi)

    # -- phase 17 -----------------------------------------------------------
    details["multihost"], mh_runs = multihost_phases(
        smi, pts_path, WORK / "k8_r4.float", lst, auto8, pre)

    # -- phases 3h, 18 and 19 -----------------------------------------------
    rep_groups = []
    details["pod"], pod_counts, rep_started = routed_pod_phases(smi,
                                                                rep_groups)
    details["replicate_pod"], rep_counts = replicate_pod_phases(
        smi, rep_started, rep_groups)

    # -- phase 20 -----------------------------------------------------------
    details["tools"], tool_counts = tooling_phases(
        smi, details["serving"]["16a k=100 R=1"]["queries_per_second"], runs)

    # -- phase 12 -----------------------------------------------------------
    say("[phase 12] phase 10's f32 R=1 run again under the profiler")
    label = "f32 R=1 under the profiler"
    t, d, _ = unordered_run(label, hd, HD_K, 1, "f32",
                            profile_dir=str(WORK / "profile"))
    hd_runs[label] = t
    if d.tobytes() != ref_d.tobytes():
        fail(f"phase 12: {label}: distances differ from phase 10's")
    check_ring_route(f"phase 12: {label}", t)

    main_runs = list(runs.values()) + list(pre.values()) \
        + list(hd_runs.values()) + list(chunk_runs.values()) \
        + list(ooc_runs.values()) + list(engine_runs.values()) \
        + list(serve_runs.values()) + list(tier_runs.values()) \
        + list(mh_runs.values()) + [pod_counts, rep_counts, tool_counts]

    def launched(key):
        return sum(r.get(key, 0) for r in main_runs)

    def entry(name, source, replaces, launches, errs, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    # phase 15e: canonical_ties on the d3, ring and wgmma routes
    canon_err = details["engines"]["phase15e_max_abs_err"]
    # phase 3f: the served shapes, the point side resident
    served_err = details["serving"]["phase3f_max_abs_err"]
    # phase 3g: the slab engines' shapes; 3h: a routed host's
    slab_err = details["tiers"]["phase3g_max_abs_err"]
    routed_err = details["pod"]["phase3h_max_abs_err"]
    kernels = {"kernels": [
        # knn_tiled_d3_kernel, timed in phase 6
        entry("knn_tiled", SOURCE, REPLACES, launched("knn_tiled_d3_launches"),
              (details["phase3_max_abs_err"], timed[8]["max_abs_err"],
               timed[100]["max_abs_err"],
               details["out_of_core"]["witness_max_abs_err"], canon_err,
               served_err["d3"], slab_err, routed_err), timed[8]),
        entry("knn_tiled_nd_ring", SOURCE, RING_REPLACES,
              launched("knn_tiled_ring_launches"),
              (details["phase3c_max_abs_err"],
               hd_timed["f32"]["max_abs_err"], canon_err,
               served_err["ring"]), hd_timed["f32"]),
        # knn_bf_d3_kernel, timed in phase 9
        entry("knn_bf", BF_SOURCE, BF_REPLACES, launched("knn_bf_d3_launches"),
              (details["phase3b_max_abs_err"], bf_timed[8]["max_abs_err"],
               bf_timed[100]["max_abs_err"]), bf_timed[8]),
        # knn_tiled_wgmma_kernel with the query halves resident, timed in
        # phase 11
        entry("knn_tiled_mxu", MXU_SOURCE, MXU_REPLACES,
              launched("knn_tiled_wgmma_launches"),
              (details["phase3d_max_abs_err"],
               hd_timed["bf16"]["max_abs_err"], canon_err,
               served_err["wgmma"]), hd_timed["bf16"]),
        # the ring kernel's streamed traversal and its flat fold, timed in
        # phase 11b, launched by phase 10c's main paths
        entry("knn_tiled_nd_ring_stream", SOURCE, RING_REPLACES,
              launched("knn_tiled_stream_launches"),
              (details["phase3c_max_abs_err"],
               off_timed["knn_tiled_nd_ring_stream"]["max_abs_err"]),
              off_timed["knn_tiled_nd_ring_stream"]),
        entry("knn_bf_ring", SOURCE, BF_REPLACES,
              launched("knn_bf_ring_launches"),
              (details["phase3c_max_abs_err"],
               off_timed["knn_bf_ring"]["max_abs_err"]),
              off_timed["knn_bf_ring"]),
        # the same kernel with D streamed, timed in phase 11b, launched by
        # phase 10c's bf16 main path
        entry("knn_tiled_mxu_stream", MXU_SOURCE, MXU_REPLACES,
              launched("knn_tiled_wgmma_stream_launches"),
              (details["phase3d_max_abs_err"],
               off_timed["knn_tiled_mxu_stream"]["max_abs_err"]),
              off_timed["knn_tiled_mxu_stream"]),
    ]}
    # every kernel must have run on the main paths
    for kern in kernels["kernels"]:
        if kern["launches"] < 1 or kern["max_abs_err"] != 0.0:
            fail(f"{kern['name']}: {kern['launches']} launches, "
                 f"max_abs_err {kern['max_abs_err']}")
    details["kernels"] = kernels
    details["seconds"] = time.perf_counter() - t_start
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    details["phase_seconds"] = {name: end - t0 for (name, t0), end
                                in zip(PHASE_STARTS, ends)}
    say("phase seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in details["phase_seconds"].items()))
    (WORK / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    say(f"total {details['seconds']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
