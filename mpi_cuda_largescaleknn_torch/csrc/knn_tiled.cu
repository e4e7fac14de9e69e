// Nearest-first bucketed kNN traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_cuda_largescaleknn_tpu/ops/pallas/knn_tiled.py
// (_kernel, launched by _run, wrapped by knn_update_tiled_pallas) together
// with its in-VMEM fold ops/pallas/knn_bf.py fold_tile_into_candidates.
//
// What it computes, for every query bucket b (rows b*S .. b*S+S-1):
//   walk the point buckets in the precomputed nearest-first order
//   (order[b], box distances boxd2[b], ascending); stop at the first bucket
//   whose box d2 is not strictly below the radius (the max over the real
//   query rows of their k-th candidate d2); skip bucket b / self_group when
//   skip_self is set; score every lane exactly as ((dx*dx + dy*dy) + dz*dz)
//   with correctly rounded, never contracted operations; adopt a lane into
//   the row's sorted candidate list when its d2 is strictly below the
//   row's k-th entry, inserted after every equal entry (existing entries
//   win ties, then lower lanes). That is exactly the TPU fold's result
//   (knn_bf.py: the extract-min passes equal lane-order insertion).
//
// Results do not depend on how finely the radius prunes: a bucket whose box
// d2 is at or beyond a row's k-th d2 holds no point that strict-< adoption
// could take. So each block keeps its own radius, refreshed after every
// visited bucket (the D=3 kernel: after every staged tile, deciding at
// bucket starts), and exits on its own; distances and ids stay those of the
// TPU kernel. Padding query rows (id < 0) fold nothing and come back as
// they went in. A bucket's visit count is the most any of its blocks
// scored (atomicMax): each block's radius is at most the bucket's, so the
// count is the plain version's when the bucket is one block, and at most
// it when its rows split over blocks.
//
// What bounds it on the H100: operations. Each scored pair is 3 sub, 3 mul,
// 2 add and a compare or min (9 FP32 issues, no FMA may fuse them), while
// the bytes are small: a query bucket reads its candidate rows once and
// each visited point bucket (496 lanes x 16 B at the 1M-point shape) from
// L2.
//
// knn_tiled_d3_kernel is built for that bound. Where the first D=3 kernel
// (one thread per query row, its k slots in shared memory as [k][threads])
// lost its time, and what this one does:
// - There a block held all 248 rows of a bucket up to k=100 (198 KB of
//   slots), one block of 8 warps an SM. Here a warp folds 4 rows whose
//   slots lie across its 32 lanes (knn_rows.cuh, the warp fold), a block
//   holds 8 warps (32 rows; blockIdx.y + y0 splits the bucket), and the plan
//   (ops/knn_tiled.py tiled_launch_plan) keeps at least two blocks on an
//   SM: 32 warps at k=100 (64 registers a thread).
// - There every adoption shifted the row one slot at a time through
//   shared memory, in divergent control flow, so a warp waited for its
//   longest shift (a few hundred adoptions a query at k=100). Here a
//   chunk's scores are gated by one compare of their min against the row's
//   k-th d2 (a warp-uniform register), and an adoption is one warp-parallel
//   insert: a count, a reduction, a shuffle, no chain. A row no lane has
//   entered yet (the warm start's cold rows, ops/knn_tiled.py
//   warm_start_self_cuda: each bucket's one visit of itself) takes a chunk
//   by one sort of its keys instead of an insert a lane, in the instance
//   the launcher takes for cold rows.
// - There a pair cost a shared-memory load besides its 9 issues; here one
//   float4 load feeds the warp's 4 rows.
// - There each visited bucket was staged through registers between two
//   barriers, and the radius took two more. Here the wrapper lays the point
//   buckets out once per launch as float4 {x, y, z, id bits}, padded to
//   whole 256-lane chunks with NaN lanes (never adopted); one thread
//   bulk-copies the next tile of the walk (cp.async.bulk on an mbarrier,
//   bulk_ring.cuh; the next bucket is copied before the prune has decided
//   on it) while the block folds this one; and each warp adds its rows'
//   largest k-th d2 to a shared atomicMax on the float bits (d2 >= 0), so
//   one barrier a tile both frees the other buffer and settles the radius.
// - There k stopped at 903, where a block's rows filled its shared
//   memory. knn_tiled_d3_wide_kernel takes every k above knn::kSlotsMaxK
//   with the wide fold (knn_rows.cuh): a row in its own order, in place in
//   device memory, its adoptions buffered in shared memory and merged up
//   to kWideBuffer at a time, its warps reading their lanes themselves and
//   meeting only where a prune decision needs the block's radius.
//
// Points of any other dimension D go through knn_tiled_nd_ring_kernel: the
// same walk, prune and fold, with each pair scored left to right over all
// D components. Each pair is sum_i (q_i - p_i)^2, uncontracted, so it is 3
// FP32 issues per component (385 at D=128) and no tensor core can help:
// arithmetic bounds it harder still, and a visited bucket (496 lanes x 512
// B at D=128) no longer fits in shared memory. What the kernel does:
// - A block's 128 query rows sit in shared memory, and each consumer
//   thread holds a register tile of 8 rows x 4 lanes (rows rg + 16i, lanes
//   lg + 16j), so per group of 4 components it loads 8 + 4 float4 and
//   issues 384 FP32 operations; a half-warp shares its rows (broadcast)
//   and reads 16 consecutive lanes, so no load meets a bank conflict.
// - The wrapper lays the points out once per launch as chunks of 64 lanes,
//   each component-major ([Dp4/4][64] float4) and contiguous, lanes past T
//   NaN (their d2 is NaN, never adopted); one producer thread keeps a ring
//   of 2-3 stages full with cp.async.bulk on full/empty mbarriers, running
//   ahead along the walk, so the next chunk's copy overlaps this chunk's
//   arithmetic (the pattern of knn_tiled_mxu.cu). The tail of a bucket
//   rounds up to 64 lanes (T=496 pads to 512, 3%).
// - Up to Dp4 = 224 (ops/knn_tiled.py RESIDENT_MAX_DP4) the queries are
//   resident: copied once, beside a ring of whole chunks. Above it they and
//   a 2-stage ring no longer fit in 227 KB, so D is streamed: every stage
//   carries one slice of G float4 groups of a chunk (G*64 float4) and the
//   same slice of the block's queries (G*128 float4), the producer walks
//   (chunk, slice) pairs, and the register tile persists over a chunk's
//   slices, which go in ascending order: each d2 keeps the tree of
//   elementwise_dist2, bit for bit. The queries are then read again for
//   every chunk, from L2: 4/(3*64) bytes per FP32 issue against the
//   points' 4/(3*128), about 1 TB/s at the full issue rate.
// The fold is gated: after a chunk (its last slice) each thread compares
// its 32 scores with its rows' k-th values (copies that only shrink, so a
// failing lane could never be adopted). A row's 64 lanes lie in one
// half-warp, so when a warp holds a passing lane the half-warp merges its
// masks into one 64-bit lane mask per row, pops it lowest lane first, and
// shuffles each score to the row's inserting thread (lg == i), which
// inserts strict-< into the row: lane order, the bits of every other fold.
// Rows sit in shared memory where they fit beside the ring, else in place
// in device memory, so any k runs.
//
// The flat engine's fold at D != 3 (ops/knn_bf.py) is this kernel too: a
// traversal with one query bucket of every row (all real) and one point
// bucket of every point, visited once.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "bulk_ring.cuh"
#include "knn_rows.cuh"

namespace {

// kFlatEntry: the instance for cold rows (the warm start's), which enters
// a flat row by a sort (knn_rows.cuh enter_flat_row_chunk); the traversal's
// instance keeps the insert-only fold, whose registers the sort's call
// would crowd into spills.
template <int S, bool kFlatEntry>
__global__ void __launch_bounds__(knn::kD3MaxThreads, 2) knn_tiled_d3_kernel(
    const int* __restrict__ order,     // [Bq, Bp] nearest-first bucket ids
    const float* __restrict__ boxd2,   // [Bq, Bp] ascending box d2
    const float* __restrict__ q_pts,   // [Bq, S, 3]
    const int* __restrict__ q_ids,     // [Bq, S]
    const float4* __restrict__ p4,     // [Bp, t_pad] {x, y, z, id bits}
    float* __restrict__ d2,            // [Bq*S, k] in/out, ascending rows
    int* __restrict__ idx,             // [Bq*S, k] in/out
    int* __restrict__ visits,          // [Bq] buckets scored, max over blocks
    int s_q, int num_pb, int t_pad, int k, int skip_self, int self_group,
    int tile_lanes, int y0) {
  using knn::kWarpRows;
  extern __shared__ __align__(16) unsigned char sbuf[];
  const int rows = (blockDim.x >> 5) * kWarpRows;
  float4* tiles = reinterpret_cast<float4*>(sbuf);                // [2][lanes]
  float* rd2 = reinterpret_cast<float*>(tiles + 2 * tile_lanes);  // [rows][S][32]
  int* ridx = reinterpret_cast<int*>(rd2 + rows * S * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(ridx + rows * S * 32);  // [2]
  // the block's radius, as float bits: tile n's atomics go to red[(n+1)%3],
  // read after the next barrier; red[(n+2)%3] is cleared meanwhile
  int* red = reinterpret_cast<int*>(full + 2);  // [3]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  const int pieces = (t_pad + tile_lanes - 1) / tile_lanes;
  // the schedule position after v that the walk scores (skip_self masks
  // the own bucket out)
  auto next_pos = [&](int v) {
    ++v;
    while (v < num_pb && skip_self && ord[v] == own) ++v;
    return v;
  };
  // tile n of the walk (piece c of the bucket at position v) goes to
  // buffer n & 1 and completes on full[n & 1]
  auto issue = [&](int v, int c, int n) {
    const int l0 = c * tile_lanes;
    const uint32_t bytes = (uint32_t)min(tile_lanes, t_pad - l0) * 16u;
    knn::mbar_expect_tx(full + (n & 1), bytes);
    knn::bulk_load(tiles + (n & 1) * tile_lanes,
                   p4 + (long long)ord[v] * t_pad + l0, bytes, full + (n & 1));
  };
  if (tid == 0) {
    knn::mbar_init(full, 1);
    knn::mbar_init(full + 1, 1);
    red[0] = red[1] = red[2] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int v = next_pos(-1);
  if (tid == 0 && v < num_pb) issue(v, 0, 0);

  // in the bucket: a launch of more than 65,535 blocks of rows goes in
  // pieces, each starting at block y0 (ops/knn_tiled.py grid_y_pieces)
  const int r0 = (blockIdx.y + y0) * rows + warp * kWarpRows;
  const long long row0 = (long long)b * s_q + r0;
  float* wd2 = rd2 + warp * kWarpRows * S * 32;
  int* widx = ridx + warp * kWarpRows * S * 32;
  const int kth_at = ((k - 1) % S) * 32 + (k - 1) / S;
  bool valid[kWarpRows];
  knn::WarpQueries wq;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const long long row = row0 + r;
    valid[r] = r0 + r < s_q && q_ids[row] >= 0;
    wq.x[r] = valid[r] ? q_pts[row * 3 + 0] : 0.f;
    wq.y[r] = valid[r] ? q_pts[row * 3 + 1] : 0.f;
    wq.z[r] = valid[r] ? q_pts[row * 3 + 2] : 0.f;
  }
  knn::load_warp_rows<S>(d2, idx, row0, valid, wd2, widx, k, kth_at, wq);
  // the largest k-th d2 of the warp's rows, as float bits (0 when none
  // folds: no box d2 is below it)
  auto radius_bits = [&]() {
    float m = 0.f;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) m = fmaxf(m, wq.kth[r]);
    return __float_as_int(m);
  };
  if (lane == 0) atomicMax(red, radius_bits());

  int n = 0;  // tiles scored
  int c = 0;  // piece of the bucket at position v
  int nvis = 0;
  while (v < num_pb) {
    // every warp is done with tile n-1 (its buffer is free) and has added
    // its radius to red[n % 3]
    __syncthreads();
    const float worst = __int_as_float(red[n % 3]);
    if (tid == 0) red[(n + 2) % 3] = 0;
    // ascending box d2 and a radius that only shrinks: nothing later can
    // be adopted either
    if (c == 0 && !(bx[v] < worst)) break;
    int vn = v, cn = c + 1;
    if (cn == pieces) {
      vn = next_pos(v);
      cn = 0;
    }
    if (tid == 0 && vn < num_pb) issue(vn, cn, n + 1);
    knn::mbar_wait(full + (n & 1), (n >> 1) & 1);
    knn::fold_tile<S, kFlatEntry>(tiles + (n & 1) * tile_lanes,
                                  min(tile_lanes, t_pad - c * tile_lanes),
                                  wq, wd2, widx, k, kth_at);
    if (lane == 0) atomicMax(red + (n + 1) % 3, radius_bits());
    if (cn == 0) ++nvis;
    v = vn;
    c = cn;
    ++n;
  }
  // the walk stopped at a bucket whose first tile was already copied: it
  // lands before the block exits
  if (tid == 0 && v < num_pb) knn::mbar_wait(full + (n & 1), (n >> 1) & 1);
  knn::store_warp_rows<S>(d2, idx, row0, valid, wd2, widx, k);
  if (tid == 0 && nvis) atomicMax(visits + b, nvis);
}

// A float bound (or a count) tagged with the decision (or flush) it
// belongs to, so that an atomicMax keeps the latest tag's largest value:
// d2 >= 0, whose bits order as the floats do.
__device__ __forceinline__ unsigned long long tagged_bits(int tag,
                                                          unsigned bits) {
  return (unsigned long long)(unsigned)tag << 32 | bits;
}

__device__ __forceinline__ unsigned long long tagged(int tag, float v) {
  return tagged_bits(tag, __float_as_uint(v));
}

__device__ __forceinline__ float untagged(unsigned long long t) {
  return __uint_as_float((unsigned)t);
}

template <class T>
__device__ __forceinline__ T shared_read(const T* p) {
  return *const_cast<const volatile T*>(p);
}

// decisions whose radius bounds the wide traversal holds at once: a warp
// publishing bounds waits for the block's slowest warp to be within this
// many buckets of it
constexpr int kWideSlots = 32;

// knn_tiled_d3_kernel with the wide fold (knn_rows.cuh) for k above
// knn::kSlotsMaxK: the same walk and prune, the rows folded in place in
// d2 / idx through pending buffers in shared memory.
//
// No tile is staged: each warp reads its lanes from the point buckets in
// device memory (a shard's buckets stay in L2, and each block walks its
// own stretch of them), so no warp waits for another to finish a tile.
// A block's warps meet only where a prune decision needs them.
//
// A row's buffer outlives the bucket, so the block's radius (the largest
// exact k-th d2 of its rows) is known only between two bounds: a warp's
// rows' k-th d2 as of their last merges (an upper bound) and their
// (k - n)-th entries, n pending (a lower bound; wide_bounds, from the
// rows' tails in shared memory). At a bucket's start a warp whose own
// lower bound is above the box d2 visits at once (the radius is at least
// that) and says so to the block. Any other publishes its bounds and
// waits for such a warp, or for every warp's bounds: a box d2 below the
// block's lower bound visits and one at or above its upper bound stops,
// whatever the merges give; only one between them has every warp (each is
// then waiting there) merge its buffers and the block decide on the exact
// radius. So the decisions, the radius the block exits on and the visits
// are the warp fold's, bit for bit.
__global__ void __launch_bounds__(knn::kD3MaxThreads, 1)
    knn_tiled_d3_wide_kernel(
    const int* __restrict__ order,     // [Bq, Bp] nearest-first bucket ids
    const float* __restrict__ boxd2,   // [Bq, Bp] ascending box d2
    const float* __restrict__ q_pts,   // [Bq, S, 3]
    const int* __restrict__ q_ids,     // [Bq, S]
    const float4* __restrict__ p4,     // [Bp, t_pad] {x, y, z, id bits}
    float* __restrict__ d2,            // [Bq*S, k] in/out, ascending rows
    int* __restrict__ idx,             // [Bq*S, k] in/out
    int* __restrict__ visits,          // [Bq] buckets scored, max over blocks
    int s_q, int num_pb, int t_pad, int k, int skip_self, int self_group,
    int tile_lanes, int y0) {
  using knn::kFull;
  using knn::kWarpRows;
  constexpr int kSteps = knn::kWideStepsTraversal;
  extern __shared__ __align__(16) unsigned char sbuf[];
  const int warps = blockDim.x >> 5;
  const int rows = warps * kWarpRows;
  // [warps][kWideWarpBytes + kWideTailBytes]: buffers, then rows' tails
  constexpr int kWarpBytes = knn::kWideWarpBytes + knn::kWideTailBytes;
  unsigned char* wide = sbuf;
  // the bounds published for decision q, tagged q, in slot q % kWideSlots,
  // and how many warps published them (the count tagged q)
  unsigned long long* lower =
      reinterpret_cast<unsigned long long*>(wide + warps * kWarpBytes);
  unsigned long long* upper = lower + kWideSlots;
  unsigned long long* posted = upper + kWideSlots;
  // the exact radius after the f-th lazy flush, tagged f
  unsigned long long* exact = posted + kWideSlots;
  // the last decision each warp is past
  int* at = reinterpret_cast<int*>(exact + 1);  // [kD3MaxThreads / 32]
  // the last decision a warp's own rows settled (a visit), by slot
  int* visit = at + knn::kD3MaxThreads / 32;
  // warps done with the lazy flushes
  unsigned* flushed = reinterpret_cast<unsigned*>(visit + kWideSlots);
  static_assert(kWideSlots * 24 + 8 + knn::kD3MaxThreads / 32 * 4 +
                        kWideSlots * 4 + 4 <=
                    knn::kWideCtrlBytes,
                "the decisions' slots fit their shared memory");

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  const int pieces = (t_pad + tile_lanes - 1) / tile_lanes;
  // the schedule position after v that the walk scores (skip_self masks
  // the own bucket out)
  auto next_pos = [&](int v) {
    ++v;
    while (v < num_pb && skip_self && ord[v] == own) ++v;
    return v;
  };
  if (tid == 0) {
    for (int s = 0; s < kWideSlots; ++s) {
      lower[s] = upper[s] = posted[s] = 0ull;
      visit[s] = -1;
    }
    for (int w = 0; w < warps; ++w) at[w] = -1;
    *exact = 0ull;
    *flushed = 0;
  }
  __syncthreads();

  // in the bucket: a launch of more than 65,535 blocks of rows goes in
  // pieces, each starting at block y0 (ops/knn_tiled.py grid_y_pieces)
  const int r0 = (blockIdx.y + y0) * rows + warp * kWarpRows;
  const long long row0 = (long long)b * s_q + r0;
  float* wd2 = d2 + row0 * k;
  int* widx = idx + row0 * k;
  const knn::WideWarp ww = knn::wide_warp(wide + warp * kWarpBytes, true);
  bool valid[kWarpRows];
  knn::WarpQueries wq;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const long long row = row0 + r;
    valid[r] = r0 + r < s_q && q_ids[row] >= 0;
    wq.x[r] = valid[r] ? q_pts[row * 3 + 0] : 0.f;
    wq.y[r] = valid[r] ? q_pts[row * 3 + 1] : 0.f;
    wq.z[r] = valid[r] ? q_pts[row * 3 + 2] : 0.f;
    if (valid[r]) knn::wide_keep_tail(wd2 + r * k, k, knn::wide_tail(ww, r));
  }
  knn::wide_kth(wd2, k, valid, wq);
  int pn[kWarpRows] = {};  // entries pending in each row's buffer
  // decision q on the bucket whose box d2 is `box`: 1 visit, -1 stop, 2 the
  // exact radius decides (every warp is then here). Lane 0 decides.
  auto decide = [&](int q, float box) {
    const float2 bnd = knn::wide_bounds(ww, pn, wq);
    const int s = q % kWideSlots;
    if (box < bnd.x) {
      atomicMax(visit + s, q);
      return 1;
    }
    // publish this warp's bounds once every warp is past the decision
    // that last used the slot
    for (int w = 0; w < warps; ++w)
      while (shared_read(at + w) < q - kWideSlots) __nanosleep(64);
    atomicMax(lower + s, tagged(q, bnd.x));
    atomicMax(upper + s, tagged(q, bnd.y));
    __threadfence_block();
    for (unsigned long long old = shared_read(posted + s);;) {
      const unsigned long long want =
          (int)(old >> 32) == q ? old + 1 : tagged_bits(q, 1u);
      const unsigned long long seen = atomicCAS(posted + s, old, want);
      if (seen == old) break;
      old = seen;
    }
    // a warp that visits on its own rows (it may be past this decision
    // already), or every warp's bounds
    for (;;) {
      if (shared_read(visit + s) >= q) return 1;
      if (shared_read(posted + s) == tagged_bits(q, warps)) {
        __threadfence_block();
        return box < untagged(shared_read(lower + s))      ? 1
               : !(box < untagged(shared_read(upper + s))) ? -1
                                                           : 2;
      }
      __nanosleep(32);
    }
  };

  int q = 0;  // decisions made: buckets visited
  int v = next_pos(-1);
  int c = 0;  // piece of the bucket at position v
  int f = 0;  // lazy flushes
  while (v < num_pb) {
    if (c == 0) {
      // ascending box d2 and a radius that only shrinks: nothing later
      // can be adopted either
      int verdict = lane == 0 ? decide(q, bx[v]) : 0;
      verdict = __shfl_sync(kFull, verdict, 0);
      if (verdict == 2) {
        knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);
        ++f;
        if (lane == 0) {
          float m = 0.f;
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) m = fmaxf(m, wq.kth[r]);
          atomicMax(exact, tagged(f, m));
          __threadfence_block();
          atomicAdd(flushed, 1u);
          while (shared_read(flushed) < (unsigned)warps * f) __nanosleep(32);
          __threadfence_block();
          verdict = bx[v] < untagged(shared_read(exact)) ? 1 : -1;
        }
        verdict = __shfl_sync(kFull, verdict, 0);
      }
      if (lane == 0) *const_cast<volatile int*>(at + warp) = q;
      if (verdict < 0) break;
    }
    knn::fold_tile_wide<kSteps>(
        p4 + (long long)ord[v] * t_pad + c * tile_lanes,
        min(tile_lanes, t_pad - c * tile_lanes), wq, pn, wd2, widx, k, ww);
    if (++c == pieces) {
      v = next_pos(v);
      c = 0;
      ++q;
    }
  }
  knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);
  if (tid == 0 && q) atomicMax(visits + b, q);
}

// ---------------------------------------------------------------------------
// knn_tiled_nd_ring_kernel

constexpr int kRingRows = 128;       // query rows a block
constexpr int kRingLanes = 64;       // point lanes a chunk
constexpr int kRingConsumers = 256;  // 8 consumer warps
constexpr int kRingThreads = kRingConsumers + 32;  // and one producer warp
constexpr int kRingMaxStages = 3;
// A half-warp's 16 threads share one row group rg and hold lanes lg + 16j;
// a thread's rows are rg + kRowGroups*i.
constexpr int kRowGroups = kRingConsumers / 16;
constexpr int kTR = kRingRows / kRowGroups;  // rows of a thread's tile
constexpr int kTL = kRingLanes / 16;         // lanes of it

__device__ __forceinline__ float add_sq(float acc, float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// acc[i][j] += d2 terms of query row rg + kRowGroups*i against chunk lane
// lg + 16j, over `groups` groups of 4 components in order. q_s is
// [groups][128], p_s [groups][64], both float4.
__device__ __forceinline__ void score_groups(float (&acc)[kTR][kTL],
                                             const float4* q_s,
                                             const float4* p_s, int groups,
                                             int rg, int lg) {
#pragma unroll 2
  for (int d4 = 0; d4 < groups; ++d4) {
    const float4* pp = p_s + d4 * kRingLanes + lg;
    const float4* qq = q_s + d4 * kRingRows + rg;
    float4 p[kTL];
#pragma unroll
    for (int j = 0; j < kTL; ++j) p[j] = pp[16 * j];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float4 q = qq[kRowGroups * i];
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        float a = add_sq(acc[i][j], q.x, p[j].x);
        a = add_sq(a, q.y, p[j].y);
        a = add_sq(a, q.z, p[j].z);
        acc[i][j] = add_sq(a, q.w, p[j].w);
      }
    }
  }
}

// acc[i][j] = d2 of query row rg + kRowGroups*i against chunk lane
// lg + 16j, over all d4n groups of 4 components in order (resident
// queries).
__device__ __forceinline__ void score_chunk(float (&acc)[kTR][kTL],
                                            const float4* q_s,
                                            const float4* p_s, int d4n,
                                            int rg, int lg) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) acc[i][j] = 0.f;
  score_groups(acc, q_s, p_s, d4n, rg, lg);
}

// Bytes of one ring stage: a whole chunk (resident queries), or one slice
// of `slice_groups` float4 groups of a chunk and of the block's queries.
__host__ __device__ __forceinline__ uint32_t ring_stage_bytes(
    int d4n, int slice_groups) {
  return slice_groups ? (uint32_t)slice_groups * (kRingRows + kRingLanes) * 16
                      : (uint32_t)d4n * kRingLanes * 16;
}

// kStream = false: the queries resident in shared memory, a stage holds a
// chunk. kStream = true: a stage holds slice sl of a chunk and of the
// queries, groups [sl*slice_groups, ...) of the d4n, the queries first,
// the points slice_groups*128 float4 after them.
template <bool kStream>
__global__ void __launch_bounds__(kRingThreads, 1) knn_tiled_nd_ring_kernel(
    const int* __restrict__ order,       // [Bq, Bp] nearest-first bucket ids
    const float* __restrict__ boxd2,     // [Bq, Bp] ascending box d2
    const float4* __restrict__ q_ring,   // [Bq, S_pad/128, Dp4/4, 128]
    const int* __restrict__ q_ids,       // [Bq, S]
    const float4* __restrict__ p_ring,   // [Bp, T_pad/64, Dp4/4, 64]
    const int* __restrict__ p_ids,       // [Bp, T]
    float* d2,                           // [Bq*S, k] in/out, ascending rows
    int* idx,                            // [Bq*S, k] in/out
    int* __restrict__ visits,            // [Bq] buckets scored, max over blocks
    int s_q, int s_pad, int num_pb, int t_p, int t_pad, int d4n, int k,
    int skip_self, int self_group, int stages, int rows_in_smem,
    int slice_groups, int y0) {
  extern __shared__ __align__(128) unsigned char sbuf[];
  const uint32_t qbytes = kStream ? 0u : kRingRows * d4n * 16;  // resident
  const uint32_t sbytes = ring_stage_bytes(d4n, kStream ? slice_groups : 0);
  const int nsl = kStream ? (d4n + slice_groups - 1) / slice_groups : 1;
  const float4* q_s = reinterpret_cast<const float4*>(sbuf);
  unsigned char* ring = sbuf + qbytes;
  const int row_slots = rows_in_smem ? k * kRingRows : 0;
  float* cd2 = reinterpret_cast<float*>(ring + stages * sbytes);  // [k][128]
  int* cidx = reinterpret_cast<int*>(cd2 + row_slots);            // [k][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(cidx + row_slots);
  uint64_t* empty = full + kRingMaxStages;
  uint64_t* qbar = empty + kRingMaxStages;
  float* red = reinterpret_cast<float*>(qbar + 1);  // [2][consumer warps]
  volatile int* stop =
      reinterpret_cast<volatile int*>(red + kRingConsumers / 16);

  const int b = blockIdx.x;
  const int yb = blockIdx.y + y0;  // the block of rows in the bucket
  const int r0 = yb * kRingRows;
  const int nrows = min(kRingRows, s_q - r0);
  const int tid = threadIdx.x;
  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  const int nch = t_pad / kRingLanes;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      knn::mbar_init(full + s, 1);
      knn::mbar_init(empty + s, kRingConsumers / 32);  // one arrival a warp
    }
    knn::mbar_init(qbar, 1);
    *stop = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kRingConsumers) {
    // The producer: one thread copies the block's resident queries, then
    // walks the consumers' schedule without the prune and keeps the ring
    // full until they stop it; stage n holds chunk n (resident) or the
    // n-th (chunk, slice) pair (streamed).
    if (tid != kRingConsumers) return;
    // the block's queries, [d4n][128]
    const float4* q_blk =
        q_ring + ((long long)b * (s_pad / kRingRows) + yb) *
                     kRingRows * d4n;
    if (!kStream) {
      knn::mbar_expect_tx(qbar, qbytes);
      knn::bulk_load(sbuf, q_blk, qbytes, qbar);
    }
    int n = 0;  // stages issued
    for (int v = 0; v < num_pb && !*stop; ++v) {
      const int pb = ord[v];
      if (skip_self && pb == own) continue;
      for (int c = 0; c < nch; ++c) {
        const float4* chunk = p_ring + ((long long)pb * nch + c)
                                           * kRingLanes * d4n;
        for (int sl = 0; sl < nsl; ++sl, ++n) {
          const int s = n % stages;
          if (n >= stages) {  // wait until every consumer warp released it
            const uint32_t parity = (n / stages - 1) & 1;
            while (!knn::mbar_try_wait(empty + s, parity))
              if (*stop) goto drain;
          }
          if (*stop) goto drain;
          unsigned char* st = ring + s * sbytes;
          if (kStream) {
            const int g0 = sl * slice_groups;
            const int g = min(slice_groups, d4n - g0);
            knn::mbar_expect_tx(full + s, g * (kRingRows + kRingLanes) * 16);
            knn::bulk_load(st, q_blk + g0 * kRingRows, g * kRingRows * 16,
                           full + s);
            knn::bulk_load(st + slice_groups * kRingRows * 16,
                           chunk + g0 * kRingLanes, g * kRingLanes * 16,
                           full + s);
          } else {
            knn::mbar_expect_tx(full + s, sbytes);
            knn::bulk_load(st, chunk, sbytes, full + s);
          }
        }
      }
    }
  drain:
    // every copy issued lands before the block exits
    if (!kStream) knn::mbar_wait(qbar, 0);
    for (int s = 0; s < stages && s < n; ++s)
      knn::mbar_wait(full + s, ((n - 1 - s) / stages) & 1);
    return;
  }

  // The consumers: thread (rg, lg) scores rows rg + kRowGroups*i against
  // lanes lg + 16j of each chunk; rows rg belong to one half-warp.
  const int lane = tid & 31;
  const int lg = lane & 15;
  const int half = lane & 16;  // first lane of this half-warp
  const int rg = tid >> 4;
  const long long row0 = (long long)b * s_q + r0;
  const long long base = row0 * k;
  const int rstride = rows_in_smem ? kRingRows : 1;
  auto row_d2 = [&](int r) {
    return rows_in_smem ? cd2 + r : d2 + (row0 + r) * k;
  };
  auto row_idx = [&](int r) {
    return rows_in_smem ? cidx + r : idx + (row0 + r) * k;
  };
  if (rows_in_smem)
    for (int e = tid; e < nrows * k; e += kRingConsumers) {
      const int r = e / k;
      const int j = e - r * k;
      cd2[j * kRingRows + r] = d2[base + e];
      cidx[j * kRingRows + r] = idx[base + e];
    }
  knn::consumer_sync<kRingConsumers>();
  // each row's k-th d2 (-inf for rows that fold nothing); only the row's
  // inserting thread (lg == i) holds it exactly, the others a copy that is
  // never below it
  float kth[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg + kRowGroups * i;
    const bool valid = r < nrows && q_ids[row0 + r] >= 0;
    kth[i] = valid ? row_d2(r)[(k - 1) * rstride] : -CUDART_INF_F;
  }
  auto rows_max = [&]() {
    float m = kth[0];
#pragma unroll
    for (int i = 1; i < kTR; ++i) m = fmaxf(m, kth[i]);
    return m;
  };
  int parity = 0;
  float worst = knn::consumer_max<kRingConsumers>(rows_max(), red, parity);
  if (!kStream) knn::mbar_wait(qbar, 0);

  // The lanes of a chunk that passed the gate (bit kTL*i + j of m), adopted
  // row by row in lane order; pos0 is the chunk's first lane in p_ids.
  auto adopt = [&](const float (&acc)[kTR][kTL], uint32_t m, long long pos0) {
    uint64_t u[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      uint64_t x = 0ull;
#pragma unroll
      for (int j = 0; j < kTL; ++j)
        x |= (uint64_t)((m >> (kTL * i + j)) & 1u) << (16 * j + lg);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        x |= __shfl_xor_sync(0xffffffffu, x, off);
      u[i] = x;
    }
    auto pending = [&]() {
      uint64_t any = 0ull;
#pragma unroll
      for (int i = 0; i < kTR; ++i) any |= u[i];
      return any != 0ull;
    };
    while (__any_sync(0xffffffffu, pending())) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const bool has = u[i] != 0ull;
        const int col = has ? __ffsll((long long)u[i]) - 1 : 0;
        u[i] &= u[i] - 1ull;
        const int jc = col >> 4;
        float mine = acc[i][0];
#pragma unroll
        for (int j = 1; j < kTL; ++j)
          if (j == jc) mine = acc[i][j];
        const float val = __shfl_sync(0xffffffffu, mine, half | (col & 15));
        if (has && lg == i && val < kth[i]) {
          const int r = rg + kRowGroups * i;
          kth[i] = knn::insert_sorted(row_d2(r), row_idx(r), rstride, 0, k,
                                      val, p_ids[pos0 + col]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i)
      kth[i] = __shfl_sync(0xffffffffu, kth[i], half | i);
  };

  int n = 0;  // stages consumed
  int nvis = 0;
  for (int v = 0; v < num_pb; ++v) {
    // ascending box d2 and a radius that only shrinks: nothing later can
    // be adopted either
    if (!(bx[v] < worst)) break;
    const int pb = ord[v];
    if (skip_self && pb == own) continue;
    const long long lane0 = (long long)pb * t_p;
    for (int c = 0; c < nch; ++c) {
      float acc[kTR][kTL];
      if (kStream) {
        // the chunk's slices in ascending order into one tile
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTL; ++j) acc[i][j] = 0.f;
        for (int sl = 0; sl < nsl; ++sl, ++n) {
          const int s = n % stages;
          knn::mbar_wait(full + s, (n / stages) & 1);
          const float4* st =
              reinterpret_cast<const float4*>(ring + s * sbytes);
          score_groups(acc, st, st + slice_groups * kRingRows,
                       min(slice_groups, d4n - sl * slice_groups), rg, lg);
          __syncwarp();
          if (lane == 0) knn::mbar_arrive(empty + s);
        }
      } else {
        const int s = n % stages;
        knn::mbar_wait(full + s, (n / stages) & 1);
        score_chunk(acc, q_s,
                    reinterpret_cast<const float4*>(ring + s * sbytes), d4n,
                    rg, lg);
        __syncwarp();
        if (lane == 0) knn::mbar_arrive(empty + s);
        ++n;
      }
      uint32_t m = 0u;
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTL; ++j)
          m |= (uint32_t)(acc[i][j] < kth[i]) << (kTL * i + j);
      if (__any_sync(0xffffffffu, m != 0u))
        adopt(acc, m, lane0 + (long long)c * kRingLanes);
    }
    ++nvis;
    parity ^= 1;
    worst = knn::consumer_max<kRingConsumers>(rows_max(), red, parity);
  }
  if (tid == 0) *stop = 1;
  knn::consumer_sync<kRingConsumers>();
  if (rows_in_smem)
    for (int e = tid; e < nrows * k; e += kRingConsumers) {
      const int r = e / k;
      const int j = e - r * k;
      d2[base + e] = cd2[j * kRingRows + r];
      idx[base + e] = cidx[j * kRingRows + r];
    }
  if (tid == 0 && nvis) atomicMax(visits + b, nvis);
}

// Dynamic shared memory of knn_tiled_nd_ring_kernel (ops/knn_tiled.py
// ring_smem_bytes computes the same).
size_t ring_smem(int dp4, int k, int stages, int rows_in_smem,
                 int slice_groups) {
  return (slice_groups ? 0 : (size_t)kRingRows * dp4 * 4) +
         (size_t)stages * ring_stage_bytes(dp4 / 4, slice_groups) +
         (rows_in_smem ? (size_t)k * kRingRows * 8 : 0) + 256;
}

template <bool kStream>
int ring_launch(const int* order, const float* boxd2, const float* q_ring,
                const int* q_ids, const float* p_ring, const int* p_ids,
                float* d2, int* idx, int* visits, int num_qb, int s_q,
                int s_pad, int num_pb, int t_p, int t_pad, int dp4, int k,
                int skip_self, int self_group, int stages, int rows_in_smem,
                int slice_groups, int y0, int ny, size_t smem,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_tiled_nd_ring_kernel<kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, ny);
  knn_tiled_nd_ring_kernel<kStream><<<grid, kRingThreads, smem, stream>>>(
      order, boxd2, reinterpret_cast<const float4*>(q_ring), q_ids,
      reinterpret_cast<const float4*>(p_ring), p_ids, d2, idx, visits, s_q,
      s_pad, num_pb, t_p, t_pad, dp4 / 4, k, skip_self, self_group, stages,
      rows_in_smem, slice_groups, y0);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches knn_tiled_nd_ring_kernel on `stream` over the ny blocks of 128
// rows of each bucket from block y0 (a bucket of more than 65,535 such
// blocks, the grid's y limit, goes in several launches): with the queries
// resident when slice_groups is 0, else with D streamed in slices of
// slice_groups float4 groups. Returns the CUDA error code of the launch
// (0 = ok), or cudaErrorInvalidValue for a shape it does not take (Dp4 not
// a multiple of 4, S_pad not of 128, T_pad not of 64, a ring of other than
// 2 or 3 stages, or a piece [y0, y0 + ny) empty, above 65,535 blocks or
// past the bucket).
extern "C" int knn_tiled_nd_ring_launch(
    const int* order, const float* boxd2, const float* q_ring,
    const int* q_ids, const float* p_ring, const int* p_ids, float* d2,
    int* idx, int* visits, int num_qb, int s_q, int s_pad, int num_pb,
    int t_p, int t_pad, int dp4, int k, int skip_self, int self_group,
    int stages, int rows_in_smem, int slice_groups, int y0, int ny,
    void* stream) {
  if (dp4 % 4 || s_pad % kRingRows || t_pad % kRingLanes || stages < 2 ||
      stages > kRingMaxStages || slice_groups < 0 || y0 < 0 || ny < 1 ||
      ny > knn::kMaxGridY || y0 + ny > s_pad / kRingRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ring_smem(dp4, k, stages, rows_in_smem, slice_groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return slice_groups
             ? ring_launch<true>(order, boxd2, q_ring, q_ids, p_ring, p_ids,
                                 d2, idx, visits, num_qb, s_q, s_pad, num_pb,
                                 t_p, t_pad, dp4, k, skip_self, self_group,
                                 stages, rows_in_smem, slice_groups, y0, ny,
                                 smem, st)
             : ring_launch<false>(order, boxd2, q_ring, q_ids, p_ring, p_ids,
                                  d2, idx, visits, num_qb, s_q, s_pad, num_pb,
                                  t_p, t_pad, dp4, k, skip_self, self_group,
                                  stages, rows_in_smem, 0, y0, ny, smem, st);
}

namespace {

// Sets a D=3 kernel's shared-memory attribute and launches it over the ny
// blocks of rows of each query bucket from block y0.
template <class Kernel>
int tiled_launch(Kernel kernel, const int* order, const float* boxd2,
                 const float* q_pts, const int* q_ids, const float4* p4,
                 float* d2, int* idx, int* visits, int num_qb, int s_q,
                 int num_pb, int t_pad, int k, int skip_self, int self_group,
                 int threads, int tile_lanes, int y0, int ny, size_t smem,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, ny);
  kernel<<<grid, threads, smem, stream>>>(
      order, boxd2, q_pts, q_ids, p4, d2, idx, visits, s_q, num_pb, t_pad, k,
      skip_self, self_group, tile_lanes, y0);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus a CUDA error.
template <class Kernel>
int tiled_blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Launches knn_tiled_d3_kernel on `stream` with the plan of ops/knn_tiled.py
// tiled_launch_plan: `slots` a lane for a row of k (d3_slots), or 0 for
// knn_tiled_d3_wide_kernel (k above knn::kSlotsMaxK, its rows in place in
// d2 / idx); `threads` a block
// (4 query rows a warp), point buckets of t_pad lanes (a multiple of 256)
// staged in tiles of `tile_lanes` (a multiple of 256; the wide kernel
// stages none and reads that many lanes a step), `smem` bytes of
// dynamic shared memory (d3_smem_bytes), over the ny blocks of rows of each
// bucket from block y0 (a bucket of more than 65,535 blocks, the grid's y
// limit, goes in several launches); with `cold_rows` (rows no lane has
// entered, the warm start's) on slots a lane the instance that enters a
// flat row by a sort, the same bits. Returns the CUDA error code of the
// launch (0 = ok), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int knn_tiled_launch(
    const int* order, const float* boxd2, const float* q_pts,
    const int* q_ids, const float* p4, float* d2, int* idx, int* visits,
    int num_qb, int s_q, int num_pb, int t_pad, int k, int skip_self,
    int self_group, int slots, int cold_rows, int threads, int tile_lanes,
    int smem, int y0, int ny, void* stream) {
  if (threads % 32 || threads > knn::kD3MaxThreads || threads < 32 ||
      tile_lanes % knn::kChunkLanes || t_pad % knn::kChunkLanes || k < 1 ||
      (slots ? k > 32 * slots || k > knn::kSlotsMaxK
             : k <= knn::kSlotsMaxK))
    return (int)cudaErrorInvalidValue;
  const int rows = threads / 32 * knn::kWarpRows;
  if (y0 < 0 || ny < 1 || ny > knn::kMaxGridY ||
      y0 + ny > (s_q + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  const float4* p = reinterpret_cast<const float4*>(p4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    return tiled_launch(kernel, order, boxd2, q_pts, q_ids, p, d2, idx,
                        visits, num_qb, s_q, num_pb, t_pad, k, skip_self,
                        self_group, threads, tile_lanes, y0, ny,
                        (size_t)smem, st);
  };
  if (slots == 0) return launch(knn_tiled_d3_wide_kernel);
  return knn::with_d3_slots(slots, (int)cudaErrorInvalidValue, [&](auto s) {
    return cold_rows ? launch(knn_tiled_d3_kernel<decltype(s)::value, true>)
                     : launch(knn_tiled_d3_kernel<decltype(s)::value, false>);
  });
}

// Blocks of knn_tiled_d3_kernel (or, with slots 0, knn_tiled_d3_wide_kernel)
// an SM holds at this plan (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus a CUDA error.
extern "C" int knn_tiled_blocks_per_sm(int slots, int threads, int smem) {
  if (slots == 0)
    return tiled_blocks_per_sm(knn_tiled_d3_wide_kernel, threads,
                               (size_t)smem);
  return knn::with_d3_slots(slots, -(int)cudaErrorInvalidValue, [&](auto s) {
    return tiled_blocks_per_sm(
        knn_tiled_d3_kernel<decltype(s)::value, false>, threads,
        (size_t)smem);
  });
}
