// Device helpers shared by the port's kNN kernels.
//
// In the ring and tensor-core kernels one thread inserts into a candidate
// row, whose slots lie `bd` apart: column-major in shared memory
// ([slots][rows], so the threads' slot j is conflict-free), or in place in
// device memory (bd = 1). A row is sorted ascending; a new entry goes in after
// every entry <= it (existing entries win ties, then earlier lanes) and the
// last entry drops: strict-< adoption in lane order, the fold of the JAX
// package's TPU kernels.
//
// The D=3 kernels (knn_bf_d3_kernel, knn_tiled_d3_kernel) fold with a warp
// per row instead (the warp fold, below). What frees that design is the
// fold's contract: the sequential fold above leaves in a row exactly the k
// smallest entries of (the row as it came in) and (every lane scored),
// ordered by the key (d2, arrival), where the row's own entries arrive
// first, in row order, and lanes arrive in visit order. Any selection that
// yields those k entries in that order gives the same bits: d2 and ids,
// the inf pattern, -r slots of max_radius^2 that stay until something
// strictly closer arrives, and lanes that score +inf (PAD_SENTINEL points)
// or NaN (the wrappers' padding lanes), which are never adopted.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn {

// Insert (dd, id) into this thread's sorted row of `slots` entries; returns
// the row's new last value.
__device__ __forceinline__ float insert_sorted(float* cd2, int* cidx, int bd,
                                               int tid, int slots, float dd,
                                               int id) {
  int j = slots - 1;
  while (j > 0) {
    const float prev = cd2[(j - 1) * bd + tid];
    if (prev <= dd) break;
    cd2[j * bd + tid] = prev;
    cidx[j * bd + tid] = cidx[(j - 1) * bd + tid];
    --j;
  }
  cd2[j * bd + tid] = dd;
  cidx[j * bd + tid] = id;
  return cd2[(slots - 1) * bd + tid];
}

// ---------------------------------------------------------------------------
// The warp fold of the D=3 kernels.
//
// A warp folds kWarpRows query rows, whose coordinates and k-th d2 it keeps
// in registers, warp-uniform. A row's k slots lie across the warp's 32
// lanes in a warp-private stretch of shared memory: slot i = lane * S + s
// (S slots a lane, sorted across lanes) at row[s * 32 + lane],
// so a lane touches only its own column and no access meets a bank
// conflict. Points arrive staged in shared memory as float4 {x, y, z, id
// bits}, in chunks of kChunkLanes: each lane scores lanes lane + 32j of a
// chunk against all the warp's rows (9 FP32 issues a pair, no FMA: the
// bound of both kernels), keeping per row only the min of its scores. A row
// whose min is not below its k-th d2 (a register that only shrinks) adopts
// nothing from the chunk: one compare and one vote. Otherwise the warp goes
// over the chunk again for that row in lane order, takes the passing lanes
// lowest first, and inserts each with warp_insert: each lane counts its
// slots <= the new d2, one reduction gives the position, and the slots
// after it shift one place up, across lane borders with one shuffle. So
// the fold is the sequential one, lane by lane, with no serial chain
// through shared memory.
//
// Above kSlotsMaxK the kernels fold with the wide fold instead (below:
// knn_bf_d3_wide_kernel, knn_tiled_d3_wide_kernel).

constexpr int kWarpRows = 4;      // query rows a warp folds
constexpr int kChunkGroups = 8;   // lanes a thread scores per row a chunk
constexpr int kChunkLanes = 32 * kChunkGroups;
constexpr int kD3MaxThreads = 512;  // __launch_bounds__(512, 2): 64 registers
constexpr unsigned kFull = 0xffffffffu;
// the largest k of the instances of S slots a lane that the launch plans
// take (ops/knn_tiled.py D3_SLOTS_MAX_K): the first D=3 kernels' 903
constexpr int kSlotsMaxK = 903;

// Calls f(std::integral_constant<int, S>{}) for S = `slots`, the slots a
// lane holds for a row (ops/knn_tiled.py d3_slots: a power of two >= k/32,
// so the kernels have one instance each for S in 1, 2, 4, 8, 16, 32), and
// returns its result; `out_of_range` for any other S. Host code: the
// launchers dispatch on it.
template <class F>
int with_d3_slots(int slots, int out_of_range, F&& f) {
  switch (slots) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
  }
  return out_of_range;
}

// Exact d2 of a query against a point, ((dx*dx + dy*dy) + dz*dz) with
// correctly rounded, never contracted operations.
__device__ __forceinline__ float dist2_3(float qx, float qy, float qz,
                                         const float4& p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Inserts (dd, id) into the warp's row (rd2, ridx) of k entries after
// every entry <= dd; the last entry drops. The caller has checked dd < the
// row's k-th d2, so the position is below k. Returns the new k-th d2, which
// sits at rd2[kth_at] (kth_at = ((k-1) % S) * 32 + (k-1) / S). All 32 lanes
// call it with the same arguments.
template <int S>
__device__ __forceinline__ float warp_insert(float* rd2, int* ridx, int k,
                                             int kth_at, float dd, int id) {
  const int lane = threadIdx.x & 31;
  float v[S];
  int w[S];
  int c = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = rd2[s * 32 + lane];
    w[s] = ridx[s * 32 + lane];
    c += (lane * S + s < k && v[s] <= dd) ? 1 : 0;
  }
  const int pos = __reduce_add_sync(kFull, c);
  // the entry before this lane's first slot is the previous lane's last
  const float vu = __shfl_up_sync(kFull, v[S - 1], 1);
  const int wu = __shfl_up_sync(kFull, w[S - 1], 1);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = lane * S + s;
    if (i >= pos && i < k) {
      rd2[s * 32 + lane] = i == pos ? dd : (s ? v[s - 1] : vu);
      ridx[s * 32 + lane] = i == pos ? id : (s ? w[s - 1] : wu);
    }
  }
  __syncwarp();
  return rd2[kth_at];
}

// Folds the kChunkLanes lanes of `chunk` into one row of the warp, in lane
// order (lane j * 32 + l is the chunk's lane l of group j); kth is the
// row's k-th d2, updated.
template <int S>
__device__ __forceinline__ void fold_row_chunk(const float4* chunk, float qx,
                                               float qy, float qz, float* rd2,
                                               int* ridx, int k, int kth_at,
                                               float& kth) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int j = 0; j < kChunkGroups; ++j) {
    const float4 p = chunk[j * 32 + lane];
    const float dd = dist2_3(qx, qy, qz, p);
    unsigned m = __ballot_sync(kFull, dd < kth);
    while (m) {
      const int src = __ffs(m) - 1;
      const float val = __shfl_sync(kFull, dd, src);
      const int id = __shfl_sync(kFull, __float_as_int(p.w), src);
      kth = warp_insert<S>(rd2, ridx, k, kth_at, val, id);
      // the later lanes that still pass the new k-th
      m &= m - 1;
      m &= __ballot_sync(kFull, dd < kth);
    }
  }
}

// The warp's query rows: coordinates and k-th d2 (-inf for a row that
// folds nothing), the same in every lane.
struct WarpQueries {
  float x[kWarpRows], y[kWarpRows], z[kWarpRows], kth[kWarpRows];
};

// Folds the `nl` staged lanes of `tile` (a multiple of kChunkLanes) into
// the warp's rows, whose slots start at rd2 / ridx (row r at r * S * 32).
template <int S>
__device__ __forceinline__ void fold_tile(const float4* tile, int nl,
                                          WarpQueries& wq, float* rd2,
                                          int* ridx, int k, int kth_at) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < nl; c0 += kChunkLanes) {
    float mn[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) mn[r] = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kChunkGroups; ++j) {
      const float4 p = tile[c0 + j * 32 + lane];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
        mn[r] = fminf(mn[r], dist2_3(wq.x[r], wq.y[r], wq.z[r], p));
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
      if (__any_sync(kFull, mn[r] < wq.kth[r]))
        fold_row_chunk<S>(tile + c0, wq.x[r], wq.y[r], wq.z[r],
                          rd2 + r * S * 32, ridx + r * S * 32, k, kth_at,
                          wq.kth[r]);
  }
}

// Loads the warp's rows row0 .. row0 + kWarpRows - 1 of the [*, k] global
// rows into its slots and their k-th d2 into wq.kth; a row with
// valid[r] false is not loaded and gets -inf.
template <int S>
__device__ __forceinline__ void load_warp_rows(const float* d2, const int* idx,
                                               long long row0,
                                               const bool (&valid)[kWarpRows],
                                               float* rd2, int* ridx, int k,
                                               int kth_at, WarpQueries& wq) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
    if (valid[r])
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = lane * S + s;
        if (i < k) {
          rd2[(r * S + s) * 32 + lane] = d2[(row0 + r) * k + i];
          ridx[(r * S + s) * 32 + lane] = idx[(row0 + r) * k + i];
        }
      }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
    wq.kth[r] = valid[r] ? rd2[r * S * 32 + kth_at] : -CUDART_INF_F;
}

// Writes the warp's valid rows back to the [*, k] global rows.
template <int S>
__device__ __forceinline__ void store_warp_rows(float* d2, int* idx,
                                                long long row0,
                                                const bool (&valid)[kWarpRows],
                                                const float* rd2,
                                                const int* ridx, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
    if (valid[r])
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = lane * S + s;
        if (i < k) {
          d2[(row0 + r) * k + i] = rd2[(r * S + s) * 32 + lane];
          idx[(row0 + r) * k + i] = ridx[(r * S + s) * 32 + lane];
        }
      }
}

// ---------------------------------------------------------------------------
// The wide fold of the D=3 kernels, for k above kSlotsMaxK.
//
// Slot i of a row sits at row[i], in place in the [*, k] rows in device
// memory (a warp's 4 rows are consecutive there), so a block's rows take no
// shared memory and an SM holds 32 warps whatever k; in shared memory they
// would leave it one to six warps from k=904 on, which ran slower on the
// card at every such k tried. Each access of a merge step is one coalesced
// run of 32 slots, and a warp's rows stay in L1 and L2 while it folds them.
// The gate is the warp fold's. A passing lane is not inserted at once: each
// row keeps a pending buffer of up to 32 entries in registers (lane j holds
// entry j), filled in lane order against the row's k-th d2 as of its last
// merge (a superset of what the sequential fold adopts: its k-th only
// shrinks). The buffer is merged into the row when the next group of lanes
// would overflow it, and at the end: of the fold (the flat kernel) or of
// each staged tile (the traversal, so that a row's k-th d2 after a tile is
// the sequential fold's and the radius and visits stay the warp fold's). A merge sorts the buffer by (d2,
// arrival) (a bitonic sort across the lanes), walks the row from its end
// down, 32 slots a step and kWideSteps steps a round (their reads before
// their writes), moving each entry up by the number of pending entries
// strictly below it (row entries win ties) and noting where each pending
// entry lands, then writes the pending entries into the slots left free;
// whatever lands at k or beyond drops. That leaves the k smallest of (the
// row, then the lanes) by (d2, arrival): the sequential fold's bits. A
// merge costs O((k - p) / 32) steps, p the rank of its smallest entry, for
// up to 32 adoptions, where one insert of the warp fold costs that for one;
// a cold row (every lane passes) fills in k / 32 merges.

constexpr int kWideSteps = 4;  // 32-slot steps a merge round reads

// The number of entries of `sorted` (ascending across the warp's lanes,
// +inf past its end) below v (kLess), or at most v (!kLess): a binary
// search by shuffles, each lane for its own v.
template <bool kLess>
__device__ __forceinline__ int warp_rank(float sorted, float v) {
  int n = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1) {
    const float t = __shfl_sync(kFull, sorted, n + step - 1);
    if (kLess ? t < v : t <= v) n += step;
  }
  const float t = __shfl_sync(kFull, sorted, n);
  return (kLess ? t < v : t <= v) ? n + 1 : n;
}

// Sorts (d, key) ascending across the warp's lanes (keys distinct), id
// travelling with them.
__device__ __forceinline__ void warp_sort(float& d, int& key, int& id) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride; stride >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, stride);
      const int okey = __shfl_xor_sync(kFull, key, stride);
      const int oid = __shfl_xor_sync(kFull, id, stride);
      const bool other_less = od < d || (od == d && okey < key);
      // ascending runs of `size`: the lower lane of a pair keeps the less
      const bool lower = (lane & stride) == 0;
      const bool ascending = (lane & size) == 0;
      if (lower == ascending ? other_less : !other_less) {
        d = od;
        key = okey;
        id = oid;
      }
    }
}

// Merges the n pending entries (pd, pid: lane j holds entry j, in
// arrival order) into the warp's row (rd2, ridx) of k entries, as above.
// Every pending d2 is below the row's k-th. Returns the new k-th d2. All
// 32 lanes call it with the same row and n.
__device__ __forceinline__ float wide_merge(float* rd2, int* ridx, int k,
                                            float pd, int pid, int n) {
  const int lane = threadIdx.x & 31;
  float d = lane < n ? pd : CUDART_INF_F;
  int key = lane, id = pid;
  warp_sort(d, key, id);
  int rank = 0;  // this lane's pending entry: the row entries <= it
  int c = ((k - 1) >> 5) << 5;
  for (bool done = false; !done; c -= 32 * kWideSteps) {
    float v[kWideSteps];
    int w[kWideSteps];
#pragma unroll
    for (int g = 0; g < kWideSteps; ++g) {
      const int i = c - 32 * g + lane;
      const bool real = i >= 0 && i < k;
      v[g] = real ? rd2[i] : CUDART_INF_F;
      w[g] = real ? ridx[i] : -1;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kWideSteps; ++g) {
      if (!done) {
        const int i0 = c - 32 * g;
        const int i = i0 + lane;
        const int up = warp_rank<true>(d, v[g]);   // pending below v
        const int le = warp_rank<false>(v[g], d);  // step entries <= d
        if (le < 32) rank = i0 + le;
        if (i >= 0 && i < k && up && i + up < k) {
          rd2[i + up] = v[g];
          ridx[i + up] = w[g];
        }
        done = i0 <= 0 || __shfl_sync(kFull, up, 0) == 0;
      }
    }
  }
  __syncwarp();
  if (lane < n && lane + rank < k) {
    rd2[lane + rank] = d;
    ridx[lane + rank] = id;
  }
  __syncwarp();
  return rd2[k - 1];
}

// Folds the kChunkLanes lanes of `chunk` into one row of the warp through
// its pending buffer (pd, pid, pn), merging it first where a group of 32
// lanes would overflow it; kth is the row's k-th d2 as of its last merge.
__device__ __forceinline__ void fold_row_chunk_wide(
    const float4* chunk, float qx, float qy, float qz, float* rd2, int* ridx,
    int k, float& kth, float& pd, int& pid, int& pn) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int j = 0; j < kChunkGroups; ++j) {
    const float4 p = chunk[j * 32 + lane];
    const float dd = dist2_3(qx, qy, qz, p);
    unsigned m = __ballot_sync(kFull, dd < kth);
    if (pn + __popc(m) > 32) {
      kth = wide_merge(rd2, ridx, k, pd, pid, pn);
      pn = 0;
      m = __ballot_sync(kFull, dd < kth);
    }
    // pending slot pn + q takes the group's q-th passing lane
    const int src = __fns(m, 0, lane - pn + 1) & 31;
    const float val = __shfl_sync(kFull, dd, src);
    const int id = __shfl_sync(kFull, __float_as_int(p.w), src);
    if (lane >= pn && lane < pn + __popc(m)) {
      pd = val;
      pid = id;
    }
    pn += __popc(m);
  }
}

// The pending buffers of the warp's rows: row r's entries at lanes 0 ..
// n[r] - 1 of d[r] / id[r].
struct WidePending {
  float d[kWarpRows];
  int id[kWarpRows], n[kWarpRows];
};

__device__ __forceinline__ void wide_pending_init(WidePending& pend) {
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    pend.d[r] = 0.f;
    pend.id[r] = -1;
    pend.n[r] = 0;
  }
}

// Folds the `nl` staged lanes of `tile` (a multiple of kChunkLanes) into
// the warp's rows (row r at rd2 + r * k), each through its pending buffer.
__device__ __forceinline__ void fold_tile_wide(const float4* tile, int nl,
                                               WarpQueries& wq,
                                               WidePending& pend, float* rd2,
                                               int* ridx, int k) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < nl; c0 += kChunkLanes) {
    float mn[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) mn[r] = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kChunkGroups; ++j) {
      const float4 p = tile[c0 + j * 32 + lane];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
        mn[r] = fminf(mn[r], dist2_3(wq.x[r], wq.y[r], wq.z[r], p));
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
      if (__any_sync(kFull, mn[r] < wq.kth[r]))
        fold_row_chunk_wide(tile + c0, wq.x[r], wq.y[r], wq.z[r],
                            rd2 + r * k, ridx + r * k, k, wq.kth[r],
                            pend.d[r], pend.id[r], pend.n[r]);
  }
}

// Merges every non-empty pending buffer into its row: the traversal after
// each tile (its radius is the rows' k-th d2), the flat fold once at its
// end.
__device__ __forceinline__ void wide_flush(WarpQueries& wq, WidePending& pend,
                                           float* rd2, int* ridx, int k) {
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
    if (pend.n[r]) {
      wq.kth[r] = wide_merge(rd2 + r * k, ridx + r * k, k, pend.d[r],
                             pend.id[r], pend.n[r]);
      pend.n[r] = 0;
    }
}

// The k-th d2 of the warp's rows for the wide fold (row r at rd2 + r * k,
// in place), into wq.kth; -inf for a row with valid[r] false, which folds
// nothing.
__device__ __forceinline__ void wide_kth(const float* rd2, int k,
                                         const bool (&valid)[kWarpRows],
                                         WarpQueries& wq) {
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
    wq.kth[r] = valid[r] ? rd2[r * k + k - 1] : -CUDART_INF_F;
}

}  // namespace knn
