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

constexpr int kWarpRows = 4;      // query rows a warp folds
constexpr int kChunkGroups = 8;   // lanes a thread scores per row a chunk
constexpr int kChunkLanes = 32 * kChunkGroups;
constexpr int kD3MaxThreads = 512;  // __launch_bounds__(512, 2): 64 registers
constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace knn
