// Device helpers shared by the port's kNN kernels.
//
// Candidate rows live in shared memory column-major ([slots][threads], one
// row per thread), so a thread's slot j is conflict-free. A row is sorted
// ascending; a new entry goes in after every entry <= it (existing entries
// win ties, then earlier lanes) and the last entry drops: strict-<
// adoption in lane order, the fold of the JAX package's TPU kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn {

// Max over the block of v; every thread returns the same value.
// blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_max(float v, float* warp_buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // warp_buf is free again after the previous call
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? warp_buf[lane] : -CUDART_INF_F;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

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

// Lanes one thread scores at once in the general-D f32 kernels: their
// partial sums stay in registers while the components stream by.
constexpr int kLaneBlock = 32;

// Stage lanes [l0, l0 + nl) of a [lanes, dim] f32 point block into
// `tile` as [nl][d4n] float4 rows zero-padded to 4*d4n components, and
// their ids into `tile_ids`. One warp per lane, its threads along the
// components: coalesced reads, no division.
__device__ __forceinline__ void stage_tile_nd(
    float4* tile, int* tile_ids, const float* __restrict__ pts,
    const int* __restrict__ ids, long long l0, int nl, int dim, int d4n) {
  float* tf = reinterpret_cast<float*>(tile);
  const int dp = 4 * d4n;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < nl; l += nwarps) {
    const float* p = pts + (l0 + l) * dim;
    for (int d = lane; d < dp; d += 32)
      tf[l * dp + d] = d < dim ? p[d] : 0.f;
    if (lane == 0) tile_ids[l] = ids[l0 + l];
  }
}

// Exact d2 of this thread's query row against tile lanes
// [ls, ls + kLaneBlock), folded in lane order (lanes >= nl are skipped).
// Each d2 is sum_i (q_i - p_i)^2 left to right with correctly rounded,
// never contracted operations: the tree of the plain elementwise_dist2
// (zero padding components add +0 and change nothing). The query's
// component group d4 is qcol[d4 * qstride].
__device__ __forceinline__ void score_fold_nd(
    const float4* tile, const int* tile_ids, int ls, int nl, int d4n,
    const float4* __restrict__ qcol, long long qstride, float* cd2,
    int* cidx, int bd, int tid, int k, float& kth) {
  float acc[kLaneBlock];
#pragma unroll
  for (int j = 0; j < kLaneBlock; ++j) acc[j] = 0.f;
  for (int d4 = 0; d4 < d4n; ++d4) {
    const float4 q = qcol[d4 * qstride];
#pragma unroll
    for (int j = 0; j < kLaneBlock; ++j) {
      const float4 p = tile[(ls + j) * d4n + d4];
      float d = __fsub_rn(q.x, p.x);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
      d = __fsub_rn(q.y, p.y);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
      d = __fsub_rn(q.z, p.z);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
      d = __fsub_rn(q.w, p.w);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
    }
  }
  const int nj = nl - ls;
#pragma unroll
  for (int j = 0; j < kLaneBlock; ++j)
    if (j < nj && acc[j] < kth)
      kth = insert_sorted(cd2, cidx, bd, tid, k, acc[j], tile_ids[ls + j]);
}

}  // namespace knn
