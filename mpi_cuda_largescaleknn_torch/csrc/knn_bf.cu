// Flat brute-force kNN fold for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_cuda_largescaleknn_tpu/ops/pallas/knn_bf.py
// (_kernel, launched by _run, wrapped by knn_update_pallas): the flat
// engine "pallas", the analogue of the reference's runQuery launch.
//
// What it computes: every point of the resident shard is folded into each
// query's persistent sorted top-k row. Each pair is scored exactly as
// ((dx*dx + dy*dy) + dz*dz) with correctly rounded, never contracted
// operations; a point is adopted only when its d2 is strictly below the
// row's k-th entry, and is inserted after every equal entry, so existing
// entries win ties, then lower lanes, over the point tiles in ascending
// order. That is the TPU kernel's result with one fold segment; sentinel
// points (1e30 coordinates) score +inf and are never adopted, and slots
// holding max_radius^2 stay until something strictly closer arrives. Ids
// are read from point_ids directly (the TPU kernel stored lane positions
// and decoded them afterwards, which only Mosaic needed).
//
// What bounds it on the H100: operations. A pair is about 9 FP32 operations
// (3 sub, 3 mul, 2 add, a compare against a register; no FMA may fuse
// them), so the flat path's 10^12 pairs at 1M points need 134 ms at the
// card's 67 TFLOP/s, while the bytes are small: the point set (16 MB
// staged as float4) is re-read once per block of query rows, mostly from
// L2. The design keeps the pair loop on registers and one broadcast
// shared-memory load per lane: one thread per query row, a block of rows
// whose candidate columns sit in shared memory column-major ([k][threads],
// so each thread's slot j is conflict-free) with the row's k-th value cached
// in a register, so the rare insertion is the only shared-memory traffic of
// the fold; the point set is staged tile by tile in shared memory as float4
// {x, y, z, id bits}, and one loop over all tiles inside the block replaces
// the TPU grid's sequential point axis.
//
// Points of any other dimension D go through knn_bf_nd_kernel, exact f32
// at every D like the TPU kernel (which has no matmul-form branch): the
// same fold, each pair scored left to right over all D components, the
// point tile staged as zero-padded float4 rows with the ids beside them,
// and each thread keeping 32 lanes' partial sums in registers while its
// query row streams in as float4 from a component-major copy (coalesced
// across the block's rows); knn_rows.cuh score_fold_nd.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_rows.cuh"

namespace {

__global__ void knn_bf_kernel(
    const float* __restrict__ q_pts,   // [nq, 3]
    const float* __restrict__ p_pts,   // [np, 3]
    const int* __restrict__ p_ids,     // [np]
    float* __restrict__ d2,            // [nq, k] in/out, ascending rows
    int* __restrict__ idx,             // [nq, k] in/out
    int nq, int np, int k, int tile_lanes) {
  extern __shared__ float4 smem[];
  const int bd = blockDim.x;
  float4* tile = smem;                                          // [tile_lanes]
  float* cd2 = reinterpret_cast<float*>(smem + tile_lanes);     // [k][bd]
  int* cidx = reinterpret_cast<int*>(cd2 + (size_t)k * bd);     // [k][bd]

  const long long row0 = (long long)blockIdx.x * bd;
  const int nrows = (int)min((long long)bd, (long long)nq - row0);
  const int tid = threadIdx.x;
  const long long base = row0 * k;

  // this block's rows are contiguous in global memory: coalesced staging
  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    cd2[j * bd + r] = d2[base + e];
    cidx[j * bd + r] = idx[base + e];
  }
  const bool active = tid < nrows;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const long long row = row0 + tid;
    qx = q_pts[row * 3 + 0];
    qy = q_pts[row * 3 + 1];
    qz = q_pts[row * 3 + 2];
  }
  __syncthreads();
  float kth = active ? cd2[(k - 1) * bd + tid] : -CUDART_INF_F;

  for (int l0 = 0; l0 < np; l0 += tile_lanes) {
    const int nl = min(tile_lanes, np - l0);
    __syncthreads();  // every thread is done with the previous tile
    for (int l = tid; l < nl; l += bd) {
      const float* p = p_pts + (long long)(l0 + l) * 3;
      tile[l] = make_float4(p[0], p[1], p[2], __int_as_float(p_ids[l0 + l]));
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int l = 0; l < nl; ++l) {
        const float4 p = tile[l];
        const float dx = __fsub_rn(qx, p.x);
        const float dy = __fsub_rn(qy, p.y);
        const float dz = __fsub_rn(qz, p.z);
        const float dd = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (dd < kth) {
          // sorted insert after every entry <= dd; the old k-th drops
          int j = k - 1;
          while (j > 0) {
            const float prev = cd2[(j - 1) * bd + tid];
            if (prev <= dd) break;
            cd2[j * bd + tid] = prev;
            cidx[j * bd + tid] = cidx[(j - 1) * bd + tid];
            --j;
          }
          cd2[j * bd + tid] = dd;
          cidx[j * bd + tid] = __float_as_int(p.w);
          kth = cd2[(k - 1) * bd + tid];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    d2[base + e] = cd2[j * bd + r];
    idx[base + e] = cidx[j * bd + r];
  }
}

__global__ void knn_bf_nd_kernel(
    const float4* __restrict__ q_t,    // [d4n, nq] component groups
    const float* __restrict__ p_pts,   // [np, D]
    const int* __restrict__ p_ids,     // [np]
    float* __restrict__ d2,            // [nq, k] in/out, ascending rows
    int* __restrict__ idx,             // [nq, k] in/out
    int nq, int np, int dim, int k, int tile_lanes) {
  extern __shared__ float4 smem[];
  const int bd = blockDim.x;
  const int d4n = (dim + 3) >> 2;
  float4* tile = smem;                                     // [lanes][d4n]
  int* tile_ids = reinterpret_cast<int*>(smem + (size_t)tile_lanes * d4n);
  float* cd2 = reinterpret_cast<float*>(tile_ids + tile_lanes);  // [k][bd]
  int* cidx = reinterpret_cast<int*>(cd2 + (size_t)k * bd);      // [k][bd]

  const long long row0 = (long long)blockIdx.x * bd;
  const int nrows = (int)min((long long)bd, (long long)nq - row0);
  const int tid = threadIdx.x;
  const long long base = row0 * k;

  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    cd2[j * bd + r] = d2[base + e];
    cidx[j * bd + r] = idx[base + e];
  }
  const bool active = tid < nrows;
  const float4* qcol = q_t + row0 + tid;
  __syncthreads();
  float kth = active ? cd2[(k - 1) * bd + tid] : -CUDART_INF_F;

  for (int l0 = 0; l0 < np; l0 += tile_lanes) {
    const int nl = min(tile_lanes, np - l0);
    __syncthreads();  // every thread is done with the previous tile
    knn::stage_tile_nd(tile, tile_ids, p_pts, p_ids, l0, nl, dim, d4n);
    __syncthreads();
    if (active)
      for (int ls = 0; ls < nl; ls += knn::kLaneBlock)
        knn::score_fold_nd(tile, tile_ids, ls, nl, d4n, qcol, nq, cd2, cidx,
                           bd, tid, k, kth);
  }
  __syncthreads();
  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    d2[base + e] = cd2[j * bd + r];
    idx[base + e] = cidx[j * bd + r];
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
extern "C" int knn_bf_nd_launch(const float4* q_t, const float* p_pts,
                                const int* p_ids, float* d2, int* idx, int nq,
                                int np, int dim, int k, int threads,
                                int tile_lanes, void* stream) {
  const size_t smem = (size_t)tile_lanes * (((dim + 3) >> 2) * sizeof(float4)
                                            + sizeof(int)) +
                      (size_t)k * threads * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_bf_nd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)(((long long)nq + threads - 1) / threads);
  knn_bf_nd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      q_t, p_pts, p_ids, d2, idx, nq, np, dim, k, tile_lanes);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
extern "C" int knn_bf_launch(const float* q_pts, const float* p_pts,
                             const int* p_ids, float* d2, int* idx, int nq,
                             int np, int k, int threads, int tile_lanes,
                             void* stream) {
  const size_t smem = (size_t)tile_lanes * sizeof(float4) +
                      (size_t)k * threads * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_bf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)(((long long)nq + threads - 1) / threads);
  knn_bf_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      q_pts, p_pts, p_ids, d2, idx, nq, np, k, tile_lanes);
  return (int)cudaGetLastError();
}
