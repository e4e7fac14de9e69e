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
// visited bucket, and exits on its own; distances and ids stay those of the
// TPU kernel. Padding query rows (id < 0) fold nothing and come back as
// they went in. A bucket's visit count is the most any of its blocks
// scored (atomicMax): each block's radius is at most the bucket's, so the
// count is the plain version's when the bucket is one block, and at most
// it when its rows split over blocks.
//
// What bounds it on the H100: arithmetic. Each scored pair is 3 sub, 3 mul,
// 2 add and a compare against a register (no FMA may fuse them), while the
// bytes are small: a query bucket reads its candidate rows once and each
// visited point bucket (496 lanes x 16 B at the 1M-point shape) from L2.
// The design keeps the pair loop on registers and one broadcast shared-
// memory load per lane: one block per query bucket (blockIdx.y splits the
// rows when k is large), one thread per query row, the visited bucket
// staged in shared memory as float4 {x, y, z, id bits}, the candidate rows
// in shared memory column-major ([k][threads], so each thread's slot j is
// conflict-free) with the row's k-th value cached in a register, so the
// rare insertion is the only shared-memory traffic of the fold.
//
// Points of any other dimension D go through knn_tiled_nd_kernel: the same
// walk, prune and fold, with each pair scored left to right over all D
// components. At D=128 a pair is 384 FP32 operations, so arithmetic bounds
// it harder still; a visited bucket no longer fits in shared memory (496
// lanes x 512 B), so it is staged in tiles of lanes zero-padded to a
// multiple of 4 components, and each thread keeps 32 lanes' partial sums
// in registers while it streams its query row (read as float4 from a
// component-major copy, coalesced across the block's rows) against
// float4 broadcast loads of the tile: one shared-memory load per 12 FP32
// operations (4 components of one pair).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_rows.cuh"

namespace {

using knn::block_max;

__global__ void knn_tiled_kernel(
    const int* __restrict__ order,     // [Bq, Bp] nearest-first bucket ids
    const float* __restrict__ boxd2,   // [Bq, Bp] ascending box d2
    const float* __restrict__ q_pts,   // [Bq, S, 3]
    const int* __restrict__ q_ids,     // [Bq, S]
    const float* __restrict__ p_pts,   // [Bp, T, 3]
    const int* __restrict__ p_ids,     // [Bp, T]
    float* __restrict__ d2,            // [Bq*S, k] in/out, ascending rows
    int* __restrict__ idx,             // [Bq*S, k] in/out
    int* __restrict__ visits,          // [Bq] buckets scored, max over blocks
    int s_q, int num_pb, int t_p, int k, int skip_self, int self_group,
    int rows_per_block, int tile_lanes) {
  extern __shared__ float4 smem[];
  __shared__ float warp_buf[32];
  const int bd = blockDim.x;
  float4* tile = smem;                                          // [tile_lanes]
  float* cd2 = reinterpret_cast<float*>(smem + tile_lanes);     // [k][bd]
  int* cidx = reinterpret_cast<int*>(cd2 + (size_t)k * bd);     // [k][bd]

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int nrows = min(rows_per_block, s_q - r0);
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * s_q + r0;
  const long long base = row0 * k;

  // this block's rows are contiguous in global memory: coalesced staging
  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    cd2[j * bd + r] = d2[base + e];
    cidx[j * bd + r] = idx[base + e];
  }
  bool valid = false;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (tid < nrows) {
    const long long row = row0 + tid;
    valid = q_ids[row] >= 0;
    qx = q_pts[row * 3 + 0];
    qy = q_pts[row * 3 + 1];
    qz = q_pts[row * 3 + 2];
  }
  __syncthreads();
  float kth = valid ? cd2[(k - 1) * bd + tid] : -CUDART_INF_F;
  float worst = block_max(kth, warp_buf);

  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  int nvis = 0;
  for (int v = 0; v < num_pb; ++v) {
    // ascending box d2 and a radius that only shrinks: nothing later can
    // be adopted either
    if (!(bx[v] < worst)) break;
    const int pb = ord[v];
    if (skip_self && pb == own) continue;
    const float* pp = p_pts + (long long)pb * t_p * 3;
    const int* pid = p_ids + (long long)pb * t_p;
    for (int l0 = 0; l0 < t_p; l0 += tile_lanes) {
      const int nl = min(tile_lanes, t_p - l0);
      __syncthreads();  // every thread is done with the previous tile
      for (int l = tid; l < nl; l += bd) {
        const float* p = pp + (long long)(l0 + l) * 3;
        tile[l] = make_float4(p[0], p[1], p[2], __int_as_float(pid[l0 + l]));
      }
      __syncthreads();
      if (valid) {
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
    ++nvis;
    worst = block_max(valid ? kth : -CUDART_INF_F, warp_buf);
  }
  __syncthreads();
  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    d2[base + e] = cd2[j * bd + r];
    idx[base + e] = cidx[j * bd + r];
  }
  if (tid == 0 && nvis) atomicMax(visits + b, nvis);
}

__global__ void knn_tiled_nd_kernel(
    const int* __restrict__ order,     // [Bq, Bp] nearest-first bucket ids
    const float* __restrict__ boxd2,   // [Bq, Bp] ascending box d2
    const float4* __restrict__ q_t,    // [Bq, d4n, S] component groups
    const int* __restrict__ q_ids,     // [Bq, S]
    const float* __restrict__ p_pts,   // [Bp, T, D]
    const int* __restrict__ p_ids,     // [Bp, T]
    float* __restrict__ d2,            // [Bq*S, k] in/out, ascending rows
    int* __restrict__ idx,             // [Bq*S, k] in/out
    int* __restrict__ visits,          // [Bq] buckets scored, max over blocks
    int s_q, int num_pb, int t_p, int dim, int k, int skip_self,
    int self_group, int rows_per_block, int tile_lanes) {
  extern __shared__ float4 smem[];
  __shared__ float warp_buf[32];
  const int bd = blockDim.x;
  const int d4n = (dim + 3) >> 2;
  float4* tile = smem;                                     // [lanes][d4n]
  int* tile_ids = reinterpret_cast<int*>(smem + (size_t)tile_lanes * d4n);
  float* cd2 = reinterpret_cast<float*>(tile_ids + tile_lanes);  // [k][bd]
  int* cidx = reinterpret_cast<int*>(cd2 + (size_t)k * bd);      // [k][bd]

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int nrows = min(rows_per_block, s_q - r0);
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * s_q + r0;
  const long long base = row0 * k;

  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    cd2[j * bd + r] = d2[base + e];
    cidx[j * bd + r] = idx[base + e];
  }
  const bool valid = tid < nrows && q_ids[row0 + tid] >= 0;
  const float4* qcol = q_t + (long long)b * d4n * s_q + r0 + tid;
  __syncthreads();
  float kth = valid ? cd2[(k - 1) * bd + tid] : -CUDART_INF_F;
  float worst = block_max(kth, warp_buf);

  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  int nvis = 0;
  for (int v = 0; v < num_pb; ++v) {
    if (!(bx[v] < worst)) break;
    const int pb = ord[v];
    if (skip_self && pb == own) continue;
    const long long lane0 = (long long)pb * t_p;
    for (int l0 = 0; l0 < t_p; l0 += tile_lanes) {
      const int nl = min(tile_lanes, t_p - l0);
      __syncthreads();  // every thread is done with the previous tile
      knn::stage_tile_nd(tile, tile_ids, p_pts, p_ids, lane0 + l0, nl, dim,
                         d4n);
      __syncthreads();
      if (valid)
        for (int ls = 0; ls < nl; ls += knn::kLaneBlock)
          knn::score_fold_nd(tile, tile_ids, ls, nl, d4n, qcol, s_q, cd2,
                             cidx, bd, tid, k, kth);
    }
    ++nvis;
    worst = block_max(valid ? kth : -CUDART_INF_F, warp_buf);
  }
  __syncthreads();
  for (int e = tid; e < nrows * k; e += bd) {
    const int r = e / k;
    const int j = e - r * k;
    d2[base + e] = cd2[j * bd + r];
    idx[base + e] = cidx[j * bd + r];
  }
  if (tid == 0 && nvis) atomicMax(visits + b, nvis);
}

}  // namespace

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
extern "C" int knn_tiled_nd_launch(
    const int* order, const float* boxd2, const float4* q_t,
    const int* q_ids, const float* p_pts, const int* p_ids, float* d2,
    int* idx, int* visits, int num_qb, int s_q, int num_pb, int t_p,
    int dim, int k, int skip_self, int self_group, int rows_per_block,
    int threads, int tile_lanes, void* stream) {
  const size_t smem = (size_t)tile_lanes * (((dim + 3) >> 2) * sizeof(float4)
                                            + sizeof(int)) +
                      (size_t)k * threads * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_tiled_nd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, (s_q + rows_per_block - 1) / rows_per_block);
  knn_tiled_nd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      order, boxd2, q_t, q_ids, p_pts, p_ids, d2, idx, visits, s_q, num_pb,
      t_p, dim, k, skip_self, self_group, rows_per_block, tile_lanes);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
extern "C" int knn_tiled_launch(
    const int* order, const float* boxd2, const float* q_pts,
    const int* q_ids, const float* p_pts, const int* p_ids, float* d2,
    int* idx, int* visits, int num_qb, int s_q, int num_pb, int t_p, int k,
    int skip_self, int self_group, int rows_per_block, int threads,
    int tile_lanes, void* stream) {
  const size_t smem = (size_t)tile_lanes * sizeof(float4) +
                      (size_t)k * threads * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, (s_q + rows_per_block - 1) / rows_per_block);
  knn_tiled_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      order, boxd2, q_pts, q_ids, p_pts, p_ids, d2, idx, visits, s_q, num_pb,
      t_p, k, skip_self, self_group, rows_per_block, tile_lanes);
  return (int)cudaGetLastError();
}
