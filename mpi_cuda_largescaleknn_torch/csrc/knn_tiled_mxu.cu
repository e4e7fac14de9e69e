// Nearest-first bucketed kNN traversal with matmul-form scores on the
// tensor cores, for Hopper (sm_90a).
//
// Replaces the score_mxu branch of the TPU kernel
// mpi_cuda_largescaleknn_tpu/ops/pallas/knn_tiled.py (_kernel, lines
// 135-160, with its wrapper knn_update_tiled_pallas, lines 385-523):
// score_dtype="bf16" at D >= mxu_min_dim().
//
// What it computes, for every query bucket b (rows b*S .. b*S+S-1), with
// candidate rows widened to W = rescore_width(k, lanes) slots:
//   walk the point buckets in the nearest-first order and prune exactly as
//   csrc/knn_tiled.cu does, against each row's LAST (W-th) slot, with the
//   same skip_self / self_group mask; score each lane approximately as
//       (|q|^2 + |p|^2) - 2 * cross,  cross = qh.ph + qh.pl + ql.ph
//   (bf16 halves of the f32 coordinates, f32 accumulation; |q|^2 and |p|^2
//   exact f32); adopt a lane by strict-< into the widened row after every
//   equal entry, recording its flat position -2 - (pb*T + lane) in place
//   of its id. Then, per row, rescore every adopted entry exactly (the
//   f32 kernels' left-to-right tree, so the same bits), decode its id, and
//   sort the row stably by d2. Entries carried in keep their ids and exact
//   d2. The caller slices the rows back to k. The result equals the exact
//   kernel's whenever each row's true top k lie inside its survivor window.
//
// What bounds it on the H100: the tensor cores. The cross term is 3*2*Dp
// bf16 FLOP per scored pair (Dp = D rounded up to 16, zero columns add
// nothing) against a handful of FP32 operations of the epilogue per pair.
// The design is the simple one: one block per (query bucket, slice of
// rows), one thread per row and one warp per 32 rows; the block's query
// halves are staged once in shared memory, each visited bucket is staged
// in chunks of 16*NCT lanes (halves and |p|^2), each warp multiplies its
// two 16-row tiles by the chunk with nvcuda::wmma 16x16x16 bf16 fragments,
// stores the f32 cross terms column-major to its own shared-memory slab,
// and each thread then folds its row's scores in lane order. Rows of
// shared memory are padded by 8 bf16 so fragment loads spread over banks.
// wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "knn_rows.cuh"

namespace {

using namespace nvcuda;

constexpr int kT = 16;  // wmma tile: m = n = k = 16

// Copy `n` rows of `dp` bf16 from global (row stride dp) to shared memory
// (row stride ldq) as 16-byte words, zero-filling rows >= nvalid.
__device__ __forceinline__ void stage_bf16_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int n,
    int nvalid, int dp, int ldq) {
  const int words = dp / 8;
  for (int e = threadIdx.x; e < n * words; e += blockDim.x) {
    const int r = e / words;
    const int w = e - r * words;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < nvalid)
      v = reinterpret_cast<const int4*>(src + (long long)r * dp)[w];
    reinterpret_cast<int4*>(dst + r * ldq)[w] = v;
  }
}

template <int NCT>
__global__ void knn_tiled_mxu_kernel(
    const int* __restrict__ order,           // [Bq, Bp] nearest-first
    const float* __restrict__ boxd2,         // [Bq, Bp] ascending box d2
    const float* __restrict__ q_pts,         // [Bq, S, D]
    const int* __restrict__ q_ids,           // [Bq, S]
    const __nv_bfloat16* __restrict__ qh,    // [Bq, S_pad, Dp]
    const __nv_bfloat16* __restrict__ ql,    // [Bq, S_pad, Dp]
    const float* __restrict__ p_pts,         // [Bp, T, D]
    const int* __restrict__ p_ids,           // [Bp, T]
    const __nv_bfloat16* __restrict__ ph,    // [Bp, T, Dp]
    const __nv_bfloat16* __restrict__ pl,    // [Bp, T, Dp]
    const float* __restrict__ pn2,           // [Bp, T] exact |p|^2
    float* __restrict__ d2,                  // [Bq*S, W] in/out
    int* __restrict__ idx,                   // [Bq*S, W] in/out
    int* __restrict__ visits,                // [Bq] accumulated
    int s_q, int s_pad, int num_pb, int t_p, int dim, int dp, int w,
    int skip_self, int self_group, int rows_per_block) {
  constexpr int LC = NCT * kT;  // lanes per staged chunk
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warp_buf[32];
  const int bd = blockDim.x;  // == rows_per_block, a multiple of 32
  const int ldq = dp + 8;
  __nv_bfloat16* qh_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ql_s = qh_s + (size_t)bd * ldq;
  __nv_bfloat16* ph_s = ql_s + (size_t)bd * ldq;
  __nv_bfloat16* pl_s = ph_s + (size_t)LC * ldq;
  float* pn2_s = reinterpret_cast<float*>(pl_s + (size_t)LC * ldq);  // [LC]
  float* sc = pn2_s + LC;                    // [warps][LC][32] col-major
  float* cd2 = sc + (size_t)(bd >> 5) * LC * 32;  // [w][bd]
  int* cidx = reinterpret_cast<int*>(cd2 + (size_t)w * bd);  // [w][bd]

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int nrows = min(rows_per_block, s_q - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = (long long)b * s_q + r0;
  const long long base = row0 * w;

  for (int e = tid; e < nrows * w; e += bd) {
    const int r = e / w;
    const int j = e - r * w;
    cd2[j * bd + r] = d2[base + e];
    cidx[j * bd + r] = idx[base + e];
  }
  const long long qrow0 = (long long)b * s_pad + r0;
  stage_bf16_rows(qh_s, qh + qrow0 * dp, bd, bd, dp, ldq);
  stage_bf16_rows(ql_s, ql + qrow0 * dp, bd, bd, dp, ldq);
  const bool valid = tid < nrows && q_ids[row0 + tid] >= 0;
  const float* qrow = q_pts + (row0 + tid) * dim;
  float qn2 = 0.f;
  if (valid)
    for (int d = 0; d < dim; ++d)
      qn2 = __fadd_rn(qn2, __fmul_rn(qrow[d], qrow[d]));
  __syncthreads();
  float kth = valid ? cd2[(w - 1) * bd + tid] : -CUDART_INF_F;
  float worst = knn::block_max(kth, warp_buf);

  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  float* sc_w = sc + (size_t)warp * LC * 32;
  const __nv_bfloat16* qh_w = qh_s + (size_t)warp * 32 * ldq;
  const __nv_bfloat16* ql_w = ql_s + (size_t)warp * 32 * ldq;
  int nvis = 0;
  for (int v = 0; v < num_pb; ++v) {
    if (!(bx[v] < worst)) break;
    const int pb = ord[v];
    if (skip_self && pb == own) continue;
    const long long lane0 = (long long)pb * t_p;
    for (int l0 = 0; l0 < t_p; l0 += LC) {
      const int nl = min(LC, t_p - l0);
      __syncthreads();  // every warp is done with the previous chunk
      stage_bf16_rows(ph_s, ph + (lane0 + l0) * dp, LC, nl, dp, ldq);
      stage_bf16_rows(pl_s, pl + (lane0 + l0) * dp, LC, nl, dp, ldq);
      for (int l = tid; l < LC; l += bd)
        pn2_s[l] = l < nl ? pn2[lane0 + l0 + l] : CUDART_INF_F;
      __syncthreads();

      wmma::fragment<wmma::accumulator, kT, kT, kT, float> acc[2][NCT];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < NCT; ++c) wmma::fill_fragment(acc[i][c], 0.f);
      for (int ks = 0; ks < dp; ks += kT) {
        wmma::fragment<wmma::matrix_a, kT, kT, kT, __nv_bfloat16,
                       wmma::row_major> ah[2], al[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(ah[i], qh_w + i * kT * ldq + ks, ldq);
          wmma::load_matrix_sync(al[i], ql_w + i * kT * ldq + ks, ldq);
        }
#pragma unroll
        for (int c = 0; c < NCT; ++c) {
          wmma::fragment<wmma::matrix_b, kT, kT, kT, __nv_bfloat16,
                         wmma::col_major> bh, bl;
          wmma::load_matrix_sync(bh, ph_s + c * kT * ldq + ks, ldq);
          wmma::load_matrix_sync(bl, pl_s + c * kT * ldq + ks, ldq);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::mma_sync(acc[i][c], ah[i], bh, acc[i][c]);
            wmma::mma_sync(acc[i][c], ah[i], bl, acc[i][c]);
            wmma::mma_sync(acc[i][c], al[i], bh, acc[i][c]);
          }
        }
      }
      // element (row r of the warp, lane l) lands at sc_w[l * 32 + r]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < NCT; ++c)
          wmma::store_matrix_sync(sc_w + c * kT * 32 + i * kT, acc[i][c], 32,
                                  wmma::mem_col_major);
      __syncwarp();
      if (valid) {
        for (int l = 0; l < nl; ++l) {
          const float s = __fsub_rn(__fadd_rn(qn2, pn2_s[l]),
                                    __fmul_rn(2.f, sc_w[l * 32 + lane]));
          if (s < kth)
            kth = knn::insert_sorted(cd2, cidx, bd, tid, w, s,
                                     (int)(-2 - (lane0 + l0 + l)));
        }
      }
    }
    ++nvis;
    worst = knn::block_max(valid ? kth : -CUDART_INF_F, warp_buf);
  }

  if (valid) {
    // exact rescore of every adopted entry, then a stable insertion sort
    for (int j = 0; j < w; ++j) {
      const int id = cidx[j * bd + tid];
      if (id > -2) continue;
      const long long flat = -2LL - id;
      const float* pp = p_pts + flat * dim;
      float acc = 0.f;
      for (int d = 0; d < dim; ++d) {
        const float di = __fsub_rn(qrow[d], pp[d]);
        acc = __fadd_rn(acc, __fmul_rn(di, di));
      }
      cd2[j * bd + tid] = acc;
      cidx[j * bd + tid] = p_ids[flat];
    }
    for (int j = 1; j < w; ++j) {
      const float v = cd2[j * bd + tid];
      const int id = cidx[j * bd + tid];
      int i = j;
      while (i > 0 && cd2[(i - 1) * bd + tid] > v) {
        cd2[i * bd + tid] = cd2[(i - 1) * bd + tid];
        cidx[i * bd + tid] = cidx[(i - 1) * bd + tid];
        --i;
      }
      cd2[i * bd + tid] = v;
      cidx[i * bd + tid] = id;
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * w; e += bd) {
    const int r = e / w;
    const int j = e - r * w;
    d2[base + e] = cd2[j * bd + r];
    idx[base + e] = cidx[j * bd + r];
  }
  if (tid == 0 && nvis) atomicAdd(visits + b, nvis);
}

template <int NCT>
int launch(const int* order, const float* boxd2, const float* q_pts,
           const int* q_ids, const __nv_bfloat16* qh,
           const __nv_bfloat16* ql, const float* p_pts, const int* p_ids,
           const __nv_bfloat16* ph, const __nv_bfloat16* pl,
           const float* pn2, float* d2, int* idx, int* visits, int num_qb,
           int s_q, int s_pad, int num_pb, int t_p, int dim, int dp, int w,
           int skip_self, int self_group, int rows, cudaStream_t stream) {
  constexpr int LC = NCT * kT;
  const size_t ldq = dp + 8;
  const size_t smem = 2 * (size_t)rows * ldq * 2 + 2 * (size_t)LC * ldq * 2 +
                      (size_t)LC * 4 + (size_t)(rows / 32) * LC * 32 * 4 +
                      (size_t)w * rows * 8;
  cudaError_t err = cudaFuncSetAttribute(
      knn_tiled_mxu_kernel<NCT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, s_pad / rows);
  knn_tiled_mxu_kernel<NCT><<<grid, rows, smem, stream>>>(
      order, boxd2, q_pts, q_ids, qh, ql, p_pts, p_ids, ph, pl, pn2, d2, idx,
      visits, s_q, s_pad, num_pb, t_p, dim, dp, w, skip_self, self_group,
      rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok),
// or cudaErrorInvalidValue for a chunk width other than 16, 32 or 64.
extern "C" int knn_tiled_mxu_launch(
    const int* order, const float* boxd2, const float* q_pts,
    const int* q_ids, const void* qh, const void* ql, const float* p_pts,
    const int* p_ids, const void* ph, const void* pl, const float* pn2,
    float* d2, int* idx, int* visits, int num_qb, int s_q, int s_pad,
    int num_pb, int t_p, int dim, int dp, int w, int skip_self,
    int self_group, int rows, int lanes_chunk, void* stream) {
  const auto* qh_ = static_cast<const __nv_bfloat16*>(qh);
  const auto* ql_ = static_cast<const __nv_bfloat16*>(ql);
  const auto* ph_ = static_cast<const __nv_bfloat16*>(ph);
  const auto* pl_ = static_cast<const __nv_bfloat16*>(pl);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes_chunk) {
    case 64:
      return launch<4>(order, boxd2, q_pts, q_ids, qh_, ql_, p_pts, p_ids,
                       ph_, pl_, pn2, d2, idx, visits, num_qb, s_q, s_pad,
                       num_pb, t_p, dim, dp, w, skip_self, self_group, rows,
                       s);
    case 32:
      return launch<2>(order, boxd2, q_pts, q_ids, qh_, ql_, p_pts, p_ids,
                       ph_, pl_, pn2, d2, idx, visits, num_qb, s_q, s_pad,
                       num_pb, t_p, dim, dp, w, skip_self, self_group, rows,
                       s);
    case 16:
      return launch<1>(order, boxd2, q_pts, q_ids, qh_, ql_, p_pts, p_ids,
                       ph_, pl_, pn2, d2, idx, visits, num_qb, s_q, s_pad,
                       num_pb, t_p, dim, dp, w, skip_self, self_group, rows,
                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
