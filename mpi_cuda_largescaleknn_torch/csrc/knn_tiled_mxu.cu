// Nearest-first bucketed kNN traversal with matmul-form scores on the
// tensor cores, for Hopper (sm_90a): two kernels, routed by Dp (the
// wrapper, ops/knn_tiled.py mxu_launch_geometry, names the limit).
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
//   A bucket's visit count is the most any of its blocks scored.
//
// What bounds it on the H100: the tensor cores. The cross term is 3*2*Dp
// bf16 FLOP per scored pair (Dp = D rounded up to 16, zero columns add
// nothing; 989 TFLOP/s dense) against a handful of FP32 operations of the
// epilogue per pair.
//
// knn_tiled_wgmma_kernel (Dp up to the plan's limit) is built for that
// bound. The first design (knn_tiled_mxu_kernel below) lost it three ways;
// what this one does about each:
// - Occupancy: 4 warps a block and one block an SM, mostly for a 32 KB
//   score slab. Here a block is 128 query rows in two consumer warpgroups
//   (8 warps) plus one producer warp, and there is no slab.
// - Nothing overlapped: each chunk was copied through registers, synced,
//   multiplied, stored and folded in turn. Here the wrapper packs both
//   bf16 halves in wgmma's K-major no-swizzle core-matrix order (8 lanes x
//   16 B per 128 B core matrix), so 64 lanes of a bucket are one
//   contiguous run per half; one producer thread fills a ring of 2-3
//   stages with cp.async.bulk (full/empty mbarriers), running ahead into
//   the next bucket of the walk; each warpgroup issues
//   wgmma.mma_async m64n64k16 (hh, hl, lh per 16-wide k-slice into one f32
//   accumulator) for a pair of chunks into two accumulators and folds the
//   first while the second multiplies; the two warpgroups take turns to
//   issue (named barriers), so one folds while the other's products run.
// - A slow fold: one thread per row read back every score. Here each
//   thread scores its 32 accumulator entries in registers and gates them
//   against its two rows' W-th values at the chunk's start (these only
//   shrink, so a lane failing the gate could never be adopted). Only when
//   a warp holds a passing lane do the quads merge their pass masks in
//   column (= lane) order and hand each passing score by shuffle to the
//   row's inserting thread, which re-checks it strict-< against its
//   shrinking W-th value. Rows sit in shared memory where they fit beside
//   the ring (W=20 at Dp=128); wider rows stay in place in device memory,
//   touched only by the rare adoption and the epilogue.
// The exact rescore spreads each row's slots over its quad (each sum one
// thread's left-to-right chain); the row's inserting thread sorts. The
// prefetch is speculative across the block's prune break: the producer
// waits for every copy it issued before the block exits.
//
// knn_tiled_mxu_kernel (above that Dp, where the query halves and a ring
// no longer fit in shared memory) is the simple design: one thread per
// row and one warp per 32 rows; the block's query halves staged once,
// each visited bucket staged in chunks of 16*NCT lanes, nvcuda::wmma
// 16x16x16 bf16 fragments, the f32 cross terms stored column-major to a
// per-warp shared-memory slab, and each thread folding its row's scores
// in lane order. Rows of shared memory are padded by 8 bf16 so fragment
// loads spread over banks.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "bulk_ring.cuh"
#include "knn_rows.cuh"

namespace {

using namespace nvcuda;
using knn::bulk_load;
using knn::mbar_arrive;
using knn::mbar_expect_tx;
using knn::mbar_init;
using knn::mbar_try_wait;
using knn::mbar_wait;
using knn::smem_addr;

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
    int* __restrict__ visits,                // [Bq] max over blocks
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
  if (tid == 0 && nvis) atomicMax(visits + b, nvis);
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


// ---------------------------------------------------------------------------
// knn_tiled_wgmma_kernel

constexpr int kWgRows = 128;       // query rows a block
constexpr int kWgLanes = 64;       // point lanes a chunk: the n of m64n64k16
constexpr int kConsumers = 256;    // two consumer warpgroups of 64 rows
constexpr int kWgThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 3;

// wgmma descriptor of a K-major operand without swizzle (layout type 0):
// 8-row x 16-byte core matrices, 128 B apart along K (the leading byte
// offset) and `sbo` bytes apart along M or N (the stride byte offset).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A[64, 16] . B[64, 16]^T, both K-major in shared memory. In d,
// thread t of warp w of the warpgroup holds rows 16w + t/4 (d[4j + e]) and
// 16w + t/4 + 8 (d[4j + 2 + e]) at column 8j + 2(t%4) + e.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// acc = qh.ph + qh.pl + ql.ph over `ksteps` k-slices of 16 (each advances
// both descriptors by two core matrices, 256 B), as one committed group.
__device__ __forceinline__ void chunk_products(float (&acc)[32], uint64_t qh,
                                               uint64_t ql, uint64_t ph,
                                               uint64_t pl, int ksteps) {
  fence_regs(acc);
  wgmma_fence();
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t o = 16ull * ks;
    wgmma_m64n64k16(acc, qh + o, ph + o, ks);
    wgmma_m64n64k16(acc, qh + o, pl + o, 1);
    wgmma_m64n64k16(acc, ql + o, ph + o, 1);
  }
  wgmma_commit();
  fence_regs(acc);
}

// The consumer warpgroups take turns issuing their products (named
// barriers 2 and 3): warpgroup g waits for its turn, issues, and hands the
// turn to the other, so one folds while the other's products run.
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(2 + wg), "n"(kConsumers)
               : "memory");
}

__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(3 - wg), "n"(kConsumers)
               : "memory");
}

__global__ void __launch_bounds__(kWgThreads, 1) knn_tiled_wgmma_kernel(
    const int* __restrict__ order,           // [Bq, Bp] nearest-first
    const float* __restrict__ boxd2,         // [Bq, Bp] ascending box d2
    const float* __restrict__ q_pts,         // [Bq, S, D]
    const int* __restrict__ q_ids,           // [Bq, S]
    const __nv_bfloat16* __restrict__ qh,    // [Bq, S_pad/8, Dp/8, 8, 8]
    const __nv_bfloat16* __restrict__ ql,    // [Bq, S_pad/8, Dp/8, 8, 8]
    const float* __restrict__ p_pts,         // [Bp, T, D]
    const int* __restrict__ p_ids,           // [Bp, T]
    const __nv_bfloat16* __restrict__ ph,    // [Bp, T_pad/8, Dp/8, 8, 8]
    const __nv_bfloat16* __restrict__ pl,    // [Bp, T_pad/8, Dp/8, 8, 8]
    const float* __restrict__ pn2,           // [Bp, T_pad], +inf padding
    float* d2,                               // [Bq*S, W] in/out
    int* idx,                                // [Bq*S, W] in/out
    int* __restrict__ visits,                // [Bq] max over blocks
    int s_q, int s_pad, int num_pb, int t_p, int t_pad, int dim, int dp,
    int w, int skip_self, int self_group, int stages, int rows_in_smem) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qbytes = kWgRows * dp * 2;   // one half of the queries
  const uint32_t cbytes = kWgLanes * dp * 2;  // one half of a chunk
  const uint32_t sbytes = 2 * cbytes + kWgLanes * 4;  // a stage, |p|^2 last
  unsigned char* q_s = smem;                  // qh, then ql
  unsigned char* ring = smem + 2 * qbytes;
  const int row_slots = rows_in_smem ? w * kWgRows : 0;
  float* cd2 = reinterpret_cast<float*>(ring + stages * sbytes);  // [w][128]
  int* cidx = reinterpret_cast<int*>(cd2 + row_slots);            // [w][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(cidx + row_slots);
  uint64_t* empty = full + kMaxStages;
  uint64_t* qbar = empty + kMaxStages;
  float* red = reinterpret_cast<float*>(qbar + 1);                // [2][8]
  volatile int* stop = reinterpret_cast<volatile int*>(red + 16);

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * kWgRows;
  const int nrows = min(kWgRows, s_q - r0);
  const int tid = threadIdx.x;
  const int own = b / self_group;
  const int* ord = order + (long long)b * num_pb;
  const float* bx = boxd2 + (long long)b * num_pb;
  const int nch = t_pad / kWgLanes;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // one arrival per warp
    }
    mbar_init(qbar, 1);
    *stop = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup 2 (one warp) produces; the shuffle tells the compiler the
  // role is warp-uniform
  if (__shfl_sync(0xffffffffu, tid >> 7, 0) == kConsumers / 128) {
    // The producer: one thread walks the consumers' schedule without the
    // prune and keeps the ring full until they stop it.
    if (tid != kConsumers) return;
    const long long qoff = ((long long)b * s_pad + r0) * dp;
    mbar_expect_tx(qbar, 2 * qbytes);
    bulk_load(q_s, qh + qoff, qbytes, qbar);
    bulk_load(q_s + qbytes, ql + qoff, qbytes, qbar);
    int n = 0;  // chunks issued
    for (int v = 0; v < num_pb && !*stop; ++v) {
      const int pb = ord[v];
      if (skip_self && pb == own) continue;
      for (int c = 0; c < nch; ++c, ++n) {
        const int s = n % stages;
        if (n >= stages) {  // wait until every consumer warp released it
          const uint32_t parity = (n / stages - 1) & 1;
          while (!mbar_try_wait(empty + s, parity))
            if (*stop) goto drain;
        }
        if (*stop) goto drain;
        unsigned char* st = ring + s * sbytes;
        const long long e0 = ((long long)pb * t_pad + c * kWgLanes) * dp;
        mbar_expect_tx(full + s, sbytes);
        bulk_load(st, ph + e0, cbytes, full + s);
        bulk_load(st + cbytes, pl + e0, cbytes, full + s);
        bulk_load(st + 2 * cbytes, pn2 + (long long)pb * t_pad + c * kWgLanes,
                  kWgLanes * 4, full + s);
      }
    }
  drain:
    // every copy issued lands before the block exits
    mbar_wait(qbar, 0);
    for (int s = 0; s < stages && s < n; ++s)
      mbar_wait(full + s, ((n - 1 - s) / stages) & 1);
    return;
  }

  // The consumers: warpgroup wg multiplies rows 64wg .. 64wg+63; each
  // thread holds two rows of the accumulator (h = 0, 1), with the three
  // other threads of its quad.
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform
  const long long row0 = (long long)b * s_q + r0;
  const long long base = row0 * w;
  const int rstride = rows_in_smem ? kWgRows : 1;
  if (rows_in_smem)
    for (int e = tid; e < nrows * w; e += kConsumers) {
      const int r = e / w;
      const int j = e - r * w;
      cd2[j * kWgRows + r] = d2[base + e];
      cidx[j * kWgRows + r] = idx[base + e];
    }
  int rloc[2];
  bool valid[2];
  float qn2[2], kth[2];
  float* rd[2];
  int* ri[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rloc[h] = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2) + 8 * h;
    valid[h] = rloc[h] < nrows && q_ids[row0 + rloc[h]] >= 0;
    rd[h] = rows_in_smem ? cd2 + rloc[h] : d2 + (row0 + rloc[h]) * w;
    ri[h] = rows_in_smem ? cidx + rloc[h] : idx + (row0 + rloc[h]) * w;
    qn2[h] = 0.f;
    if (valid[h]) {
      const float* qrow = q_pts + (row0 + rloc[h]) * dim;
      for (int d = 0; d < dim; ++d)
        qn2[h] = __fadd_rn(qn2[h], __fmul_rn(qrow[d], qrow[d]));
    }
  }
  knn::consumer_sync<kConsumers>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    kth[h] = valid[h] ? rd[h][(w - 1) * rstride] : -CUDART_INF_F;
  int parity = 0;
  float worst =
      knn::consumer_max<kConsumers>(fmaxf(kth[0], kth[1]), red, parity);

  const uint32_t sbo = dp * 16;  // bytes between 8-row core-matrix groups
  const uint64_t qh_d = wgmma_desc(q_s + wg * (qbytes / 2), sbo);
  const uint64_t ql_d = wgmma_desc(q_s + qbytes + wg * (qbytes / 2), sbo);
  const int ksteps = dp / 16;
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  mbar_wait(qbar, 0);

  // wait for chunk n (of the walk) and start its products into acc
  auto issue = [&](float (&acc)[32], int n) {
    const int s = n % stages;
    mbar_wait(full + s, (n / stages) & 1);
    const unsigned char* st = ring + s * sbytes;
    chunk_products(acc, qh_d, ql_d, wgmma_desc(st, sbo),
                   wgmma_desc(st + cbytes, sbo), ksteps);
  };

  // Lanes that passed the gate, in lane order: the quad's masks merged by
  // column, each score shuffled to the row's inserting thread (q4 == h).
  auto adopt = [&](float (&sc)[32], uint32_t (&m)[2], long long pos0) {
    uint64_t u[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      u[h] = 0ull;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        u[h] |= (uint64_t)((m[h] >> (2 * j)) & 3u) << (8 * j + 2 * q4);
      u[h] |= __shfl_xor_sync(0xffffffffu, u[h], 1);
      u[h] |= __shfl_xor_sync(0xffffffffu, u[h], 2);
    }
    while (__any_sync(0xffffffffu, (u[0] | u[1]) != 0ull)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool has = u[h] != 0ull;
        const int col = has ? __ffsll((long long)u[h]) - 1 : 0;
        u[h] &= u[h] - 1ull;
        const int sel = ((col >> 3) << 1) | (col & 1);
        float mine = 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t)
          if (t == sel) mine = sc[4 * (t >> 1) + 2 * h + (t & 1)];
        const float val = __shfl_sync(0xffffffffu, mine,
                                      (lane & ~3) | ((col >> 1) & 3));
        if (has && q4 == h && val < kth[h])
          kth[h] = knn::insert_sorted(rd[h], ri[h], rstride, 0, w, val,
                                      (int)(-2 - (pos0 + col)));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      kth[h] = __shfl_sync(0xffffffffu, kth[h], (lane & ~3) | h);
  };

  // Chunk n of the walk, its products complete in `cur`: release its
  // stage, score and gate in registers, adopt what passed.
  auto fold = [&](float (&cur)[32], int n, long long pos0) {
    const int s = n % stages;
    const float2* pn =
        reinterpret_cast<const float2*>(ring + s * sbytes + 2 * cbytes);
    float2 pv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[j] = pn[4 * j + q4];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    float sc[32];
    uint32_t m[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = e ? pv[j].y : pv[j].x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * j + 2 * h + e;
          sc[r] = __fsub_rn(__fadd_rn(qn2[h], pe), __fmul_rn(2.f, cur[r]));
          m[h] |= (uint32_t)(sc[r] < kth[h]) << (2 * j + e);
        }
      }
    if (__any_sync(0xffffffffu, (m[0] | m[1]) != 0u)) adopt(sc, m, pos0);
  };

  int n = 0;  // chunks consumed
  int nvis = 0;
  if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
  for (int v = 0; v < num_pb; ++v) {
    // read through a shuffle, so the compiler sees a warp-uniform walk
    // (products on a divergent path would be serialized)
    if (!(__shfl_sync(0xffffffffu, bx[v], 0) < worst)) break;
    const int pb = __shfl_sync(0xffffffffu, ord[v], 0);
    if (skip_self && pb == own) continue;
    const long long lane0 = (long long)pb * t_p;
    // Chunks go in pairs (T_pad is a multiple of 128 lanes): chunk c+1's
    // products, and then the other warpgroup's, run while chunk c is
    // folded. Both groups are issued and waited for within one iteration:
    // ptxas serializes the products when a group stays in flight across
    // iterations.
    for (int c = 0; c < nch; c += 2) {
      wait_turn(wg);
      issue(acc0, n + c);
      issue(acc1, n + c + 1);
      pass_turn(wg);
      wgmma_wait<1>();
      fence_regs(acc0);
      fold(acc0, n + c, lane0 + (long long)c * kWgLanes);
      wgmma_wait<0>();
      fence_regs(acc1);
      fold(acc1, n + c + 1, lane0 + (long long)(c + 1) * kWgLanes);
    }
    n += nch;
    ++nvis;
    parity ^= 1;
    worst =
        knn::consumer_max<kConsumers>(fmaxf(kth[0], kth[1]), red, parity);
  }
  if (tid == 0) *stop = 1;
  if (wg == 0) wait_turn(wg);  // the turn warpgroup 1 passed last

  // exact rescore of every adopted entry, each row's slots shared by its
  // quad; then the row's inserting thread sorts it stably
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    const float* qrow = q_pts + (row0 + rloc[h]) * dim;
    for (int j = q4; j < w; j += 4) {
      const int id = ri[h][j * rstride];
      if (id > -2) continue;
      const long long flat = -2LL - id;
      const float* pp = p_pts + flat * dim;
      float acc = 0.f;
      for (int d = 0; d < dim; ++d) {
        const float di = __fsub_rn(qrow[d], pp[d]);
        acc = __fadd_rn(acc, __fmul_rn(di, di));
      }
      rd[h][j * rstride] = acc;
      ri[h][j * rstride] = p_ids[flat];
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h] || q4 != h) continue;
    float* rdh = rd[h];
    int* rih = ri[h];
    for (int j = 1; j < w; ++j) {
      const float v = rdh[j * rstride];
      const int id = rih[j * rstride];
      int i = j;
      while (i > 0 && rdh[(i - 1) * rstride] > v) {
        rdh[i * rstride] = rdh[(i - 1) * rstride];
        rih[i * rstride] = rih[(i - 1) * rstride];
        --i;
      }
      rdh[i * rstride] = v;
      rih[i * rstride] = id;
    }
  }
  knn::consumer_sync<kConsumers>();
  if (rows_in_smem)
    for (int e = tid; e < nrows * w; e += kConsumers) {
      const int r = e / w;
      const int j = e - r * w;
      d2[base + e] = cd2[j * kWgRows + r];
      idx[base + e] = cidx[j * kWgRows + r];
    }
  if (tid == 0 && nvis) atomicMax(visits + b, nvis);
}

// Dynamic shared memory of knn_tiled_wgmma_kernel (ops/knn_tiled.py
// wgmma_smem_bytes computes the same).
size_t wgmma_smem(int dp, int w, int stages, int rows_in_smem) {
  return 2 * (size_t)kWgRows * dp * 2 +
         (size_t)stages * (2 * (size_t)kWgLanes * dp * 2 + kWgLanes * 4) +
         (rows_in_smem ? (size_t)w * kWgRows * 8 : 0) + 128;
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

// Launches knn_tiled_wgmma_kernel on `stream`; returns the CUDA error code
// of the launch (0 = ok), or cudaErrorInvalidValue for a shape it does not
// take (Dp not a multiple of 16, S_pad not of 128, T_pad not of 128, or
// a ring of other than 2 or 3 stages).
extern "C" int knn_tiled_wgmma_launch(
    const int* order, const float* boxd2, const float* q_pts,
    const int* q_ids, const void* qh, const void* ql, const float* p_pts,
    const int* p_ids, const void* ph, const void* pl, const float* pn2,
    float* d2, int* idx, int* visits, int num_qb, int s_q, int s_pad,
    int num_pb, int t_p, int t_pad, int dim, int dp, int w, int skip_self,
    int self_group, int stages, int rows_in_smem, void* stream) {
  if (dp % 16 || s_pad % kWgRows || t_pad % (2 * kWgLanes) || stages < 2 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem(dp, w, stages, rows_in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      knn_tiled_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, s_pad / kWgRows);
  knn_tiled_wgmma_kernel<<<grid, kWgThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      order, boxd2, q_pts, q_ids, static_cast<const __nv_bfloat16*>(qh),
      static_cast<const __nv_bfloat16*>(ql), p_pts, p_ids,
      static_cast<const __nv_bfloat16*>(ph),
      static_cast<const __nv_bfloat16*>(pl), pn2, d2, idx, visits, s_q,
      s_pad, num_pb, t_p, t_pad, dim, dp, w, skip_self, self_group, stages,
      rows_in_smem);
  return (int)cudaGetLastError();
}
