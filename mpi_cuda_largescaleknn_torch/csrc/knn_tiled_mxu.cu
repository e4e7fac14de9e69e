// Nearest-first bucketed kNN traversal with matmul-form scores on the
// tensor cores, for Hopper (sm_90a): knn_tiled_wgmma_kernel, in two
// instances routed by Dp (the wrapper, ops/knn_tiled.py
// mxu_launch_geometry, names the limit).
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
// What bounds it on the H100: the tensor cores. The cross term needs 3*2*D
// bf16 FLOP per scored pair (989 TFLOP/s dense) against a handful of FP32
// operations of the epilogue per pair. The kernel multiplies Dp = D
// rounded up to 16 components: the zero columns are products wasted
// (8 of 608 at D=600).
//
// The design, against that bound:
// - A block is 128 query rows in two consumer warpgroups (8 warps) plus
//   one producer warp. The wrapper packs both bf16 halves in wgmma's
//   K-major no-swizzle core-matrix order (8 lanes x 16 B per 128 B core
//   matrix); one producer thread fills a ring of 2-3 stages with
//   cp.async.bulk (full/empty mbarriers), running ahead into the next
//   bucket of the walk; the consumers issue wgmma.mma_async (hh, hl, lh per
//   16-wide k-step into one f32 accumulator) for a pair of 64-lane chunks
//   into two accumulators, and the two warpgroups take turns to issue
//   (named barriers), so one folds while the other's products run.
// - The fold is gated: each thread scores its 32 accumulator entries in
//   registers and gates them against its two rows' W-th values at the
//   chunk's start (these only shrink, so a lane failing the gate could
//   never be adopted). Only when a warp holds a passing lane do the quads
//   merge their pass masks in column (= lane) order and hand each passing
//   score by shuffle to the row's inserting thread, which re-checks it
//   strict-< against its shrinking W-th value. Rows sit in shared memory
//   where they fit beside the ring (W=20 at every Dp); wider rows stay in
//   place in device memory, touched only by the rare adoption and the
//   epilogue, so any W runs.
// - Up to Dp = 224 (kStream = false) the block's query halves are
//   resident, copied once; a stage is one 64-lane chunk of both point
//   halves and its |p|^2, and each chunk's products are one committed
//   group (m64n64k16), the pair's two waited for in turn so the first is
//   folded while the second multiplies.
// - Above it (kStream = true) the query halves and a 2-stage ring no
//   longer fit in 227 KB, so D is streamed: a stage is one K-slice of at
//   most 64 components (4 k-steps) of the block's query halves (128 rows)
//   and of the chunk pair's point halves (128 lanes), 64 KB, plus the
//   pair's 128 |p|^2 with its last slice. The producer walks (chunk pair,
//   slice) pairs; the accumulators persist over a pair's slices (the first
//   k-step zeroes them), each slice's products are one m64n128k16 a
//   half-product and k-step (the pair's two accumulators as one), committed
//   and waited for within the slice, so no group stays in flight across
//   iterations (ptxas would serialize every product: C7520), and a stage
//   is released only once the products that read it are complete. The
//   gate runs once per pair, after its last slice.
// What bounds the streamed route beyond the tensor cores: L2. The queries
// are re-read for every chunk pair, so a stage carries 3*2*128*128*64 FLOP
// for 64 KB, 96 FLOP a byte (the resident route's chunks carry 192): at
// the tensor cores' peak about 10 TB/s, all from L2, more than it is
// likely to give. What the design does: a stage spans the whole pair (128
// lanes), so each query slice feeds twice the products a 64-lane stage
// would, and three stages keep two slices' copies in flight behind the
// one multiplied.
// The exact rescore spreads each row's slots over its quad (each sum one
// thread's left-to-right chain); the row's inserting thread sorts. The
// prefetch is speculative across the block's prune break: the producer
// waits for every copy it issued before the block exits.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bulk_ring.cuh"
#include "knn_rows.cuh"

namespace {

using knn::bulk_load;
using knn::mbar_arrive;
using knn::mbar_expect_tx;
using knn::mbar_init;
using knn::mbar_try_wait;
using knn::mbar_wait;
using knn::smem_addr;

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

// d0|d1 (+)= A[64, 16] . B[128, 16]^T, both K-major in shared memory: d0
// holds columns 0-63 and d1 columns 64-127, each in wgmma_m64n64k16's
// layout.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d0)[32],
                                                 float (&d1)[32], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One K-slice of a chunk pair (streamed route): acc0|acc1 (+)= qh.ph +
// qh.pl + ql.ph over `ksteps` k-steps of 16, as one committed group; the
// pair's first k-step (k0 == 0) zeroes both.
__device__ __forceinline__ void slice_products(float (&acc0)[32],
                                               float (&acc1)[32], uint64_t qh,
                                               uint64_t ql, uint64_t ph,
                                               uint64_t pl, int ksteps,
                                               int k0) {
  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_fence();
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t o = 16ull * ks;
    wgmma_m64n128k16(acc0, acc1, qh + o, ph + o, k0 + ks);
    wgmma_m64n128k16(acc0, acc1, qh + o, pl + o, 1);
    wgmma_m64n128k16(acc0, acc1, ql + o, ph + o, 1);
  }
  wgmma_commit();
  fence_regs(acc0);
  fence_regs(acc1);
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

// Bytes of one ring stage: a 64-lane chunk of both point halves and its
// |p|^2 (resident queries), or one K-slice of `slice` components of both
// query halves (128 rows) and both point halves of a chunk pair (128
// lanes), then the pair's 128 |p|^2.
__host__ __device__ __forceinline__ uint32_t wgmma_stage_bytes(int dp,
                                                               int slice) {
  return slice ? 4u * kWgRows * slice * 2 + 2 * kWgLanes * 4
               : 2u * kWgLanes * dp * 2 + kWgLanes * 4;
}

// kStream = false: the block's query halves resident in shared memory, a
// stage holds one chunk. kStream = true: a stage holds one K-slice of
// `slice` components (the last one may be shorter): the slice of qh, of ql
// (128 rows each), of ph, of pl (the chunk pair's 128 lanes each), each in
// a part of 256 * slice bytes, and after the pair's last slice its |p|^2.
// The wrapper's packing (ops/knn_tiled.py pack_wgmma_halves) makes each
// part one contiguous run: within a group of 128 rows or lanes, slice
// [c0, c0 + g) starts at element 128 * c0, in core-matrix order.
template <bool kStream>
__global__ void __launch_bounds__(kWgThreads, 1) knn_tiled_wgmma_kernel(
    const int* __restrict__ order,           // [Bq, Bp] nearest-first
    const float* __restrict__ boxd2,         // [Bq, Bp] ascending box d2
    const float* __restrict__ q_pts,         // [Bq, S, D]
    const int* __restrict__ q_ids,           // [Bq, S]
    const __nv_bfloat16* __restrict__ qh,    // [Bq, S_pad/8, Dp/8, 8, 8]
    const __nv_bfloat16* __restrict__ ql,    // (streamed: sliced runs)
    const float* __restrict__ p_pts,         // [Bp, T, D]
    const int* __restrict__ p_ids,           // [Bp, T]
    const __nv_bfloat16* __restrict__ ph,    // [Bp, T_pad/8, Dp/8, 8, 8]
    const __nv_bfloat16* __restrict__ pl,    // (streamed: sliced runs)
    const float* __restrict__ pn2,           // [Bp, T_pad], +inf padding
    float* d2,                               // [Bq*S, W] in/out
    int* idx,                                // [Bq*S, W] in/out
    int* __restrict__ visits,                // [Bq] max over blocks
    int s_q, int s_pad, int num_pb, int t_p, int t_pad, int dim, int dp,
    int w, int skip_self, int self_group, int stages, int rows_in_smem,
    int slice, int y0) {
  extern __shared__ __align__(128) unsigned char smem[];
  // one half of the queries (resident)
  const uint32_t qbytes = kStream ? 0u : kWgRows * dp * 2;
  const uint32_t cbytes = kWgLanes * dp * 2;  // one half of a chunk
  const uint32_t sbytes = kStream ? wgmma_stage_bytes(dp, slice)
                                  : 2 * cbytes + kWgLanes * 4;  // |p|^2 last
  const uint32_t part = kWgRows * slice * 2;  // a streamed stage's part
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
  // a bucket of more than 65,535 blocks goes in launches from block y0
  const int r0 = (blockIdx.y + y0) * kWgRows;
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
    if (!kStream) {
      mbar_expect_tx(qbar, 2 * qbytes);
      bulk_load(q_s, qh + qoff, qbytes, qbar);
      bulk_load(q_s + qbytes, ql + qoff, qbytes, qbar);
    }
    int n = 0;  // stages issued: chunks, or (chunk pair, slice) pairs
    for (int v = 0; v < num_pb && !*stop; ++v) {
      const int pb = ord[v];
      if (skip_self && pb == own) continue;
      if (kStream) {
        for (int c = 0; c < nch; c += 2) {
          const long long poff = ((long long)pb * t_pad + c * kWgLanes) * dp;
          for (int c0 = 0; c0 < dp; c0 += slice, ++n) {
            const int s = n % stages;
            if (n >= stages) {  // wait until every consumer warp released it
              const uint32_t parity = (n / stages - 1) & 1;
              while (!mbar_try_wait(empty + s, parity))
                if (*stop) goto drain;
            }
            if (*stop) goto drain;
            unsigned char* st = ring + s * sbytes;
            const uint32_t bytes = kWgRows * min(slice, dp - c0) * 2;
            const bool last = c0 + slice >= dp;
            const long long e = (long long)kWgRows * c0;
            mbar_expect_tx(full + s,
                           4 * bytes + (last ? 2 * kWgLanes * 4 : 0));
            bulk_load(st, qh + qoff + e, bytes, full + s);
            bulk_load(st + part, ql + qoff + e, bytes, full + s);
            bulk_load(st + 2 * part, ph + poff + e, bytes, full + s);
            bulk_load(st + 3 * part, pl + poff + e, bytes, full + s);
            if (last)
              bulk_load(st + 4 * part,
                        pn2 + (long long)pb * t_pad + c * kWgLanes,
                        2 * kWgLanes * 4, full + s);
          }
        }
      } else {
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
          bulk_load(st + 2 * cbytes,
                    pn2 + (long long)pb * t_pad + c * kWgLanes, kWgLanes * 4,
                    full + s);
        }
      }
    }
  drain:
    // every copy issued lands before the block exits
    if (!kStream) mbar_wait(qbar, 0);
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
  if (!kStream) mbar_wait(qbar, 0);

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

  // A chunk's complete products in `cur`, its lanes' |p|^2 in pv (this
  // thread's columns): score and gate in registers, adopt what passed.
  auto gate = [&](float (&cur)[32], const float2 (&pv)[8], long long pos0) {
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

  // Chunk n of the walk, its products complete in `cur`: release its
  // stage, then gate.
  auto fold = [&](float (&cur)[32], int n, long long pos0) {
    const int s = n % stages;
    const float2* pn =
        reinterpret_cast<const float2*>(ring + s * sbytes + 2 * cbytes);
    float2 pv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[j] = pn[4 * j + q4];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    gate(cur, pv, pos0);
  };

  int n = 0;  // stages consumed
  int nvis = 0;
  if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
  for (int v = 0; v < num_pb; ++v) {
    // read through a shuffle, so the compiler sees a warp-uniform walk
    // (products on a divergent path would be serialized)
    if (!(__shfl_sync(0xffffffffu, bx[v], 0) < worst)) break;
    const int pb = __shfl_sync(0xffffffffu, ord[v], 0);
    if (skip_self && pb == own) continue;
    const long long lane0 = (long long)pb * t_p;
    if (kStream) {
      // A chunk pair's slices in ascending order into acc0|acc1; each
      // slice's group is issued and waited for within its iteration, and
      // its stage released then (the last one's once its |p|^2 is read),
      // while the other warpgroup's products run.
      for (int c = 0; c < nch; c += 2) {
        int s = 0;
        for (int c0 = 0; c0 < dp; c0 += slice, ++n) {
          s = n % stages;
          const unsigned char* st = ring + s * sbytes;
          const int g = min(slice, dp - c0);
          const uint32_t sbo_g = 16 * g;  // between 8-row groups
          const uint32_t rows64 = 128 * g;  // bytes of 64 rows of a part
          wait_turn(wg);
          mbar_wait(full + s, (n / stages) & 1);
          slice_products(acc0, acc1, wgmma_desc(st + wg * rows64, sbo_g),
                         wgmma_desc(st + part + wg * rows64, sbo_g),
                         wgmma_desc(st + 2 * part, sbo_g),
                         wgmma_desc(st + 3 * part, sbo_g), g / 16, c0);
          pass_turn(wg);
          wgmma_wait<0>();
          fence_regs(acc0);
          fence_regs(acc1);
          if (c0 + slice < dp) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s);
          }
        }
        const float2* pn =
            reinterpret_cast<const float2*>(ring + s * sbytes + 4 * part);
        float2 pv0[8], pv1[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pv0[j] = pn[4 * j + q4];
          pv1[j] = pn[32 + 4 * j + q4];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        gate(acc0, pv0, lane0 + (long long)c * kWgLanes);
        gate(acc1, pv1, lane0 + (long long)(c + 1) * kWgLanes);
      }
    } else {
      // Chunks go in pairs (T_pad is a multiple of 128 lanes): chunk c+1's
      // products, and then the other warpgroup's, run while chunk c is
      // folded. Both groups are issued and waited for within one
      // iteration: ptxas serializes the products when a group stays in
      // flight across iterations.
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
    }
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
// wgmma_smem_bytes computes the same): the resident query halves (none
// when streamed), the ring, the rows when they sit there, and 128 bytes
// of barriers and flags.
size_t wgmma_smem(int dp, int w, int stages, int rows_in_smem, int slice) {
  return (slice ? 0 : 2 * (size_t)kWgRows * dp * 2) +
         (size_t)stages * wgmma_stage_bytes(dp, slice) +
         (rows_in_smem ? (size_t)w * kWgRows * 8 : 0) + 128;
}

template <bool kStream>
int wgmma_launch(const int* order, const float* boxd2, const float* q_pts,
                 const int* q_ids, const void* qh, const void* ql,
                 const float* p_pts, const int* p_ids, const void* ph,
                 const void* pl, const float* pn2, float* d2, int* idx,
                 int* visits, int num_qb, int s_q, int s_pad, int num_pb,
                 int t_p, int t_pad, int dim, int dp, int w, int skip_self,
                 int self_group, int stages, int rows_in_smem, int slice,
                 int y0, int ny, cudaStream_t stream) {
  const size_t smem = wgmma_smem(dp, w, stages, rows_in_smem, slice);
  cudaError_t err = cudaFuncSetAttribute(
      knn_tiled_wgmma_kernel<kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_qb, ny);
  knn_tiled_wgmma_kernel<kStream><<<grid, kWgThreads, smem, stream>>>(
      order, boxd2, q_pts, q_ids, static_cast<const __nv_bfloat16*>(qh),
      static_cast<const __nv_bfloat16*>(ql), p_pts, p_ids,
      static_cast<const __nv_bfloat16*>(ph),
      static_cast<const __nv_bfloat16*>(pl), pn2, d2, idx, visits, s_q,
      s_pad, num_pb, t_p, t_pad, dim, dp, w, skip_self, self_group, stages,
      rows_in_smem, slice, y0);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches knn_tiled_wgmma_kernel on `stream` over the ny blocks of 128
// rows of each bucket from block y0 (a bucket of more than 65,535 such
// blocks, the grid's y limit, goes in several launches): with the query
// halves resident when slice is 0, else with D streamed in K-slices of
// `slice` components (the halves packed in that slicing). Returns the CUDA
// error code of the launch (0 = ok), or cudaErrorInvalidValue for a shape
// it does not take (Dp not a multiple of 16, S_pad not of 128, T_pad not of
// 128, a ring of other than 2 or 3 stages, a slice not a multiple of 16 or
// above Dp, or a piece [y0, y0 + ny) empty, above 65,535 blocks or past
// the bucket).
extern "C" int knn_tiled_wgmma_launch(
    const int* order, const float* boxd2, const float* q_pts,
    const int* q_ids, const void* qh, const void* ql, const float* p_pts,
    const int* p_ids, const void* ph, const void* pl, const float* pn2,
    float* d2, int* idx, int* visits, int num_qb, int s_q, int s_pad,
    int num_pb, int t_p, int t_pad, int dim, int dp, int w, int skip_self,
    int self_group, int stages, int rows_in_smem, int slice, int y0, int ny,
    void* stream) {
  if (dp % 16 || s_pad % kWgRows || t_pad % (2 * kWgLanes) || stages < 2 ||
      stages > kMaxStages || slice % 16 || slice < 0 || slice > dp ||
      y0 < 0 || ny < 1 || ny > knn::kMaxGridY || y0 + ny > s_pad / kWgRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return slice ? wgmma_launch<true>(order, boxd2, q_pts, q_ids, qh, ql,
                                    p_pts, p_ids, ph, pl, pn2, d2, idx,
                                    visits, num_qb, s_q, s_pad, num_pb, t_p,
                                    t_pad, dim, dp, w, skip_self, self_group,
                                    stages, rows_in_smem, slice, y0, ny, st)
               : wgmma_launch<false>(order, boxd2, q_pts, q_ids, qh, ql,
                                     p_pts, p_ids, ph, pl, pn2, d2, idx,
                                     visits, num_qb, s_q, s_pad, num_pb, t_p,
                                     t_pad, dim, dp, w, skip_self, self_group,
                                     stages, rows_in_smem, 0, y0, ny, st);
}
