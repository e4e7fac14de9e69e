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
// What bounds it on the H100: operations. A pair is 9 FP32 issues (3 sub,
// 3 mul, 2 add and a compare or min; no FMA may fuse them), so the flat
// path's 10^12 pairs at 1M points need 268.7 ms at the card's 33.5e12
// FP32 issues/s, while the bytes are small: the point set (16 MB as
// float4) is re-read once per block of query rows, from L2.
//
// knn_bf_d3_kernel is built for that bound. Where the first D=3 kernel
// (one thread per query row, its k slots in shared memory as [k][threads])
// lost its time, and what this one does:
// - There a block held at most 224 rows at k=100 (8 bytes a slot a row),
//   so an SM ran 7 warps, too few to hide any latency. Here a warp folds 4
//   rows whose slots lie across its 32 lanes (knn_rows.cuh, the warp fold),
//   a block holds up to 16 warps, and the plan (ops/knn_bf.py
//   launch_geometry) keeps at least two blocks on an SM: 32 warps at
//   k=100 (64 registers a thread).
// - There every adoption shifted the row one slot at a time through
//   shared memory, in divergent control flow, so a warp waited for its
//   longest shift; a query adopts about k(1 + ln(N/k)) lanes, a thousand at
//   k=100. Here a lane's scores are gated by one compare of their min
//   against the row's k-th d2 (a warp-uniform register), and an adoption
//   is one warp-parallel insert: a count, a reduction, a shuffle, no chain.
// - There a pair cost a shared-memory load besides its 9 issues; here one
//   float4 load feeds the warp's 4 rows.
// - There each tile was staged through registers between two barriers.
//   Here the wrapper lays the points out once per launch as float4 {x, y,
//   z, id bits} (padded to whole 256-lane chunks with NaN lanes, never
//   adopted), and one thread bulk-copies the next tile (cp.async.bulk on an
//   mbarrier, bulk_ring.cuh) while the block folds this one: one barrier a
//   tile.
// - There k stopped at 903, where a block's rows beside one tile filled
//   its shared memory. knn_bf_d3_wide_kernel takes every k above
//   knn::kSlotsMaxK with the wide fold (knn_rows.cuh): a row in its own
//   order, in place in device memory, its adoptions buffered in shared
//   memory and merged up to kWideBuffer at a time, its tiles on a ring no
//   barrier of the block holds.
//
// Points of any other dimension D take knn_tiled.cu's
// knn_tiled_nd_ring_kernel (ops/knn_bf.py launch_knn_bf): the flat fold is
// its traversal with one query bucket of every row and one point bucket of
// every point, each pair scored left to right over all D components.

#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "knn_rows.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(knn::kD3MaxThreads, 2) knn_bf_d3_kernel(
    const float* __restrict__ q_pts,   // [nq, 3]
    const float4* __restrict__ p4,     // [np_pad] {x, y, z, id bits}
    float* __restrict__ d2,            // [nq, k] in/out, ascending rows
    int* __restrict__ idx,             // [nq, k] in/out
    int nq, int np_pad, int k, int tile_lanes) {
  using knn::kWarpRows;
  extern __shared__ __align__(16) unsigned char sbuf[];
  const int rows = (blockDim.x >> 5) * kWarpRows;
  float4* tiles = reinterpret_cast<float4*>(sbuf);                // [2][lanes]
  float* rd2 = reinterpret_cast<float*>(tiles + 2 * tile_lanes);  // [rows][S][32]
  int* ridx = reinterpret_cast<int*>(rd2 + rows * S * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(ridx + rows * S * 32);  // [2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ntiles = (np_pad + tile_lanes - 1) / tile_lanes;
  // tile t goes to buffer t & 1 and completes on full[t & 1]
  auto issue = [&](int t) {
    const int l0 = t * tile_lanes;
    const uint32_t bytes = (uint32_t)min(tile_lanes, np_pad - l0) * 16u;
    knn::mbar_expect_tx(full + (t & 1), bytes);
    knn::bulk_load(tiles + (t & 1) * tile_lanes, p4 + l0, bytes,
                   full + (t & 1));
  };
  if (tid == 0) {
    knn::mbar_init(full, 1);
    knn::mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) issue(0);

  const long long row0 = (long long)blockIdx.x * rows + warp * kWarpRows;
  float* wd2 = rd2 + warp * kWarpRows * S * 32;
  int* widx = ridx + warp * kWarpRows * S * 32;
  const int kth_at = ((k - 1) % S) * 32 + (k - 1) / S;
  bool valid[kWarpRows];
  knn::WarpQueries wq;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const long long row = row0 + r;
    valid[r] = row < nq;
    wq.x[r] = valid[r] ? q_pts[row * 3 + 0] : 0.f;
    wq.y[r] = valid[r] ? q_pts[row * 3 + 1] : 0.f;
    wq.z[r] = valid[r] ? q_pts[row * 3 + 2] : 0.f;
  }
  knn::load_warp_rows<S>(d2, idx, row0, valid, wd2, widx, k, kth_at, wq);

  for (int t = 0; t < ntiles; ++t) {
    if (t) __syncthreads();  // every warp is done with tile t-1's buffer
    if (tid == 0 && t + 1 < ntiles) issue(t + 1);
    knn::mbar_wait(full + (t & 1), (t >> 1) & 1);
    knn::fold_tile<S>(tiles + (t & 1) * tile_lanes,
                      min(tile_lanes, np_pad - t * tile_lanes), wq, wd2, widx,
                      k, kth_at);
  }
  knn::store_warp_rows<S>(d2, idx, row0, valid, wd2, widx, k);
}

// knn_bf_d3_kernel with the wide fold (knn_rows.cuh) for k above
// knn::kSlotsMaxK: the rows folded in place in d2 / idx through pending
// buffers in shared memory, merged when full and once at the end. The
// tiles go round a ring of kWideStages stages that no barrier of the block
// holds: each warp waits for a tile's copy on its stage's mbarrier, counts
// itself done with it after folding it, and the last warp done refills the
// stage with the tile kWideStages on. So a warp whose rows merge more in a
// stretch of tiles holds the others back only when it falls kWideStages - 1
// tiles behind, where a barrier a tile made the block wait for its slowest
// warp at every tile.
__global__ void __launch_bounds__(knn::kD3MaxThreads, 1)
    knn_bf_d3_wide_kernel(const float* __restrict__ q_pts,  // [nq, 3]
                          const float4* __restrict__ p4,    // [np_pad]
                          float* __restrict__ d2,           // [nq, k]
                          int* __restrict__ idx,            // [nq, k]
                          int nq, int np_pad, int k, int tile_lanes) {
  using knn::kWarpRows;
  using knn::kWideStages;
  constexpr int kSteps = knn::kWideStepsFlat;
  extern __shared__ __align__(16) unsigned char sbuf[];
  const int warps = blockDim.x >> 5;
  const int rows = warps * kWarpRows;
  float4* tiles = reinterpret_cast<float4*>(sbuf);  // [kWideStages][lanes]
  unsigned char* wide =
      reinterpret_cast<unsigned char*>(tiles + kWideStages * tile_lanes);
  uint64_t* full =  // [kWideStages]
      reinterpret_cast<uint64_t*>(wide + warps * knn::kWideWarpBytes);
  // warps done with each stage, over all its tiles
  unsigned* used = reinterpret_cast<unsigned*>(full + kWideStages);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntiles = (np_pad + tile_lanes - 1) / tile_lanes;
  // tile t goes to stage t % kWideStages and completes on its mbarrier
  auto issue = [&](int t) {
    const int s = t % kWideStages;
    const int l0 = t * tile_lanes;
    const uint32_t bytes = (uint32_t)min(tile_lanes, np_pad - l0) * 16u;
    knn::mbar_expect_tx(full + s, bytes);
    knn::bulk_load(tiles + s * tile_lanes, p4 + l0, bytes, full + s);
  };
  if (tid == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      knn::mbar_init(full + s, 1);
      used[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(kWideStages, ntiles); ++t) issue(t);

  const long long row0 = (long long)blockIdx.x * rows + warp * kWarpRows;
  float* wd2 = d2 + row0 * k;
  int* widx = idx + row0 * k;
  const knn::WideWarp ww =
      knn::wide_warp(wide + warp * knn::kWideWarpBytes, false);
  bool valid[kWarpRows];
  knn::WarpQueries wq;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const long long row = row0 + r;
    valid[r] = row < nq;
    wq.x[r] = valid[r] ? q_pts[row * 3 + 0] : 0.f;
    wq.y[r] = valid[r] ? q_pts[row * 3 + 1] : 0.f;
    wq.z[r] = valid[r] ? q_pts[row * 3 + 2] : 0.f;
  }
  knn::wide_kth(wd2, k, valid, wq);
  int pn[kWarpRows] = {};  // entries pending in each row's buffer

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kWideStages;
    knn::mbar_wait(full + s, (t / kWideStages) & 1);
    knn::fold_tile_wide<kSteps>(tiles + s * tile_lanes,
                                min(tile_lanes, np_pad - t * tile_lanes), wq,
                                pn, wd2, widx, k, ww);
    __syncwarp();
    // the last warp done with the stage refills it, kWideStages on
    const unsigned last = (unsigned)warps * (t / kWideStages + 1) - 1;
    if (lane == 0 && atomicAdd(used + s, 1u) == last &&
        t + kWideStages < ntiles)
      issue(t + kWideStages);
  }
  knn::wide_flush<kSteps>(wq, pn, wd2, widx, k, ww);
}

// Sets the kernel's shared-memory attribute and launches it over nq rows
// (either kernel of this file).
template <class Kernel>
int bf_launch(Kernel kernel, const float* q_pts, const float4* p4, float* d2,
              int* idx, int nq, int np_pad, int k, int threads,
              int tile_lanes, size_t smem, cudaStream_t stream) {
  const int rows = threads / 32 * knn::kWarpRows;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((long long)nq + rows - 1) / rows);
  kernel<<<blocks, threads, smem, stream>>>(q_pts, p4, d2, idx, nq, np_pad,
                                             k, tile_lanes);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus a CUDA error.
template <class Kernel>
int bf_blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Launches knn_bf_d3_kernel on `stream` with the plan of ops/knn_bf.py
// flat_d3_plan: `slots` a lane for a row of k (d3_slots), or 0 for
// knn_bf_d3_wide_kernel (k above knn::kSlotsMaxK, its rows in place in
// d2 / idx); `threads` a block
// (4 query rows a warp), tiles of `tile_lanes` (a multiple of 256, as
// np_pad is) staged lanes, `smem` bytes of dynamic shared memory
// (d3_smem_bytes). Returns the CUDA error code of the launch (0 = ok), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int knn_bf_launch(const float* q_pts, const float* p4, float* d2,
                             int* idx, int nq, int np_pad, int k, int slots,
                             int threads, int tile_lanes, int smem,
                             void* stream) {
  if (threads % 32 || threads > knn::kD3MaxThreads ||
      tile_lanes % knn::kChunkLanes || np_pad % knn::kChunkLanes || k < 1 ||
      (slots ? k > 32 * slots || k > knn::kSlotsMaxK
             : k <= knn::kSlotsMaxK))
    return (int)cudaErrorInvalidValue;
  const float4* p = reinterpret_cast<const float4*>(p4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    return bf_launch(kernel, q_pts, p, d2, idx, nq, np_pad, k, threads,
                     tile_lanes, (size_t)smem, st);
  };
  if (slots == 0) return launch(knn_bf_d3_wide_kernel);
  return knn::with_d3_slots(slots, (int)cudaErrorInvalidValue, [&](auto s) {
    return launch(knn_bf_d3_kernel<decltype(s)::value>);
  });
}

// Blocks of knn_bf_d3_kernel (or, with slots 0, knn_bf_d3_wide_kernel) an
// SM holds at this plan (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// minus a CUDA error.
extern "C" int knn_bf_blocks_per_sm(int slots, int threads, int smem) {
  if (slots == 0)
    return bf_blocks_per_sm(knn_bf_d3_wide_kernel, threads, (size_t)smem);
  return knn::with_d3_slots(slots, -(int)cudaErrorInvalidValue, [&](auto s) {
    return bf_blocks_per_sm(knn_bf_d3_kernel<decltype(s)::value>, threads,
                            (size_t)smem);
  });
}
