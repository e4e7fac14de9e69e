// Device helpers of the port's chunk-ring kernels (sm_90a): mbarriers,
// bulk copies into shared memory, and the consumer threads' own barrier.
//
// A ring kernel has one producer thread that copies chunks of a visited
// bucket into `stages` shared-memory stages with cp.async.bulk, each
// completing on the stage's full mbarrier, and consumer warps that wait on
// it, read the chunk and arrive on the stage's empty mbarrier. Both sides
// count chunks along the same walk: chunk n uses stage n % stages at phase
// parity (n / stages) & 1. No TMA tensor map is used, so the libraries need
// no driver API.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace knn {

// Blocks a launch may have along the grid's y axis (the rows of a query
// bucket): a bucket with more goes in several launches, each given the
// block it starts at (ops/knn_tiled.py grid_y_pieces).
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of asynchronous copies on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Whether the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Spins until the phase with parity `parity` has completed. The loop is
// inside the asm, so the compiler sees no divergent path before the
// products that follow (one would serialize wgmma products).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier of the block's first kThreads threads, the consumers (named
// barrier 1; the producer warp comes after them and never joins).
template <int kThreads>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// Max of v over the consumer threads. `red` holds two sets of kThreads/32
// (one per consumer warp) used in turn, so one barrier a call suffices.
template <int kThreads>
__device__ __forceinline__ float consumer_max(float v, float* red,
                                              int parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  float* set = red + parity * (kThreads / 32);
  if ((threadIdx.x & 31) == 0) set[threadIdx.x >> 5] = v;
  consumer_sync<kThreads>();
  v = set[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, set[i]);
  return __shfl_sync(0xffffffffu, v, 0);  // known warp-uniform
}

}  // namespace knn
