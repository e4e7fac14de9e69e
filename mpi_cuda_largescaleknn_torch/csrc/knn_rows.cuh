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
// The traversal kernel's instance for cold rows (fold_tile's kFlatEntry,
// knn_tiled.cu) enters a flat row, one whose k slots all hold its k-th d2
// (a row no lane has entered yet: the cold rows of init_candidates, into
// which the warm start's one visit folds), without inserts: the
// sequential fold would leave in it the chunk's lanes below that d2, the
// smallest k by (d2, lane), followed by the row's own entries in their
// order. One bitonic sort of the chunk's keys (d2 bits, lane) across the
// warp gives those lanes, and the warp writes the row whole
// (enter_flat_row_chunk): the same bits.
//
// Above kSlotsMaxK the kernels fold with the wide fold instead (below:
// knn_bf_d3_wide_kernel, knn_tiled_d3_wide_kernel), which is faster there
// (tools/torch_d3_k_sweep.py).

constexpr int kWarpRows = 4;      // query rows a warp folds
constexpr int kChunkGroups = 8;   // lanes a thread scores per row a chunk
constexpr int kChunkLanes = 32 * kChunkGroups;
constexpr int kD3MaxThreads = 512;  // __launch_bounds__(512, 2): 64 registers
constexpr unsigned kFull = 0xffffffffu;
// the largest k of the instances of S slots a lane that the launch plans
// take (ops/knn_tiled.py D3_SLOTS_MAX_K): above it the wide fold is faster
// (tools/torch_d3_k_sweep.py), so the launchers refuse slots a lane there
constexpr int kSlotsMaxK = 128;

// Calls f(std::integral_constant<int, S>{}) for S = `slots`, the slots a
// lane holds for a row (ops/knn_tiled.py d3_slots: a power of two >= k/32,
// so the kernels have one instance each for S in 1, 2, 4, up to
// kSlotsMaxK), and returns its result; `out_of_range` for any other S.
// Host code: the launchers dispatch on it.
template <class F>
int with_d3_slots(int slots, int out_of_range, F&& f) {
  switch (slots) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
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

// Sorts the warp's 32 * N keys ascending: key e of lane l holds position
// l * N + e. A bitonic network: its exchanges across lanes take a shuffle,
// those within a lane swap registers.
template <int N>
__device__ __forceinline__ void warp_sort_keys(unsigned long long (&key)[N]) {
  static_assert(N > 0 && (N & (N - 1)) == 0, "N is a power of two");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        // position i ascends with its partner i ^ stride where i & size
        // is 0, and descends with it elsewhere
        const bool up = ((lane * N + e) & size) == 0;
        if (stride >= N) {
          const int ls = stride / N;
          const unsigned long long o = __shfl_xor_sync(kFull, key[e], ls);
          // the lower position of the pair keeps the smaller key going up
          const bool keep_min = ((lane & ls) == 0) == up;
          key[e] = keep_min == (o < key[e]) ? o : key[e];
        } else if ((e & stride) == 0) {
          const int p = e | stride;
          const unsigned long long a = key[e];
          const unsigned long long b = key[p];
          if (up == (b < a)) {
            key[e] = b;
            key[p] = a;
          }
        }
      }
    }
  }
}

// The fold of the kChunkLanes lanes of `chunk` into a flat row of the warp
// (every slot holding the k-th d2 R, which kth holds): the row becomes the
// chunk's lanes below R, the smallest k by (d2, lane), then its own entries
// in their order, the last of them dropping past k. That is the sequential
// fold's result, each lane entering after every entry <= it. Returns the
// row's new k-th d2. A call of its own: its sort's registers stay out of
// the fold's loop.
template <int S>
__device__ __noinline__ float enter_flat_row_chunk(const float4* chunk,
                                                   float qx, float qy,
                                                   float qz, float* rd2,
                                                   int* ridx, int k,
                                                   int kth_at, float kth) {
  const int lane = threadIdx.x & 31;
  unsigned long long key[kChunkGroups];
  int below = 0;  // the chunk's lanes below R
#pragma unroll
  for (int j = 0; j < kChunkGroups; ++j) {
    const float dd = dist2_3(qx, qy, qz, chunk[j * 32 + lane]);
    const bool in = dd < kth;
    below += __popc(__ballot_sync(kFull, in));
    // d2 >= +0 (or NaN, never in), so its bits order as the floats do
    key[j] = in ? (unsigned long long)__float_as_uint(dd) << 32 |
                      (unsigned)(j * 32 + lane)
                : ~0ull;
  }
  warp_sort_keys<kChunkGroups>(key);
  const int took = min(below, k);
  float od2[S];
  int oid[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    od2[s] = rd2[s * 32 + lane];
    oid[s] = ridx[s * 32 + lane];
  }
  __syncwarp();
  // slot i = lane * S + s at [s * 32 + lane]
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = lane * S + s + took;
    if (i < k) {
      rd2[(i % S) * 32 + i / S] = od2[s];
      ridx[(i % S) * 32 + i / S] = oid[s];
    }
  }
#pragma unroll
  for (int e = 0; e < kChunkGroups; ++e) {
    const int i = lane * kChunkGroups + e;
    if (i < took) {
      rd2[(i % S) * 32 + i / S] = __uint_as_float((unsigned)(key[e] >> 32));
      ridx[(i % S) * 32 + i / S] =
          __float_as_int(chunk[(unsigned)key[e] & 0xffffu].w);
    }
  }
  __syncwarp();
  return rd2[kth_at];
}

// The warp's query rows: coordinates and k-th d2 (-inf for a row that
// folds nothing), the same in every lane.
struct WarpQueries {
  float x[kWarpRows], y[kWarpRows], z[kWarpRows], kth[kWarpRows];
};

// Folds the `nl` staged lanes of `tile` (a multiple of kChunkLanes) into
// the warp's rows, whose slots start at rd2 / ridx (row r at r * S * 32);
// with kFlatEntry a flat row enters by enter_flat_row_chunk.
template <int S, bool kFlatEntry = false>
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
      if (__any_sync(kFull, mn[r] < wq.kth[r])) {
        // slot 0 holds the row's least d2: flat where it is the k-th's
        if (kFlatEntry && rd2[r * S * 32] == wq.kth[r])
          wq.kth[r] = enter_flat_row_chunk<S>(
              tile + c0, wq.x[r], wq.y[r], wq.z[r], rd2 + r * S * 32,
              ridx + r * S * 32, k, kth_at, wq.kth[r]);
        else
          fold_row_chunk<S>(tile + c0, wq.x[r], wq.y[r], wq.z[r],
                            rd2 + r * S * 32, ridx + r * S * 32, k, kth_at,
                            wq.kth[r]);
      }
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
// memory (a warp's 4 rows are consecutive there), so any k runs. A passing
// lane is not inserted at once: each row keeps a pending buffer of up to
// kWideBuffer entries in shared memory, filled in lane order against the
// row's k-th d2 as of its last merge (a superset of what the sequential
// fold adopts: its k-th only shrinks). The gate scores a chunk against the
// warp's 4 rows and keeps, per row, which groups of 32 lanes hold a lane
// below the row's k-th; the row then goes over those groups only, and a
// passing lane writes its (d2, id) to slot pn + (the passing lanes below
// it in its group): a ballot and a population count, no shuffle. The
// buffer is merged into the row when the next group would overflow it,
// and at the end of the fold; the traversal merges it besides where a
// prune decision needs a row's exact k-th d2 (the kernel's lazy flush).
//
// A merge (a call of its own, so that the gate's loop keeps its registers)
// sorts the buffer once by the key (d2 bits, slot) (a bitonic sort of
// 64-bit keys in registers, left in the warp's scratch in shared memory:
// slot order is arrival order), then walks the row from its end down, 32
// slots a step and kSteps steps a round, their reads before their writes
// (kWideStepsTraversal or kWideStepsFlat: each kernel's best of 1 to 8
// steps as measured on the card, PERF.md). Each row entry moves up by
// the number of pending entries strictly below it (row entries win
// ties), and each pending entry lands after the row entries <= it: ranks
// taken by ballots against the step's entries, one for each of the few
// pending entries whose place falls in the step. The walk stops at the
// step below which no pending entry falls.
// So each slot of the affected tail is read once and written once a
// merge, for up to kWideBuffer adoptions, and whatever lands at k or
// beyond drops. That leaves the k smallest of (the row, then the lanes) by
// (d2, arrival): the sequential fold's bits.
//
// The kernels take 128 registers a thread (__launch_bounds__(512, 1)):
// with 64 the gate's loop spilled, and their buffers hold an SM to 16
// warps either way (PERF.md records the choices measured on the card).

// entries of a row's pending buffer (ops/knn_tiled.py WIDE_BUFFER), and the
// length of the sort's scratch, a power of two >= it (WIDE_SORT)
constexpr int kWideBuffer = 248;
constexpr int kWideSort = 256;
// 32-slot steps a merge round reads: each wide kernel's own
constexpr int kWideStepsTraversal = 2;
constexpr int kWideStepsFlat = 4;
// the flat kernel's ring: staged tiles in flight (WIDE_STAGES), each stage
// refilled by the last warp done with it, so a warp may run up to
// kWideStages - 1 tiles ahead of the block's slowest; and the shared
// memory of the kernels' barriers, counts and radius slots
// (WIDE_CTRL_BYTES)
constexpr int kWideStages = 8;
constexpr int kWideCtrlBytes = 1024;
// shared memory of a warp's buffers: the sort's keys and its rows' pending
// d2 and ids (ops/knn_tiled.py WIDE_WARP_BYTES)
constexpr int kWideWarpBytes = kWideSort * 8 + kWarpRows * kWideBuffer * 8;
static_assert(kWideBuffer <= kWideSort && kWideSort >= 32 &&
                  (kWideSort & (kWideSort - 1)) == 0,
              "the sort's scratch is a power of two of at least a key a "
              "lane that holds a buffer");
// the traversal keeps, beside each row's buffer, the row's last
// kWideBuffer + 1 entries' d2 as of its last merge (its bounds' source),
// a warp's taking kWideTailBytes more (WIDE_TAIL_BYTES)
constexpr int kWideTailBytes =
    (kWarpRows * (kWideBuffer + 1) * 4 + 15) / 16 * 16;
static_assert(kWideWarpBytes % 16 == 0, "warp stretches stay 16-aligned");

// A warp's stretch of shared memory for the wide fold.
struct WideWarp {
  unsigned long long* key;  // [kWideSort] the sort's scratch
  float* d2;                // [kWarpRows][kWideBuffer] pending d2, by arrival
  int* id;                  // [kWarpRows][kWideBuffer] their ids
  float* tail;  // [kWarpRows][kWideBuffer + 1] the rows' tails, or null
};

// The warp's buffers at base, and with `tails` the rows' tails after them.
__device__ __forceinline__ WideWarp wide_warp(unsigned char* base,
                                              bool tails) {
  WideWarp w;
  w.key = reinterpret_cast<unsigned long long*>(base);
  w.d2 = reinterpret_cast<float*>(w.key + kWideSort);
  w.id = reinterpret_cast<int*>(w.d2 + kWarpRows * kWideBuffer);
  w.tail = tails ? reinterpret_cast<float*>(base + kWideWarpBytes) : nullptr;
  return w;
}

// Row r's tail (entries k-1-kWideBuffer .. k-1 of its d2; 0 before the
// row's start), or null.
__device__ __forceinline__ float* wide_tail(const WideWarp& ww, int r) {
  return ww.tail ? ww.tail + r * (kWideBuffer + 1) : nullptr;
}

// Copies the row's last kWideBuffer + 1 d2 into its tail. All 32 lanes
// call it.
__device__ __forceinline__ void wide_keep_tail(const float* rd2, int k,
                                               float* tail) {
  for (int j = threadIdx.x & 31; j <= kWideBuffer; j += 32) {
    const int i = k - 1 - kWideBuffer + j;
    tail[j] = i >= 0 ? rd2[i] : 0.f;
  }
  __syncwarp();
}

// A sort key that orders d2 >= 0 (never NaN) and, among equal d2, slots.
__device__ __forceinline__ unsigned long long wide_key(float d, unsigned s) {
  return (unsigned long long)__float_as_uint(d) << 32 | s;
}

// Sorts the n pending entries' keys (d2 bits, slot) ascending into
// keys[0, kWideSort), padded with ~0: a bitonic sort in registers, lane l
// holding keys l * kPer .. l * kPer + kPer - 1, so a compare-exchange
// across fewer than kPer keys stays in a lane and a wider one is a shuffle.
// All 32 lanes call it.
__device__ __forceinline__ void wide_sort(unsigned long long* keys,
                                          const float* pd2, int n) {
  constexpr int kPer = kWideSort / 32;
  const int lane = threadIdx.x & 31;
  unsigned long long key[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = lane * kPer + e;
    key[e] = j < n ? wide_key(pd2[j], j) : ~0ull;
  }
#pragma unroll
  for (int size = 2; size <= kWideSort; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride; stride >>= 1) {
      if (stride < kPer) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if ((e & stride) == 0) {
            // ascending in runs of size
            const bool up = ((lane * kPer + e) & size) == 0;
            const unsigned long long a = key[e], b = key[e | stride];
            if ((a > b) == up) {
              key[e] = b;
              key[e | stride] = a;
            }
          }
      } else {
        const int across = stride / kPer;
        const bool lower = (lane & across) == 0;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const bool up = ((lane * kPer + e) & size) == 0;
          const unsigned long long o = __shfl_xor_sync(kFull, key[e], across);
          // the lower index keeps the smaller key where the run ascends
          key[e] = (lower == up) == (o < key[e]) ? o : key[e];
        }
      }
    }
#pragma unroll
  for (int e = 0; e < kPer; ++e) keys[lane * kPer + e] = key[e];
  __syncwarp();
}

// Merges the n pending entries (pd2, pid, in arrival order) into the
// warp's row (rd2, ridx) of k entries, as above. Every pending d2 is below
// the row's k-th. Returns the new k-th d2. All 32 lanes call it with the
// same row and n.
//
// A step holds the row's slots i0 .. i0 + 31 (+inf past k). The pending
// entries that land among them are the sorted keys [lo, hi): hi carries
// over from the step above (n at the top: every pending d2 is below the
// row's k-th), and lo is hi less the run of keys just below it that are
// not below the entry under the step (one load a lane and a ballot: the
// keys are sorted). For each of those few entries in turn (a broadcast
// load), one ballot of the step's entries above it gives both its place
// (after the step's others) and the shift it adds to the entries above.
template <int kSteps>
__device__ __noinline__ float wide_merge(float* rd2, int* ridx, int k,
                                            const float* pd2, const int* pid,
                                            int n, unsigned long long* keys,
                                            float* tail) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the buffer's entries, written by every lane
  wide_sort(keys, pd2, n);
  int hi = n;
  int c = ((k - 1) >> 5) << 5;
  for (bool done = false; !done; c -= 32 * kSteps) {
    float v[kSteps], prev[kSteps];
    int w[kSteps];
#pragma unroll
    for (int g = 0; g < kSteps; ++g) {
      const int i0 = c - 32 * g;
      const int i = i0 + lane;
      const bool real = i >= 0 && i < k;
      v[g] = real ? rd2[i] : CUDART_INF_F;
      w[g] = real ? ridx[i] : -1;
      // the entry under the step (the same for every lane)
      prev[g] = i0 > 0 ? rd2[i0 - 1] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kSteps; ++g) {
      if (!done) {
        const int i0 = c - 32 * g;
        const int i = i0 + lane;
        int lo = 0;
        if (i0 > 0) {
          const unsigned long long under = wide_key(prev[g], 0);
          for (lo = hi;;) {
            const int j = lo - 1 - lane;
            const unsigned run =
                __ballot_sync(kFull, j >= 0 && keys[j] >= under);
            lo -= __popc(run);
            if (run != kFull) break;
          }
        }
        int up = lo;  // pending entries below this lane's entry
        for (int j0 = lo; j0 < hi; j0 += 32) {
          const int m = min(32, hi - j0);
          int place = 0;  // lane t: the step's entries <= entry j0 + t
          for (int t = 0; t < m; ++t) {
            const float d =
                __uint_as_float((unsigned)(keys[j0 + t] >> 32));
            const unsigned above = __ballot_sync(kFull, v[g] > d);
            up += (above >> lane) & 1u;
            if (lane == t) place = 32 - __popc(above);
          }
          if (lane < m) {
            const unsigned long long key = keys[j0 + lane];
            const int pos = j0 + lane + i0 + place;
            if (pos < k) {
              rd2[pos] = __uint_as_float((unsigned)(key >> 32));
              ridx[pos] = pid[(unsigned)key];
            }
          }
        }
        if (up && i < k && i + up < k) {
          rd2[i + up] = v[g];
          ridx[i + up] = w[g];
        }
        hi = lo;
        done = lo == 0;
      }
    }
  }
  __syncwarp();
  if (tail) wide_keep_tail(rd2, k, tail);
  return rd2[k - 1];
}

// Folds the groups of 32 lanes of `chunk` that `groups` flags (bit j:
// lanes j * 32 .. j * 32 + 31) into one row of the warp, in lane order,
// through its pending buffer (pd2, pid, pn entries), merging it first where
// a group would overflow it; kth is the row's k-th d2 as of its last
// merge. A group left out has no lane below kth.
template <int kSteps>
__device__ __forceinline__ void fold_row_chunk_wide(
    const float4* chunk, unsigned groups, float qx, float qy, float qz,
    float* rd2, int* ridx, int k, float& kth, float* pd2, int* pid, int& pn,
    unsigned long long* keys, float* tail) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
#pragma unroll 1
  for (; groups; groups &= groups - 1) {
    const int j = __ffs(groups) - 1;
    const float4 p = chunk[j * 32 + lane];
    const float dd = dist2_3(qx, qy, qz, p);
    unsigned m = __ballot_sync(kFull, dd < kth);
    if (pn + __popc(m) > kWideBuffer) {
      kth = wide_merge<kSteps>(rd2, ridx, k, pd2, pid, pn, keys, tail);
      pn = 0;
      m = __ballot_sync(kFull, dd < kth);
    }
    if ((m >> lane) & 1u) {
      const int slot = pn + __popc(m & lower);
      pd2[slot] = dd;
      pid[slot] = __float_as_int(p.w);
    }
    pn += __popc(m);
  }
}

// Folds the `nl` staged lanes of `tile` (a multiple of kChunkLanes) into
// the warp's rows (row r at rd2 + r * k), each through its pending buffer
// (pn[r] entries). The gate scores a chunk's lanes against the warp's 4
// rows (one float4 load feeds them) and keeps, per row, which of its
// groups of 32 lanes hold a lane below the row's k-th d2: the row folds
// those groups only.
template <int kSteps>
__device__ __forceinline__ void fold_tile_wide(const float4* tile, int nl,
                                               WarpQueries& wq,
                                               int (&pn)[kWarpRows],
                                               float* rd2, int* ridx, int k,
                                               const WideWarp& ww) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < nl; c0 += kChunkLanes) {
    unsigned pass[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) pass[r] = 0u;
#pragma unroll
    for (int j = 0; j < kChunkGroups; ++j) {
      const float4 p = tile[c0 + j * 32 + lane];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
        pass[r] |= (unsigned)(dist2_3(wq.x[r], wq.y[r], wq.z[r], p) <
                              wq.kth[r]) << j;
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const unsigned groups = __reduce_or_sync(kFull, pass[r]);
      if (groups)
        fold_row_chunk_wide<kSteps>(
            tile + c0, groups, wq.x[r], wq.y[r], wq.z[r], rd2 + r * k,
            ridx + r * k, k, wq.kth[r], ww.d2 + r * kWideBuffer,
            ww.id + r * kWideBuffer, pn[r], ww.key, wide_tail(ww, r));
    }
  }
}

// Merges every non-empty pending buffer into its row, so that wq.kth holds
// the rows' exact k-th d2: the flat fold once at its end; the traversal at
// its end and where a prune decision needs the exact radius.
template <int kSteps>
__device__ __forceinline__ void wide_flush(WarpQueries& wq,
                                           int (&pn)[kWarpRows], float* rd2,
                                           int* ridx, int k,
                                           const WideWarp& ww) {
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
    if (pn[r]) {
      wq.kth[r] = wide_merge<kSteps>(rd2 + r * k, ridx + r * k, k,
                             ww.d2 + r * kWideBuffer,
                             ww.id + r * kWideBuffer, pn[r], ww.key,
                             wide_tail(ww, r));
      pn[r] = 0;
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

// Bounds on the largest exact k-th d2 of the warp's rows (0 where none
// folds), what a merge of their buffers would leave: (lower, upper). A row
// with n pending entries keeps at least its k - n smallest entries, so its
// (k - n)-th is at most the exact k-th (+inf there means the row stays
// short of k finite entries: the k-th is +inf; 0 where n >= k), read from
// its tail; its k-th as of its last merge is at least it.
__device__ __forceinline__ float2 wide_bounds(const WideWarp& ww,
                                              const int (&pn)[kWarpRows],
                                              const WarpQueries& wq) {
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    hi = fmaxf(hi, wq.kth[r]);
    lo = fmaxf(lo, pn[r] == 0 ? wq.kth[r]
                              : wide_tail(ww, r)[kWideBuffer - pn[r]]);
  }
  return make_float2(lo, hi);
}

}  // namespace knn
