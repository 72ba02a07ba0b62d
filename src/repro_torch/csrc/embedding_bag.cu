// EmbeddingBag for Hopper (sm_90a), fp32:
//
//   out[b] = sum_{offsets[b] <= i < offsets[b+1]} weights[i] * table[ids[i]]
//
// over ids sorted by bag, every bag written (an empty bag as zeros).
//
// Replaces repro/kernels/embedding_bag.py::embedding_bag, the Pallas TPU
// kernel.  Its grid takes one id per step and keeps the bag's output block
// resident from one step to the next (a sequential carry, initialised on a
// bag's first id); CUDA blocks run in parallel and in no order, so a block
// per id would race on the output.  Here each warp owns 32 consecutive bags
// and no other warp touches their rows: lane j reads bag j's [start, end)
// (one coalesced read of the warp's offsets), then the warp walks its bags
// in order, broadcasting each bound with a shuffle.  No atomics, so a run is
// bit-reproducible.  The wrapper hands the table over at its own width (no
// 128-lane padding) and the bag offsets instead of a bag id per entry.
//
//   d >= 32 (the deep lookup, d = 32): lanes over columns, so one id's row is
//     one coalesced 128-B segment per 32 columns.  The warp walks the ids of
//     its 32 bags as one contiguous range (they are sorted by bag), 32 ids
//     at a time: it reads their ids and weights coalesced, starts all 32 row
//     loads before the first add (the next rows are in flight while the
//     current one is added, across bag boundaries, so single-id bags
//     pipeline too), then adds them in order, storing a bag's row when the
//     walk passes its end.
//   d < 32 (the wide lookup, d = 1): lanes over the bag's ids, a warp-shuffle
//     sum per column; lanes over columns would idle 31 of 32 lanes.  Lane j
//     keeps bag j's sum, so the warp's 32 results leave in one store.
//
// What bounds it on an H100: bytes.  Each id brings one table row (4d B)
// and 8 B of id and weight; each bag writes 4d B.  The deep lookup at
// B = 65,536 x 40 fields moves ~0.7 GB (~0.21 ms at 3.35 TB/s); the
// backward, the same kernel over the transposed bag list with one bag per
// table row, writes the whole table gradient (5.12 GB at 40 M x 32, ~1.5 ms).
// The warps are persistent (a grid of the card's resident blocks striding
// over the bag groups), so 40 M mostly empty bags cost stores, not block
// launches.  Plain fp32 FMA in the ids' order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // warps per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Lanes over columns; the group's bags are [b0, b0 + nb), lane j holding
// bag j's end in `my_end`, and their ids the positions [S, E).
__device__ __forceinline__ void bag_rows(
    const int32_t* __restrict__ ids, const float* __restrict__ weights,
    const float* __restrict__ table, float* __restrict__ out, int b0, int nb,
    int my_end, int S, int E, int d, int lane) {
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < d;
    float acc = 0.f;
    int j = 0;                                    // the bag being summed
    int e_j = __shfl_sync(kFull, my_end, 0);
    for (int p0 = S; p0 < E; p0 += 32) {
      const int n = min(32, E - p0);
      int my_id = 0;
      float my_w = 0.f;
      if (lane < n) {
        my_id = __ldg(ids + p0 + lane);
        my_w = __ldg(weights + p0 + lane);
      }
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int id = __shfl_sync(kFull, my_id, t);
        v[t] = (t < n && on) ? __ldg(table + static_cast<size_t>(id) * d + c)
                             : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t < n) {
          // close every bag that ends here, empty ones included; position
          // p0 + t < E lies in a later bag, so j stays below nb
          while (e_j == p0 + t) {
            if (on) out[static_cast<size_t>(b0 + j) * d + c] = acc;
            acc = 0.f;
            ++j;
            e_j = __shfl_sync(kFull, my_end, j);
          }
          acc = fmaf(__shfl_sync(kFull, my_w, t), v[t], acc);
        }
      }
    }
    // the bag holding the last position, then the empty bags after it
    for (; j < nb; ++j) {
      if (on) out[static_cast<size_t>(b0 + j) * d + c] = acc;
      acc = 0.f;
    }
  }
}

// Lanes over each bag's ids, a butterfly sum per column.
__device__ __forceinline__ void bag_sums(
    const int32_t* __restrict__ ids, const float* __restrict__ weights,
    const float* __restrict__ table, float* __restrict__ out, int b0, int nb,
    int my_start, int my_end, int d, int lane) {
  for (int c = 0; c < d; ++c) {
    float res = 0.f;
    for (int j = 0; j < nb; ++j) {
      const int s = __shfl_sync(kFull, my_start, j);
      const int e = __shfl_sync(kFull, my_end, j);
      if (s == e) continue;                       // empty: lane j keeps 0
      float part = 0.f;
      for (int i = s + lane; i < e; i += 32)
        part = fmaf(__ldg(weights + i),
                    __ldg(table + static_cast<size_t>(__ldg(ids + i)) * d + c),
                    part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (lane == j) res = part;
    }
    if (lane < nb) out[static_cast<size_t>(b0 + lane) * d + c] = res;
  }
}

__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ weights,
                     const float* __restrict__ table,
                     float* __restrict__ out, int num_bags, int d) {
  const int lane = threadIdx.x & 31;
  const int n_groups = (num_bags + 31) / 32;
  const int n_warps = gridDim.x * kWarps;
  for (int grp = blockIdx.x * kWarps + (threadIdx.x >> 5); grp < n_groups;
       grp += n_warps) {
    const int b0 = grp * 32;
    const int nb = min(32, num_bags - b0);
    int my_start = 0, my_end = 0;
    if (lane < nb) {
      my_start = __ldg(offsets + b0 + lane);
      my_end = __ldg(offsets + b0 + lane + 1);
    }
    if (d >= 32) {
      const int S = __shfl_sync(kFull, my_start, 0);
      const int E = __shfl_sync(kFull, my_end, nb - 1);
      bag_rows(ids, weights, table, out, b0, nb, my_end, S, E, d, lane);
    } else {
      bag_sums(ids, weights, table, out, b0, nb, my_start, my_end, d, lane);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers: offsets
// (num_bags + 1) int32, non-decreasing, offsets[0] = 0; ids (L) int32, each
// a row of table; weights (L) fp32; table (V, d) fp32; out (num_bags, d)
// fp32, every row written.  Launches on `stream`, does not synchronise, and
// returns the first CUDA error (0 on success).
extern "C" int embedding_bag(const int32_t* offsets, const int32_t* ids,
                             const float* weights, const float* table,
                             float* out, int num_bags, int d, void* stream) {
  if (num_bags <= 0) return 0;
  static int resident = 0;        // blocks the whole card holds at once
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, embedding_bag_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
  }
  const int n_groups = (num_bags + 31) / 32;
  const int blocks = min((n_groups + kWarps - 1) / kWarps, resident);
  embedding_bag_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      offsets, ids, weights, table, out, num_bags, d);
  return static_cast<int>(cudaGetLastError());
}
