// SDDMM for Hopper (sm_90a), fp32: per-edge dot products
//
//   out[e] = < q[src[e]], k[dst[e]] >
//
// Replaces repro/kernels/sddmm.py::sddmm, the Pallas TPU kernel: one edge
// per grid step, the two rows gathered by scalar-prefetched index maps,
// with d padded to 128 lanes by the wrapper.  Here a warp splits into
// groups of C lanes, one edge a group: C = min(32, d/4) rounded down to a
// power of two (16 at d = 64, so a warp works 2 edges at once), or C = 1
// below d = 16 (a lane per edge, summing its d columns itself, with no
// shuffle).  A warp takes a few rounds of edges, 8 edges in all (32 where
// C = 1), so Cora's 10,556 edges give 1,320 warps at d = 64 instead of 330.
// Each lane issues every row load of every round before its first FMA, so
// the gathers of a warp's 8 edges overlap; then a butterfly within each
// group, and the warp's scores leave in one store.  Rows are read as float4
// where q and k are 16-byte aligned and d % 4 == 0, else as floats, in the
// same kernel.  q and k keep their own width (no padding), any edge count
// is taken, and there are no atomics, so a rerun is bit-identical.
//
// What bounds it on an H100: bytes, the two gathered rows of 4d B per edge
// (2d FLOP per edge).  On Cora (10,556 edges, d = 64) the rows q and k hold
// are ~1.4 MB, well inside the 50 MB L2; a launch is a few microseconds,
// so the launch and two dependent round trips (indices, then rows), not
// HBM, are what it sees.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRounds = 8;        // most rounds of edges a warp takes
constexpr int kEdges = 8;         // edges a warp takes where C > 1

template <typename T>
__device__ __forceinline__ float dot(T a, T b, float acc);
template <>
__device__ __forceinline__ float dot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
template <>
__device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// T: float4 (cols = d / 4) or float (cols = d); C lanes per edge, `rounds`
// edges a group.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const T* __restrict__ q, const T* __restrict__ k,
             float* __restrict__ out, long long n_edges, int cols, int C,
             int rounds) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / C, g = lane / C, li = lane % C;
  const int per_warp = groups * rounds;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      per_warp;
  if (e0 >= n_edges) return;                      // the whole warp leaves
  // edge of round r: e0 + r * groups + g
  const T* qr[kRounds];
  const T* kr[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long e = e0 + r * groups + g;
    qr[r] = kr[r] = nullptr;
    if (r < rounds && e < n_edges) {
      qr[r] = q + static_cast<size_t>(__ldg(src + e)) * cols;
      kr[r] = k + static_cast<size_t>(__ldg(dst + e)) * cols;
    }
  }
  float part[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) part[r] = 0.f;
  for (int c = li; c < cols; c += C) {
    T a[kRounds], b[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (qr[r]) {
        a[r] = __ldg(qr[r] + c);
        b[r] = __ldg(kr[r] + c);
      }
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
      if (qr[r]) part[r] = dot(a[r], b[r], part[r]);
  }
  // a butterfly within each group (C is a power of two), then lane l takes
  // the score of edge e0 + l: round l / groups, group l % groups
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r >= rounds) break;                       // warp-uniform
    for (int off = C >> 1; off > 0; off >>= 1)
      part[r] += __shfl_xor_sync(kFull, part[r], off);
    const float v = __shfl_sync(kFull, part[r], (lane % groups) * C);
    if (lane / groups == r) mine = v;
  }
  if (lane < per_warp && e0 + lane < n_edges) out[e0 + lane] = mine;
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers: src and dst
// (E) int32, rows of q and k; q (N, d) and k (M, d) fp32; out (E) fp32.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).
extern "C" int sddmm(const int32_t* src, const int32_t* dst, const float* q,
                     const float* k, float* out, int n_edges, int d,
                     void* stream) {
  if (n_edges <= 0 || d <= 0) return 0;
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k)) & 15) == 0;
  int C = 1;
  if (d >= 16)
    while (C < 32 && 2 * C <= d / 4) C *= 2;
  const int groups = 32 / C;
  const int rounds = groups >= kEdges ? 1 : kEdges / groups;
  const long long per_block = static_cast<long long>(groups) * rounds * kWarps;
  const long long blocks = (n_edges + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    sddmm_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src, dst, reinterpret_cast<const float4*>(q),
        reinterpret_cast<const float4*>(k), out, n_edges, d / 4, C, rounds);
  else
    sddmm_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src, dst, q, k, out, n_edges, d, C, rounds);
  return static_cast<int>(cudaGetLastError());
}
