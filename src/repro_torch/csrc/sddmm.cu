// SDDMM for Hopper (sm_90a), fp32: per-edge dot products
//
//   out[e] = < q[src[e]], k[dst[e]] >
//
// Replaces repro/kernels/sddmm.py::sddmm, the Pallas TPU kernel: one edge
// per grid step, the two rows gathered by scalar-prefetched index maps,
// with d padded to 128 lanes by the wrapper.  Here each CUDA block owns a
// block of 256 edges, 32 per warp: lane j reads edge j's src and dst (one
// coalesced read each), then the warp takes its edges one after the other
// with the lanes over the d columns, an fp32 FMA per column and a butterfly
// shuffle sum; lane j keeps edge j's score, so the warp's 32 scores leave in
// one coalesced store.  q and k keep their own width (no padding) and any
// edge count is taken (no multiple of a block).
//
// What bounds it on an H100: bytes, the two gathered rows of 4d B per edge
// (2d FLOP per edge).  On Cora (10,556 edges, d = 64) the rows q and k hold
// are ~1.4 MB, well inside the 50 MB L2; a launch is a few microseconds,
// so the launch latency, not HBM, is what it sees.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             const float* __restrict__ q, const float* __restrict__ k,
             float* __restrict__ out, long long n_edges, int d) {
  const int lane = threadIdx.x & 31;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (e0 >= n_edges) return;                      // the whole warp leaves
  const int n = static_cast<int>(min(32LL, n_edges - e0));
  int my_src = 0, my_dst = 0;
  if (lane < n) {
    my_src = __ldg(src + e0 + lane);
    my_dst = __ldg(dst + e0 + lane);
  }
  float res = 0.f;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const float* qr = q + static_cast<size_t>(__shfl_sync(kFull, my_src, t)) * d;
    const float* kr = k + static_cast<size_t>(__shfl_sync(kFull, my_dst, t)) * d;
    float part = 0.f;
    for (int c = lane; c < d; c += 32)
      part = fmaf(__ldg(qr + c), __ldg(kr + c), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane == t) res = part;
  }
  if (lane < n) out[e0 + lane] = res;
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers: src and dst
// (E) int32, rows of q and k; q (N, d) and k (M, d) fp32; out (E) fp32.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).
extern "C" int sddmm(const int32_t* src, const int32_t* dst, const float* q,
                     const float* k, float* out, int n_edges, int d,
                     void* stream) {
  if (n_edges <= 0) return 0;
  const long long blocks = (static_cast<long long>(n_edges) + kThreads - 1)
                           / kThreads;
  sddmm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(src, dst, q, k, out,
                                                      n_edges, d);
  return static_cast<int>(cudaGetLastError());
}
