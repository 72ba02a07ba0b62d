// GAT's edge-softmax attention, forward (gat_attention.cuh says what it
// computes and how a warp walks a list).  Two kernels:
//
//   gat::fwd::walk  a warp a (row, head), kWalkRows rows a CUDA block, one
//                   grid row a head; rows of more than kHubEntries entries
//                   are left to
//   gat::fwd::hubs  a CUDA block a (hub, head): its kHubWarps warps take
//                   equal ranges of the list, each with its own running max
//                   and sums, merged in warp order through shared memory
//                   (max of the maxes, each part rescaled by exp(m_w - M)).
//
// Each writes out (n_dst, H, F) and lse (n_dst, H); a row with no entry
// gets 0 in both.

#include "gat_attention.cuh"

namespace gat {
namespace fwd {

// One warp's online softmax over entries [a, b) of `src` for a row whose
// destination score is sd: its running max m, sum l and weighted sum acc
// (m = -inf, l = 0 and acc = 0 where the range is empty).
template <int V, int K>
__device__ __forceinline__ void attend(const int32_t* __restrict__ src, int a,
                                       int b, float sd,
                                       const float* __restrict__ z,
                                       const float* __restrict__ s_src, int H,
                                       int h, float slope, const Cols<V, K>& c,
                                       float& m, float& l, float (&acc)[K][V]) {
  m = -INFINITY;
  l = 0.f;
  zero(acc);
  for (int base = a; base < b; base += 32) {
    const int t = base + c.lane;
    const bool live = t < b;
    const int j = live ? __ldg(src + t) : 0;
    const float e =
        live ? leaky(sd + __ldg(s_src + (long long)j * H + h), slope)
             : -INFINITY;
    const float mn = fmaxf(m, warp_max(e));
    const float scale = expf(m - mn);
    l *= scale;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[k][q] *= scale;
    const float p = live ? expf(e - mn) : 0.f;
    l += warp_sum(p);
    m = mn;
    const int cnt = min(32, b - base);
#pragma unroll 4
    for (int u = 0; u < cnt; ++u) {
      const int ju = __shfl_sync(kFull, j, u);
      const float pu = __shfl_sync(kFull, p, u);
      float r[K][V];
      c.load(head_row(z, ju, H, h, c.f), r);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int q = 0; q < V; ++q) acc[k][q] = fmaf(pu, r[k][q], acc[k][q]);
    }
  }
}

struct Args {
  const int32_t* row_ptr;
  const int32_t* src;
  const int32_t* hubs;
  const int32_t* order;
  const float* z;
  const float* s_src;
  const float* s_dst;
  float* out;
  float* lse;
  int n_hubs, n_dst, H, F;
  float slope;
};

template <int V, int K>
__global__ void __launch_bounds__(32 * kWalkRows) walk(Args g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int blk = g.order != nullptr ? __ldg(g.order + blockIdx.x) : blockIdx.x;
  const long long v = (long long)blk * kWalkRows + warp;
  if (v >= g.n_dst) return;
  const int first = __ldg(g.row_ptr + v);
  const int n = __ldg(g.row_ptr + v + 1) - first;
  if (n > kHubEntries) return;                 // gat::fwd::hubs writes it
  const Cols<V, K> c(lane, g.F);
  float m, l, acc[K][V];
  attend<V, K>(g.src, first, first + n,
               __ldg(g.s_dst + v * g.H + h), g.z, g.s_src, g.H, h, g.slope, c,
               m, l, acc);
  c.store(g.out + (v * g.H + h) * (long long)g.F, acc, n ? 1.f / l : 0.f);
  if (lane == 0) g.lse[v * g.H + h] = n ? m + logf(l) : 0.f;
}

template <int V, int K>
__global__ void __launch_bounds__(kHubThreads) hubs(Args g) {
  extern __shared__ float smem[];
  float* part = smem;                         // [kHubWarps][F]
  float* pm = smem + kHubWarps * g.F;         // [kHubWarps] running maxes
  float* pl = pm + kHubWarps;                 // [kHubWarps] sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const long long v = __ldg(g.hubs + blockIdx.x);
  const int first = __ldg(g.row_ptr + v);
  const int n = __ldg(g.row_ptr + v + 1) - first;
  const int a = first + (int)((long long)warp * n / kHubWarps);
  const int b = first + (int)((long long)(warp + 1) * n / kHubWarps);
  const Cols<V, K> c(lane, g.F);
  float m, l, acc[K][V];
  attend<V, K>(g.src, a, b, __ldg(g.s_dst + v * g.H + h), g.z, g.s_src, g.H,
               h, g.slope, c, m, l, acc);
  c.store(part + warp * g.F, acc, 1.f);
  if (lane == 0) {
    pm[warp] = m;
    pl[warp] = l;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int w = 0; w < kHubWarps; ++w) mx = fmaxf(mx, pm[w]);
  float den = 0.f;
  for (int w = 0; w < kHubWarps; ++w) den += expf(pm[w] - mx) * pl[w];
  float* out = g.out + (v * g.H + h) * (long long)g.F;
  for (int col = threadIdx.x; col < g.F; col += kHubThreads) {
    float o = 0.f;
    for (int w = 0; w < kHubWarps; ++w)
      o += expf(pm[w] - mx) * part[w * g.F + col];
    out[col] = o / den;
  }
  if (threadIdx.x == 0) g.lse[v * g.H + h] = mx + logf(den);
}

template <int V, int K>
int launch(const Args& g, cudaStream_t st) {
  const int blocks = (g.n_dst + kWalkRows - 1) / kWalkRows;
  if (blocks > 0)
    walk<V, K><<<dim3(blocks, g.H), 32 * kWalkRows, 0, st>>>(g);
  if (g.n_hubs > 0) {
    const size_t bytes = sizeof(float) * (kHubWarps * (size_t)g.F + 2 * kHubWarps);
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(hubs<V, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    hubs<V, K><<<dim3(g.n_hubs, g.H), kHubThreads, bytes, st>>>(g);
  }
  return (int)cudaGetLastError();
}

}  // namespace fwd
}  // namespace gat

// Plain C entry point for ctypes.  Pointers are device pointers: the
// forward lists (row_ptr (n_dst + 1), src, hubs (n_hubs rows of more than
// 512 entries, ascending), order (the walk's blocks of 4 rows, or null)),
// z (n_src, H, F), s_src (n_src, H), s_dst (n_dst, H), and the outputs out
// (n_dst, H, F) and lse (n_dst, H).  Launches on `stream`, does not
// synchronise, and returns a CUDA error code (cudaErrorInvalidValue where F
// is wider than a warp's 8 loads a lane hold).
extern "C" int gat_attention(const int32_t* row_ptr, const int32_t* src,
                             const int32_t* hubs, const int32_t* order,
                             const float* z, const float* s_src,
                             const float* s_dst, float* out, float* lse,
                             int n_hubs, int n_dst, int H, int F, float slope,
                             void* stream) {
  gat::Shape s;
  if (!gat::pick_shape(F, gat::aligned16(z) && gat::aligned16(out), s))
    return (int)cudaErrorInvalidValue;
  const gat::fwd::Args g{row_ptr, src, hubs, order, z, s_src, s_dst, out,
                         lse, n_hubs, n_dst, H, F, slope};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GAT_CASE(V_, K_) \
  if (s.v == V_ && s.k == K_) return gat::fwd::launch<V_, K_>(g, st);
  GAT_SHAPES(GAT_CASE)
#undef GAT_CASE
  return (int)cudaErrorInvalidValue;
}
