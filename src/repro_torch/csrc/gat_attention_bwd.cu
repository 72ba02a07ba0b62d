// GAT's edge-softmax attention, backward (gat_attention.cuh says how a
// warp walks a list).  Given dout (n_dst, H, F), the forward's lse and
// row_dot[i, h] = dout[i, h] . out[i, h] (each row's term, computed once a
// row by the caller), with alpha_ij = exp(LeakyReLU(s_dst[i] + s_src[j]) -
// lse[i]) recomputed, never stored:
//
//   dz[j]     = sum_i alpha_ij dout[i]
//   dpre_ij   = alpha_ij (dout[i] . z[j] - row_dot[i]), times the slope
//               where s_dst[i] + s_src[j] <= 0
//   ds_src[j] = sum_i dpre_ij          ds_dst[i] = sum_j dpre_ij
//
// The sums over i run over the transposed lists (row j lists the rows i
// that list j), so each source's dz and ds_src are one warp's, or one hub
// block's, with no atomics.  Each dpre_ij is written at its forward place
// (fwd_pos) in an (nnz, H) scratch, which the third kernel sums over the
// forward lists' rows into ds_dst.  Three kernels:
//
//   gat::bwd::walk     a warp a (source, head), kWalkRows sources a block;
//   gat::bwd::hubs     a block a (hub source, head), warps' parts summed in
//                      warp order through shared memory;
//   gat::bwd::dst_sum  a warp a destination row, every head.

#include "gat_attention.cuh"

namespace gat {
namespace bwd {

struct Args {
  const int32_t* row_ptr;     // forward lists (n_dst + 1)
  const int32_t* row_ptr_t;   // transposed lists (n_src + 1)
  const int32_t* dst_t;       // (nnz,) the row i of each transposed entry
  const int32_t* hubs_t;      // transposed rows of more than 512 entries
  const int32_t* order_t;     // the transposed walk's blocks, or null
  const int32_t* fwd_pos;     // (nnz,) each transposed entry's forward place
  const float* z;
  const float* s_src;
  const float* s_dst;
  const float* lse;
  const float* row_dot;
  const float* dout;
  float* dz;
  float* ds_src;
  float* ds_dst;
  float* scratch;             // (nnz, H): dpre at forward places
  int n_hubs_t, n_src, n_dst, H, F;
  float slope;
};

// One warp's part of source j's sums over transposed entries [a, b): the
// dz row part acc and the ds_src part dsum; each entry's dpre is written.
template <int V, int K>
__device__ __forceinline__ void gather(const Args& g, long long j, int h,
                                       int a, int b, const Cols<V, K>& c,
                                       const float (&zj)[K][V],
                                       float (&acc)[K][V], float& dsum) {
  const float ssj = __ldg(g.s_src + j * g.H + h);
  zero(acc);
  dsum = 0.f;
  for (int base = a; base < b; base += 32) {
    const int t = base + c.lane;
    const bool live = t < b;
    const long long i = live ? __ldg(g.dst_t + t) : 0;
    const float pre = ssj + __ldg(g.s_dst + i * g.H + h);
    const float al =
        live ? expf(leaky(pre, g.slope) - __ldg(g.lse + i * g.H + h)) : 0.f;
    const int cnt = min(32, b - base);
    float mine = 0.f;
#pragma unroll 4
    for (int u = 0; u < cnt; ++u) {
      const long long iu = __shfl_sync(kFull, i, u);
      const float au = __shfl_sync(kFull, al, u);
      float r[K][V];
      c.load(head_row(g.dout, iu, g.H, h, c.f), r);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int q = 0; q < V; ++q) {
          dot = fmaf(r[k][q], zj[k][q], dot);
          acc[k][q] = fmaf(au, r[k][q], acc[k][q]);
        }
      dot = warp_sum(dot);
      if (c.lane == u) mine = dot;
    }
    float dp = 0.f;
    if (live) {
      const float de = al * (mine - __ldg(g.row_dot + i * g.H + h));
      dp = pre > 0.f ? de : de * g.slope;
      g.scratch[(long long)__ldg(g.fwd_pos + t) * g.H + h] = dp;
    }
    dsum += warp_sum(dp);
  }
}

template <int V, int K>
__global__ void __launch_bounds__(32 * kWalkRows) walk(Args g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int blk =
      g.order_t != nullptr ? __ldg(g.order_t + blockIdx.x) : blockIdx.x;
  const long long j = (long long)blk * kWalkRows + warp;
  if (j >= g.n_src) return;
  const int first = __ldg(g.row_ptr_t + j);
  const int n = __ldg(g.row_ptr_t + j + 1) - first;
  if (n > kHubEntries) return;                 // gat::bwd::hubs writes it
  const Cols<V, K> c(lane, g.F);
  float zj[K][V], acc[K][V], dsum;
  c.load(head_row(g.z, j, g.H, h, g.F), zj);
  gather<V, K>(g, j, h, first, first + n, c, zj, acc, dsum);
  c.store(g.dz + (j * g.H + h) * (long long)g.F, acc, 1.f);
  if (lane == 0) g.ds_src[j * g.H + h] = dsum;
}

template <int V, int K>
__global__ void __launch_bounds__(kHubThreads) hubs(Args g) {
  extern __shared__ float smem[];
  float* part = smem;                         // [kHubWarps][F]
  float* pd = smem + kHubWarps * g.F;         // [kHubWarps] ds_src parts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const long long j = __ldg(g.hubs_t + blockIdx.x);
  const int first = __ldg(g.row_ptr_t + j);
  const int n = __ldg(g.row_ptr_t + j + 1) - first;
  const int a = first + (int)((long long)warp * n / kHubWarps);
  const int b = first + (int)((long long)(warp + 1) * n / kHubWarps);
  const Cols<V, K> c(lane, g.F);
  float zj[K][V], acc[K][V], dsum;
  c.load(head_row(g.z, j, g.H, h, g.F), zj);
  gather<V, K>(g, j, h, a, b, c, zj, acc, dsum);
  c.store(part + warp * g.F, acc, 1.f);
  if (lane == 0) pd[warp] = dsum;
  __syncthreads();
  float* dz = g.dz + (j * g.H + h) * (long long)g.F;
  for (int col = threadIdx.x; col < g.F; col += kHubThreads) {
    float o = 0.f;
    for (int w = 0; w < kHubWarps; ++w) o += part[w * g.F + col];
    dz[col] = o;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kHubWarps; ++w) s += pd[w];
    g.ds_src[j * g.H + h] = s;
  }
}

constexpr int kSumRows = 8;

// ds_dst[i, h] = the sum of row i's scratch entries, lanes striding them
__global__ void __launch_bounds__(32 * kSumRows) dst_sum(Args g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long i = (long long)blockIdx.x * kSumRows + warp;
  if (i >= g.n_dst) return;
  const int first = __ldg(g.row_ptr + i);
  const int end = __ldg(g.row_ptr + i + 1);
  float s[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) s[h] = 0.f;
  for (int t = first + lane; t < end; t += 32) {
    const float* row = g.scratch + (long long)t * g.H;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < g.H) s[h] += row[h];
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h >= g.H) break;
    const float tot = warp_sum(s[h]);
    if (lane == 0) g.ds_dst[i * g.H + h] = tot;
  }
}

template <int V, int K>
int launch(const Args& g, cudaStream_t st) {
  const int blocks = (g.n_src + kWalkRows - 1) / kWalkRows;
  if (blocks > 0)
    walk<V, K><<<dim3(blocks, g.H), 32 * kWalkRows, 0, st>>>(g);
  if (g.n_hubs_t > 0) {
    const size_t bytes = sizeof(float) * (kHubWarps * (size_t)g.F + kHubWarps);
    if (bytes > 48 * 1024)
      cudaFuncSetAttribute(hubs<V, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    hubs<V, K><<<dim3(g.n_hubs_t, g.H), kHubThreads, bytes, st>>>(g);
  }
  const int rows = (g.n_dst + kSumRows - 1) / kSumRows;
  if (rows > 0) dst_sum<<<rows, 32 * kSumRows, 0, st>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace gat

// Plain C entry point for ctypes.  Pointers are device pointers: the
// forward lists' row_ptr (n_dst + 1); the transposed lists (row_ptr_t
// (n_src + 1), dst_t, hubs_t (n_hubs_t rows of more than 512 entries,
// ascending), order_t (or null)) and fwd_pos (nnz); z (n_src, H, F),
// s_src (n_src, H), s_dst, lse, row_dot (n_dst, H), dout (n_dst, H, F);
// the outputs dz (n_src, H, F), ds_src (n_src, H), ds_dst (n_dst, H); and
// scratch (nnz, H), every entry of which is written.  Launches on `stream`,
// does not synchronise, and returns a CUDA error code
// (cudaErrorInvalidValue where F is wider than a warp's 8 loads a lane hold
// or H is above 8).
extern "C" int gat_attention_bwd(
    const int32_t* row_ptr, const int32_t* row_ptr_t, const int32_t* dst_t,
    const int32_t* hubs_t, const int32_t* order_t, const int32_t* fwd_pos,
    const float* z, const float* s_src, const float* s_dst, const float* lse,
    const float* row_dot, const float* dout, float* dz, float* ds_src,
    float* ds_dst, float* scratch, int n_hubs_t, int n_src, int n_dst, int H,
    int F, float slope, void* stream) {
  gat::Shape s;
  const bool aligned =
      gat::aligned16(z) && gat::aligned16(dout) && gat::aligned16(dz);
  if (H > gat::kMaxHeads || !gat::pick_shape(F, aligned, s))
    return (int)cudaErrorInvalidValue;
  const gat::bwd::Args g{row_ptr, row_ptr_t, dst_t, hubs_t, order_t, fwd_pos,
                         z, s_src, s_dst, lse, row_dot, dout, dz, ds_src,
                         ds_dst, scratch, n_hubs_t, n_src, n_dst, H, F, slope};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GAT_CASE(V_, K_) \
  if (s.v == V_ && s.k == K_) return gat::bwd::launch<V_, K_>(g, st);
  GAT_SHAPES(GAT_CASE)
#undef GAT_CASE
  return (int)cudaErrorInvalidValue;
}
