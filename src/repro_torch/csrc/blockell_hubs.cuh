// The hubs of the block-ELL list walk (a RowLists, blockell_walk.cuh), for
// Hopper (sm_90a), fp32.
//
// A warp of the list walk gathers its row's entries kBatch rows of x at a
// time a lane group, so a hub, a row of more than scan::kCap entries, keeps
// its warp busy long after the others are done: on CITESEER-S's transposed
// plan 103 rows hold 104 k of the 814 k entries, the longest 3,189.  So,
// before the walk, one CUDA block a hub (and a strip of 128 feature
// columns) cuts the hub's list into kHubWarps equal ranges, one a warp,
// gathers each as the walk does, and adds the self term and then the
// warps' partial sums, in warp order, into hub_acc; the walk's warp of
// that row reads it there in place of its self term and its gather.  The
// order of every sum is fixed by the data alone, so a rerun is
// bit-identical; rows of at most kCap entries are not touched.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "blockell_scan.cuh"
#include "blockell_walk.cuh"

namespace blockell {
namespace hubs {

constexpr int kHubWarps = 16;
constexpr int kHubThreads = 32 * kHubWarps;

// hub_acc[h] = [s_in_diag * x_diag]_row + sum of row's entries, for hub h
template <bool COEF, int V>
__global__ void __launch_bounds__(kHubThreads)
kernel(RowLists<COEF> lists, const float* __restrict__ x,
       const float* __restrict__ s_in, const float* __restrict__ x_diag,
       const float* __restrict__ s_in_diag, int d, int add_diag) {
  __shared__ float part[kHubWarps][scan::kCols];   // [warp][column]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x;
  const long long row = __ldg(lists.hubs + h);
  int first, n;
  lists.row(row, true, first, n);
  const scan::Lanes<V> ln(lane, d, blockIdx.y);
  const int a = static_cast<int>((long long)warp * n / kHubWarps);
  const int b = static_cast<int>((long long)(warp + 1) * n / kHubWarps);
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  scan::gather<V, true>(lists.list(first + a), b - a, ln, x, s_in, d, p);
  scan::reduce_groups(ln, p);
  if (ln.g == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) part[warp][ln.col(q) - ln.c0] = p[q];
  }
  __syncthreads();
  if (warp != 0 || ln.g != 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (add_diag) {
    const float sd = s_in_diag[row];
    ln.load(x_diag, row, d, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] *= sd;
  }
  for (int w = 0; w < kHubWarps; ++w) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += part[w][ln.col(q) - ln.c0];
  }
  float* out = lists.hub_acc + (long long)h * d;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (ln.col(q) < d) out[ln.col(q)] = acc[q];
}

// Sum the hubs of `lists` at width d into lists.hub_acc (nothing to do
// without hubs); on `st`, before the walk that reads them.
template <bool COEF>
void launch(RowLists<COEF> lists, const float* x, const float* s_in,
            const float* x_diag, const float* s_in_diag, int d,
            int add_diag, cudaStream_t st) {
  if (lists.n_hubs == 0) return;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const dim3 grid(lists.n_hubs, (d + scan::kCols - 1) / scan::kCols);
  if (d % 4 == 0 && aligned(x) && !(add_diag && !aligned(x_diag)))
    kernel<COEF, 4><<<grid, kHubThreads, 0, st>>>(lists, x, s_in, x_diag,
                                                  s_in_diag, d, add_diag);
  else
    kernel<COEF, 1><<<grid, kHubThreads, 0, st>>>(lists, x, s_in, x_diag,
                                                  s_in_diag, d, add_diag);
}

}  // namespace hubs
}  // namespace blockell
