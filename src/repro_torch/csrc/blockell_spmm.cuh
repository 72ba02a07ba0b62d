// Block-ELL aggregation for Hopper (sm_90a), fp32: the body of
// spmm_blockell_compact.cu (kernel 3), spmm_blockell_fused.cu (kernel 2) and
// spmm_blockell.cu (kernel 1), per destination block r:
//
//   y[rows of r] = s_out * ( [s_in_diag * x_diag]_r
//                            + sum_{slots s of r} A_s (s_in * x_tile(col_s)) )
//
// or, with the scales compiled out (SCALED = false), exactly y = A x.  The
// slots come from a walk policy of blockell_walk.cuh: the compact one over
// the n_active slots of a BlockCompaction, the padded one over the (R, W)
// table of a BlockEll.  A_s is a (bm, bk) tile, uint8 0/1 (the exact
// bitmask) or fp32.
//
// Translation.  The Pallas grid runs its slots in order and keeps one output
// block resident across a row's consecutive slots (first/last predicates).
// CUDA blocks run in parallel and in no order, so a block per slot would race
// on the output.  Here each CUDA block owns one (destination block r, 32-row
// strip, 32-column strip) of y and walks the slots of r in a loop,
// accumulating in fp32 registers: the self term first, every slot next,
// s_out last, then one store.  No atomics, so a run is bit-reproducible.  The
// walk steps a (slot, depth chunk) pair and loads the next chunk into
// registers before the current chunk's FMAs, so their latency overlaps the
// arithmetic; tiles are converted to fp32 and x is pre-scaled by s_in while a
// 32-deep chunk is staged in shared memory, so the inner loop is one
// broadcast shared load per FMA row and one conflict-free load per column.
// The 128-lane padding of d, the zero-padded x of C*bk rows and the 2-D
// scales of the TPU plan are gone: x keeps (n_src, d), the scales are 1-D,
// and the kernel masks every ragged edge itself.
//
// What bounds it on an H100.  On Cora at bm = bk = 128 (~460-480 active
// slots) one launch streams ~7.6-7.9 MB of uint8 tiles, ~2.3 us of HBM time;
// the dense-tile products are 2*n_active*128^2*d FLOP (~1 GFLOP at d = 64,
// ~15 us at 67 TFLOP/s fp32) while the edges need only 2*nnz*d.  As written
// the kernel is bound by neither but by the latency of its serial walk
// (~22 slots x 4 staged chunks, two barriers each, per CUDA block).  Plain
// fp32 FMA, no TF32: the port's parity bar is 1e-5.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "blockell_walk.cuh"

namespace blockell {
namespace spmm {

constexpr int TM = 32;        // destination rows per CUDA block
constexpr int TN = 32;        // feature columns per CUDA block (one per lane)
constexpr int KC = 32;        // source rows per staged chunk
constexpr int NT = 256;       // threads: 8 warps x 32 lanes
constexpr int RPT = TM / (NT / TN);      // rows per thread = 4
constexpr int A_PER_T = TM * KC / NT;    // staged tile elements per thread = 4
constexpr int X_PER_T = KC * TN / NT;    // staged x elements per thread = 4

// SCALED: s_in, s_out and the optional self term (kernels 2 and 3); without
// it, y = A x (kernel 1).  The self term reads rows < n_diag of x_diag.
template <typename Slots, typename TileT, bool SCALED>
__global__ void __launch_bounds__(NT)
kernel(Slots slots, const TileT* __restrict__ blocks,
       const float* __restrict__ x, const float* __restrict__ s_in,
       const float* __restrict__ s_out, const float* __restrict__ x_diag,
       const float* __restrict__ s_in_diag, float* __restrict__ y, int n_src,
       int n_dst, int n_diag, int bm, int bk, int d, int add_diag) {
  const int r = blockIdx.x;
  const int end = slots.end(r);
  int s = slots.first(r);
  if (!Slots::kEveryRow && s == end) return;   // rows left to the caller

  const int m0 = blockIdx.y * TM;         // strip of rows inside block r
  const int j0 = blockIdx.z * TN;         // strip of feature columns
  const int tx = threadIdx.x % TN;        // this thread's column
  const int ty = threadIdx.x / TN;        // this thread's first row
  const int j = j0 + tx;

  __shared__ float a_s[TM][KC];
  __shared__ float x_s[KC][TN];

  // self term first (the Pallas kernel's first step)
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * (NT / TN);
    const long long row = (long long)r * bm + m;
    acc[i] = 0.0f;
    if (SCALED && add_diag && m < bm && row < n_dst && row < n_diag && j < d)
      acc[i] = x_diag[row * d + j] * s_in_diag[row];
  }

  const int nk = (bk + KC - 1) / KC;
  float ra[A_PER_T], rx[X_PER_T];

  // global -> registers for depth chunk kc of slot sl
  auto load_chunk = [&](int sl, int kc) {
    const int k0 = kc * KC;
    const TileT* tile = blocks + slots.tile(r, sl) * bm * bk;
    const long long src0 = (long long)slots.col(r, sl) * bk + k0;
#pragma unroll
    for (int t = 0; t < A_PER_T; ++t) {
      const int e = threadIdx.x + t * NT;
      const int m = m0 + e / KC, k = k0 + e % KC;
      ra[t] = (m < bm && k < bk) ? static_cast<float>(tile[(long long)m * bk + k])
                                 : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < X_PER_T; ++t) {
      const int e = threadIdx.x + t * NT;
      const int kk = e / TN, col = j0 + e % TN;
      const long long src = src0 + kk;
      float v = 0.0f;
      if (k0 + kk < bk && src < n_src && col < d) {
        v = x[src * d + col];
        if (SCALED) v *= s_in[src];
      }
      rx[t] = v;
    }
  };

  int kc = 0;
  if (s < end) load_chunk(s, 0);
  while (s < end) {
#pragma unroll
    for (int t = 0; t < A_PER_T; ++t) {
      const int e = threadIdx.x + t * NT;
      a_s[e / KC][e % KC] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < X_PER_T; ++t) {
      const int e = threadIdx.x + t * NT;
      x_s[e / TN][e % TN] = rx[t];
    }
    __syncthreads();
    // the next chunk: the next depth of this slot, or the next slot
    int ns = s, nkc = kc + 1;
    if (nkc == nk) {
      nkc = 0;
      ns = slots.next(r, s);
    }
    if (ns < end) load_chunk(ns, nkc);      // in flight during the FMAs
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float xv = x_s[kk][tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(a_s[ty + i * (NT / TN)][kk], xv, acc[i]);
    }
    __syncthreads();
    s = ns;
    kc = nkc;
  }

  // s_out last (the Pallas kernel's last step), then the one store
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * (NT / TN);
    const long long row = (long long)r * bm + m;
    if (m < bm && row < n_dst && j < d)
      y[row * d + j] = SCALED ? acc[i] * s_out[row] : acc[i];
  }
}

template <bool SCALED, typename Slots>
int launch(Slots slots, int n_row_blocks, const void* blocks, int tile_is_u8,
           const float* x, const float* s_in, const float* s_out,
           const float* x_diag, const float* s_in_diag, float* y, int n_src,
           int n_dst, int n_diag, int bm, int bk, int d, int add_diag,
           void* stream) {
  const dim3 grid(n_row_blocks, (bm + TM - 1) / TM, (d + TN - 1) / TN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_is_u8)
    kernel<Slots, uint8_t, SCALED><<<grid, NT, 0, st>>>(
        slots, static_cast<const uint8_t*>(blocks), x, s_in, s_out, x_diag,
        s_in_diag, y, n_src, n_dst, n_diag, bm, bk, d, add_diag);
  else
    kernel<Slots, float, SCALED><<<grid, NT, 0, st>>>(
        slots, static_cast<const float*>(blocks), x, s_in, s_out, x_diag,
        s_in_diag, y, n_src, n_dst, n_diag, bm, bk, d, add_diag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spmm
}  // namespace blockell
