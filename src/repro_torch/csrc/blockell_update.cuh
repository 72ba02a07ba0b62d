// One-launch GNN layer over a block-ELL, for Hopper (sm_90a), fp32: the body
// of spmm_blockell_update_compact.cu (kernel 5) and spmm_blockell_update.cu
// (kernel 4), per destination block r:
//
//   acc = [s_in_diag * x_diag]_r + sum_{slots s of r} A_s (s_in * x)_{col_s}
//   out = (s_out * acc) @ W + c * (x_self_r @ W_self) + b,  then ReLU if asked
//
// The slots come from a walk policy of blockell_walk.cuh: the compact one
// over the n_active slots of a BlockCompaction (rows of blocks with no
// active slot unwritten), the padded one over the (R, W) table of a BlockEll
// (every row gets the epilogue, its acc the self term or zero).  A_s is a
// (bm, bk) tile, uint8 0/1 (the exact bitmask) or fp32.  W_self, c, b, the
// self term and ReLU are each optional; c is read from device memory (a
// trained parameter, 1 + eps for GIN), so the host never waits for it.
//
// Translation.  The Pallas grid walks the slots in order and keeps a
// (bm, d_in) fp32 accumulator and the whole (d_in, d_out) W resident in
// VMEM, running the W product when a row's last slot is done.  On the card
// a block has at most 227 KB of shared memory, and at d_in = 1433 the
// accumulator alone is 733 KB.  So here each CUDA block owns one
// (destination block r, 32-row strip, 128-column strip of d_out) and loops
// over d_in in chunks of 128 columns.  For each chunk it walks the slots of
// r, accumulating the chunk of the aggregation in fp32 registers; then it
// scales the chunk by s_out, stages it in shared memory and multiplies it by
// the matching 128 rows of W (and of W_self), 32 rows at a time, into a
// (32 x 128) output tile held in registers.  Bias, ReLU and one store follow
// the last chunk.  No atomics: reruns are bit-identical.  When W_self is W
// (GIN passes the same tensor), the self term c * x_self is added to the
// scaled chunk before the one product, which is the same function; the
// kernel never assumes the two differ.  The TPU padding (128-lane d_in and
// d_out, C*bk rows of x, 2-D scales) is gone: the kernel masks every ragged
// edge itself.
//
// What bounds it on an H100.  At GIN's conv shapes (reordered Cora, bm = bk
// = 128, 461 active slots, d_in = d_out = 128) one launch reads 7.6 MB of
// uint8 tiles, x (1.4 MB) and W (64 KB) and writes 1.4 MB: about 3 us of HBM
// time.  The dense-tile aggregation is 2*461*128^2*128 = 1.9 GFLOP, ~29 us
// at 67 TFLOP/s fp32, while the tiles hold only 10556 edges.  As written the
// kernel is bound by neither: each block walks its row's ~21 slots x 4 tile
// steps in sequence per d_in chunk, with two barriers per step, and the grid
// has only 22 x 4 = 88 blocks for 132 SMs, so it is bound by the latency of
// that serial walk.  What the design does about it: one staged step is a
// whole 32 x 32 tile slab against 32 source rows of a 128-wide chunk (16
// FMAs per thread per pair of shared loads), the next step's global loads
// are issued into registers before the current step's FMAs, and the tiles
// are read once per d_in chunk, not once per output column strip.  Plain
// fp32 FMA, no TF32: the port's parity bar is 1e-5.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "blockell_walk.cuh"

namespace blockell {
namespace update {

constexpr int NT = 256;                  // threads: 8 warps x 32 lanes
constexpr int WARPS = NT / 32;
constexpr int TM = 32;                   // destination rows per CUDA block
constexpr int KC = 128;                  // d_in columns per chunk
constexpr int TN = 128;                  // d_out columns per CUDA block
constexpr int KS = 32;                   // tile depth (source rows) per step
constexpr int WK = 32;                   // W rows per staged slice
constexpr int RPT = TM / WARPS;          // rows per thread = 4
constexpr int CPT = KC / 32;             // columns per thread = 4
constexpr int A_PER_T = TM * KS / NT;    // staged tile elements per thread
constexpr int X_PER_T = KS * KC / NT;    // staged x elements per thread
constexpr int W_PER_T = WK * TN / NT;    // staged W elements per thread
static_assert(KC == TN, "the thread layout serves both the chunk and the "
                        "output tile");

struct Smem {
  float a[TM][KS];      // one tile step, converted to fp32
  float x[KS][KC];      // s_in-scaled source rows of the chunk
  float g[TM][KC];      // s_out * acc (+ c * x_self when W_self is W)
  float h[TM][KC];      // c * x_self (separate W_self only)
  float w[WK][TN];      // W slice
  float v[WK][TN];      // W_self slice (separate W_self only)
};
constexpr int SMEM_BYTES = sizeof(Smem);   // 86,016: dynamic, above 48 KB

template <typename Slots, typename TileT>
__global__ void __launch_bounds__(NT)
kernel(Slots slots, const TileT* __restrict__ blocks, const float* x,
       const float* s_in, const float* __restrict__ s_out, const float* w,
       const float* __restrict__ bias, const float* w_self,
       const float* __restrict__ self_coeff, const float* x_self,
       const float* x_diag, const float* s_in_diag, float* __restrict__ y,
       int n_src, int n_dst, int bm, int bk, int d_in, int d_out,
       int add_diag, int relu) {
  const int r = blockIdx.x;
  const int end = slots.end(r);
  const int first = slots.first(r);
  if (!Slots::kEveryRow && first == end) return;   // rows left to the caller

  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int m0 = blockIdx.y * TM;         // strip of rows inside block r
  const int j0 = blockIdx.z * TN;         // strip of output columns
  const int lane = threadIdx.x % 32;
  const int wy = threadIdx.x / 32;        // this thread's first row
  const bool has_self = w_self != nullptr;
  const bool fold = has_self && w_self == w;
  const bool two_w = has_self && !fold;
  const float c = self_coeff != nullptr ? *self_coeff : 1.0f;
  const int nk = (bk + KS - 1) / KS;

  float out[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) out[i][j] = 0.0f;

  for (int c0 = 0; c0 < d_in; c0 += KC) {
    // this chunk of the aggregation: the self term first
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + wy + i * WARPS;
      const long long row = (long long)r * bm + m;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + lane + 32 * j;
        acc[i][j] = (add_diag && m < bm && row < n_dst && col < d_in)
                        ? x_diag[row * d_in + col] * s_in_diag[row]
                        : 0.0f;
      }
    }

    float ra[A_PER_T], rx[X_PER_T];
    // global -> registers for tile depth kc of slot sl
    auto load_step = [&](int sl, int kc) {
      const int k0 = kc * KS;
      const TileT* tile = blocks + slots.tile(r, sl) * bm * bk;
      const long long src0 = (long long)slots.col(r, sl) * bk + k0;
#pragma unroll
      for (int t = 0; t < A_PER_T; ++t) {
        const int e = threadIdx.x + t * NT;
        const int m = m0 + e / KS, k = k0 + e % KS;
        ra[t] = (m < bm && k < bk)
                    ? static_cast<float>(tile[(long long)m * bk + k])
                    : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < X_PER_T; ++t) {
        const int e = threadIdx.x + t * NT;
        const int kk = e / KC, col = c0 + e % KC;
        const long long src = src0 + kk;
        rx[t] = (k0 + kk < bk && src < n_src && col < d_in)
                    ? x[src * d_in + col] * s_in[src]
                    : 0.0f;
      }
    };

    int sl = first, kc = 0;
    if (sl < end) load_step(sl, 0);
    while (sl < end) {
#pragma unroll
      for (int t = 0; t < A_PER_T; ++t) {
        const int e = threadIdx.x + t * NT;
        s.a[e / KS][e % KS] = ra[t];
      }
#pragma unroll
      for (int t = 0; t < X_PER_T; ++t) {
        const int e = threadIdx.x + t * NT;
        s.x[e / KC][e % KC] = rx[t];
      }
      __syncthreads();
      // the next step: the next depth of this slot, or the next slot
      int nsl = sl, nkc = kc + 1;
      if (nkc == nk) {
        nkc = 0;
        nsl = slots.next(r, sl);
      }
      if (nsl < end) load_step(nsl, nkc);  // in flight during the FMAs
#pragma unroll 8
      for (int kk = 0; kk < KS; ++kk) {
        float xv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) xv[j] = s.x[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float av = s.a[wy + i * WARPS][kk];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av, xv[j], acc[i][j]);
        }
      }
      __syncthreads();
      sl = nsl;
      kc = nkc;
    }

    // s_out, then the self term, into the product's left operand
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + wy + i * WARPS;
      const long long row = (long long)r * bm + m;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + lane + 32 * j;
        const bool ok = m < bm && row < n_dst && col < d_in;
        float gv = ok ? acc[i][j] * s_out[row] : 0.0f;
        const float hv = (has_self && ok) ? c * x_self[row * d_in + col]
                                          : 0.0f;
        if (fold) gv += hv;
        s.g[wy + i * WARPS][lane + 32 * j] = gv;
        if (two_w) s.h[wy + i * WARPS][lane + 32 * j] = hv;
      }
    }

    // out += g @ W[c0 : c0 + KC] (+ h @ W_self[...]), WK rows of W at a time
    const int kw_end = d_in - c0 < KC ? d_in - c0 : KC;
    for (int kw = 0; kw < kw_end; kw += WK) {
#pragma unroll
      for (int t = 0; t < W_PER_T; ++t) {
        const int e = threadIdx.x + t * NT;
        const int kk = e / TN, col = e % TN;
        const bool ok = kw + kk < kw_end && j0 + col < d_out;
        const long long at = (long long)(c0 + kw + kk) * d_out + j0 + col;
        s.w[kk][col] = ok ? w[at] : 0.0f;
        if (two_w) s.v[kk][col] = ok ? w_self[at] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < WK; ++kk) {
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = s.w[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float gv = s.g[wy + i * WARPS][kw + kk];
#pragma unroll
          for (int j = 0; j < CPT; ++j) out[i][j] = fmaf(gv, wv[j], out[i][j]);
        }
        if (two_w) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) wv[j] = s.v[kk][lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float hv = s.h[wy + i * WARPS][kw + kk];
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              out[i][j] = fmaf(hv, wv[j], out[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  // bias, ReLU, then the one store
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + wy + i * WARPS;
    const long long row = (long long)r * bm + m;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = j0 + lane + 32 * j;
      if (m < bm && row < n_dst && col < d_out) {
        float v = out[i][j] + (bias != nullptr ? bias[col] : 0.0f);
        if (relu) v = fmaxf(v, 0.0f);
        y[row * d_out + col] = v;
      }
    }
  }
}

template <typename Slots, typename TileT>
int launch_typed(Slots slots, int n_row_blocks, const TileT* blocks,
                 const float* x, const float* s_in, const float* s_out,
                 const float* w, const float* bias, const float* w_self,
                 const float* self_coeff, const float* x_self,
                 const float* x_diag, const float* s_in_diag, float* y,
                 int n_src, int n_dst, int bm, int bk, int d_in, int d_out,
                 int add_diag, int relu, cudaStream_t stream) {
  // above 48 KB of shared memory only on request; set for the current device
  cudaError_t e = cudaFuncSetAttribute(
      kernel<Slots, TileT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_row_blocks, (bm + TM - 1) / TM, (d_out + TN - 1) / TN);
  kernel<Slots, TileT><<<grid, NT, SMEM_BYTES, stream>>>(
      slots, blocks, x, s_in, s_out, w, bias, w_self, self_coeff, x_self,
      x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in, d_out, add_diag,
      relu);
  return static_cast<int>(cudaGetLastError());
}

// Returns 0 or the CUDA error of the attribute call or the launch.
template <typename Slots>
int launch(Slots slots, int n_row_blocks, const void* blocks, int tile_is_u8,
           const float* x, const float* s_in, const float* s_out,
           const float* w, const float* bias, const float* w_self,
           const float* self_coeff, const float* x_self, const float* x_diag,
           const float* s_in_diag, float* y, int n_src, int n_dst, int bm,
           int bk, int d_in, int d_out, int add_diag, int relu,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_is_u8)
    return launch_typed(slots, n_row_blocks,
                        static_cast<const uint8_t*>(blocks), x, s_in, s_out,
                        w, bias, w_self, self_coeff, x_self, x_diag,
                        s_in_diag, y, n_src, n_dst, bm, bk, d_in, d_out,
                        add_diag, relu, st);
  return launch_typed(slots, n_row_blocks, static_cast<const float*>(blocks),
                      x, s_in, s_out, w, bias, w_self, self_coeff, x_self,
                      x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in, d_out,
                      add_diag, relu, st);
}

}  // namespace update
}  // namespace blockell
