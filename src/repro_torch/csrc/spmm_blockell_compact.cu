// Slot-compacted block-ELL SpMM for Hopper (sm_90a), fp32.
//
// Replaces repro/kernels/spmm_blockell.py::spmm_blockell_compact, the Pallas
// TPU kernel.  Same function:
//
//   y[rows of block r] = s_out * ( [s_in_diag * x_diag]
//                                  + sum_{slots i of r} A_i (s_in * x_tile(cols[i])) )
//
// over only the n_active row-major-sorted (row, col) slots of a
// BlockCompaction.  A_i is a (bm, bk) tile, uint8 0/1 (the exact bitmask) or
// fp32.  Rows of destination blocks with no active slot are left unwritten,
// as on the TPU; the execution plan patches them with the diagonal term.
//
// Translation.  The Pallas grid runs its n_active steps in order and keeps
// one output block resident across a row's consecutive slots (first/last
// predicates).  CUDA blocks run in parallel and in no order, so a block per
// slot would race on the output.  Here each CUDA block owns one
// (destination block r, 32-row strip, 32-column strip) of y and walks the
// slots [row_offsets[r], row_offsets[r+1]) in a loop, accumulating in fp32
// registers: the self term first, every slot next, s_out last, then one
// store.  No atomics, so a run is bit-reproducible.  The 128-lane padding of
// d, the zero-padded x of C*bk rows and the 2-D padded scales of the TPU
// plan are gone: the kernel masks the source-row, destination-row and d
// edges itself.
//
// What bounds it on an H100.  At the GCN serving shapes (Cora, bm = bk =
// 128, n_active = 481, d = 64 then 16) each launch streams 481*128*128 B =
// 7.9 MB of uint8 tiles; x and y (~0.7 MB each at d = 64) stay in L2.  The
// dense-tile product is 2*481*128^2*d FLOP = 1.01 GFLOP at d = 64, so at
// 67 TFLOP/s fp32 (no tensor cores) the kernel as designed is bound by fp32
// operations (~15 us), not by bytes (~2.8 us).  The tiles are only 0.13%
// full, so the data itself needs far less arithmetic than the dense tiles
// do; exploiting that is later work.  What the design does now: tiles are
// converted to fp32 and x is pre-scaled by s_in once, while staging a
// 32-deep chunk into shared memory, so the inner loop is one broadcast
// shared load per FMA row and one conflict-free load per column; the next
// chunk's global loads are issued into registers before the current chunk
// is multiplied, so their latency overlaps the arithmetic.  Plain fp32 FMA,
// no TF32: the port's parity bar is 1e-5.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // destination rows per CUDA block
constexpr int TN = 32;        // feature columns per CUDA block (one per lane)
constexpr int KC = 32;        // source rows per staged chunk
constexpr int NT = 256;       // threads: 8 warps x 32 lanes
constexpr int RPT = TM / (NT / TN);      // rows per thread = 4
constexpr int A_PER_T = TM * KC / NT;    // staged tile elements per thread = 4
constexpr int X_PER_T = KC * TN / NT;    // staged x elements per thread = 4

template <typename TileT>
__global__ void __launch_bounds__(NT)
spmm_blockell_compact_kernel(const int32_t* __restrict__ row_offsets,
                             const int32_t* __restrict__ cols,
                             const TileT* __restrict__ blocks,
                             const float* __restrict__ x,
                             const float* __restrict__ s_in,
                             const float* __restrict__ s_out,
                             const float* __restrict__ x_diag,
                             const float* __restrict__ s_in_diag,
                             float* __restrict__ y,
                             int n_src, int n_dst, int bm, int bk, int d,
                             int add_diag) {
  const int r = blockIdx.x;
  const int beg = row_offsets[r];
  const int end = row_offsets[r + 1];
  if (beg == end) return;                 // no active slot: rows unwritten

  const int m0 = blockIdx.y * TM;         // strip of rows inside block r
  const int j0 = blockIdx.z * TN;         // strip of feature columns
  const int tx = threadIdx.x % TN;        // this thread's column
  const int ty = threadIdx.x / TN;        // this thread's first row
  const int j = j0 + tx;

  __shared__ float a_s[TM][KC];
  __shared__ float x_s[KC][TN];

  // self term first (the TPU kernel's init step)
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * (NT / TN);
    const long long row = (long long)r * bm + m;
    acc[i] = 0.0f;
    if (add_diag && m < bm && row < n_dst && j < d)
      acc[i] = x_diag[row * d + j] * s_in_diag[row];
  }

  const int nk = (bk + KC - 1) / KC;
  const int total = (end - beg) * nk;
  float ra[A_PER_T], rx[X_PER_T];

  // global -> registers for chunk q (slot beg + q / nk, depth k0)
  auto load_chunk = [&](int q) {
    const int slot = beg + q / nk;
    const int k0 = (q % nk) * KC;
    const TileT* tile = blocks + (long long)slot * bm * bk;
    const long long src0 = (long long)cols[slot] * bk + k0;
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
      rx[t] = (k0 + kk < bk && src < n_src && col < d)
                  ? x[src * d + col] * s_in[src]
                  : 0.0f;
    }
  };

  load_chunk(0);
  for (int q = 0; q < total; ++q) {
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
    if (q + 1 < total) load_chunk(q + 1);   // in flight during the FMAs
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float xv = x_s[kk][tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(a_s[ty + i * (NT / TN)][kk], xv, acc[i]);
    }
    __syncthreads();
  }

  // s_out last (the TPU kernel's final step), then the one store
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * (NT / TN);
    const long long row = (long long)r * bm + m;
    if (m < bm && row < n_dst && j < d) y[row * d + j] = acc[i] * s_out[row];
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers; x_diag and
// s_in_diag are read only when add_diag is set.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int spmm_blockell_compact(const int32_t* row_offsets,
                                     const int32_t* cols, const void* blocks,
                                     const float* x, const float* s_in,
                                     const float* s_out, const float* x_diag,
                                     const float* s_in_diag, float* y,
                                     int tile_is_u8, int n_row_blocks,
                                     int n_src, int n_dst, int bm, int bk,
                                     int d, int add_diag, void* stream) {
  const dim3 grid(n_row_blocks, (bm + TM - 1) / TM, (d + TN - 1) / TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_is_u8)
    spmm_blockell_compact_kernel<uint8_t><<<grid, NT, 0, s>>>(
        row_offsets, cols, static_cast<const uint8_t*>(blocks), x, s_in,
        s_out, x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d, add_diag);
  else
    spmm_blockell_compact_kernel<float><<<grid, NT, 0, s>>>(
        row_offsets, cols, static_cast<const float*>(blocks), x, s_in, s_out,
        x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d, add_diag);
  return static_cast<int>(cudaGetLastError());
}
