// Padded fused block-ELL SpMM for Hopper (sm_90a), fp32.
//
// Replaces repro/kernels/spmm_blockell.py::spmm_blockell_fused, the Pallas
// TPU kernel.  Same function, per destination block r:
//
//   y[rows of r] = s_out * ( [s_in * x]_r + sum_{active slots w of r}
//                            A_{r,w} (s_in * x_tile(block_cols[r, w])) )
//
// over the padded (R, W) slot table, padding slots (col == -1) skipped.
// Every row is written, blocks with no active slot included.  The body is
// blockell_spmm.cuh's with the scales compiled in and the padded walk of
// blockell_walk.cuh; see those headers for the translation and what bounds
// it.

#include "blockell_spmm.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers: block_cols
// (R, W) int32, blocks (R, W, bm, bk) uint8 or fp32, x (n_src, d), s_in
// (n_src,), s_out (n_dst,), y (n_dst, d).  With add_diag (square blocks)
// the self term s_in * x seeds rows < min(n_src, n_dst).  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int spmm_blockell_fused(const int32_t* block_cols,
                                   const void* blocks, const float* x,
                                   const float* s_in, const float* s_out,
                                   float* y, int tile_is_u8, int n_row_blocks,
                                   int width, int n_src, int n_dst, int bm,
                                   int bk, int d, int add_diag, void* stream) {
  return blockell::spmm::launch<true>(
      blockell::PaddedSlots{block_cols, width}, n_row_blocks, blocks,
      tile_is_u8, x, s_in, s_out, x, s_in, y, n_src, n_dst, n_src, bm, bk, d,
      add_diag, stream);
}
