// Padded block-ELL SpMM y = A x for Hopper (sm_90a), fp32.
//
// Replaces repro/kernels/spmm_blockell.py::spmm_blockell, the Pallas TPU
// kernel: the (R, W) slot grid with col == -1 slots predicated off, no
// scales and no self term.  The body is blockell_spmm.cuh's with the scale
// handling compiled out (SCALED = false), so it computes exactly A x, and
// the padded walk of blockell_walk.cuh; see those headers for the
// translation and what bounds it.

#include "blockell_spmm.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers: block_cols
// (R, W) int32, blocks (R, W, bm, bk) uint8 or fp32, x (n_src, d), y
// (n_dst, d) with n_dst <= R * bm; every row of y is written.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).
extern "C" int spmm_blockell(const int32_t* block_cols, const void* blocks,
                             const float* x, float* y, int tile_is_u8,
                             int n_row_blocks, int width, int n_src,
                             int n_dst, int bm, int bk, int d, void* stream) {
  return blockell::spmm::launch<false>(
      blockell::PaddedSlots{block_cols, width}, n_row_blocks, blocks,
      tile_is_u8, x, nullptr, nullptr, nullptr, nullptr, y, n_src, n_dst, 0,
      bm, bk, d, 0, stream);
}
