// Slot-compacted block-ELL SpMM for Hopper (sm_90a), fp32.
//
// Replaces repro/kernels/spmm_blockell.py::spmm_blockell_compact, the Pallas
// TPU kernel.  Same function:
//
//   y[rows of block r] = s_out * ( [s_in_diag * x_diag]
//                                  + sum_{slots i of r} A_i (s_in * x_tile(cols[i])) )
//
// over only the n_active row-major-sorted (row, col) slots of a
// BlockCompaction.  Rows of destination blocks with no active slot are left
// unwritten, as on the TPU; the execution plan patches them with the
// diagonal term.  The body is blockell_spmm.cuh's with the compact walk of
// blockell_walk.cuh; see that header for the translation and what bounds it.

#include "blockell_spmm.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers; x_diag and
// s_in_diag (n_dst rows) are read only when add_diag is set.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).
extern "C" int spmm_blockell_compact(const int32_t* row_offsets,
                                     const int32_t* cols, const void* blocks,
                                     const float* x, const float* s_in,
                                     const float* s_out, const float* x_diag,
                                     const float* s_in_diag, float* y,
                                     int tile_is_u8, int n_row_blocks,
                                     int n_src, int n_dst, int bm, int bk,
                                     int d, int add_diag, void* stream) {
  return blockell::spmm::launch<true>(
      blockell::CompactSlots{row_offsets, cols}, n_row_blocks, blocks,
      tile_is_u8, x, s_in, s_out, x_diag, s_in_diag, y, n_src, n_dst, n_dst,
      bm, bk, d, add_diag, stream);
}
