// One-launch GNN layer over a slot-compacted block-ELL, for Hopper (sm_90a),
// fp32.
//
// Replaces repro/kernels/spmm_blockell.py::spmm_blockell_update_compact, the
// Pallas TPU kernel.  Same function, per destination block r:
//
//   acc = [s_in_diag * x_diag]_r + sum_{slots i of r} A_i (s_in * x)_{cols[i]}
//   out = (s_out * acc) @ W + c * (x_self_r @ W_self) + b,  then ReLU if asked
//
// over only the n_active row-major-sorted slots of a BlockCompaction.  Rows
// of destination blocks with no active slot are left unwritten, as on the
// TPU; the execution plan patches them outside the kernel.  The body is
// blockell_update.cuh's with the compact walk of blockell_walk.cuh; see that
// header for the translation and what bounds it.

#include "blockell_update.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers.  bias,
// w_self and self_coeff may be null (no bias; no self term; c = 1); x_self
// is read only with w_self, x_diag and s_in_diag only with add_diag.
// Launches on `stream`, does not synchronise, and returns 0 or the CUDA
// error of the attribute call or the launch.
extern "C" int spmm_blockell_update_compact(
    const int32_t* row_offsets, const int32_t* cols, const void* blocks,
    const float* x, const float* s_in, const float* s_out, const float* w,
    const float* bias, const float* w_self, const float* self_coeff,
    const float* x_self, const float* x_diag, const float* s_in_diag,
    float* y, int tile_is_u8, int n_row_blocks, int n_src, int n_dst, int bm,
    int bk, int d_in, int d_out, int add_diag, int relu, void* stream) {
  return blockell::update::launch(
      blockell::CompactSlots{row_offsets, cols}, n_row_blocks, blocks,
      tile_is_u8, x, s_in, s_out, w, bias, w_self, self_coeff, x_self, x_diag,
      s_in_diag, y, n_src, n_dst, bm, bk, d_in, d_out, add_diag, relu, stream);
}
