// One-launch GNN layer over a padded block-ELL, for Hopper (sm_90a), fp32.
//
// Replaces repro/kernels/spmm_blockell.py::spmm_blockell_update, the Pallas
// TPU kernel.  Same function, per destination block r:
//
//   acc = [s_in * x]_r + sum_{active slots w of r} A_{r,w} (s_in * x)_{block_cols[r, w]}
//   out = (s_out * acc) @ W + c * (x_r @ W_self) + b,  then ReLU if asked
//
// over the padded (R, W) slot table, padding slots (col == -1) skipped.
// Every row gets the epilogue, blocks with no active slot included (their
// acc is the self term or zero), as the Pallas grid does: padded plans need
// no fallback patch.  The body is blockell_update.cuh's with the padded walk
// of blockell_walk.cuh; see those headers for the translation and what
// bounds it.

#include "blockell_update.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers: block_cols
// (R, W) int32, blocks (R, W, bm, bk), x (n_src, d_in), s_in (n_src,),
// s_out (n_dst,), w (d_in, d_out), y (n_dst, d_out).  bias, w_self and
// self_coeff may be null (no bias; no self term; c = 1).  The self and
// diagonal terms read x's rows < n_dst, so they need n_src >= n_dst.
// Launches on `stream`, does not synchronise, and returns 0 or the CUDA
// error of the attribute call or the launch.
extern "C" int spmm_blockell_update(
    const int32_t* block_cols, const void* blocks, const float* x,
    const float* s_in, const float* s_out, const float* w, const float* bias,
    const float* w_self, const float* self_coeff, float* y, int tile_is_u8,
    int n_row_blocks, int width, int n_src, int n_dst, int bm, int bk,
    int d_in, int d_out, int add_diag, int relu, void* stream) {
  return blockell::update::launch(
      blockell::PaddedSlots{block_cols, width}, n_row_blocks, blocks,
      tile_is_u8, x, s_in, s_out, w, bias, w_self, self_coeff, x, x, s_in, y,
      n_src, n_dst, bm, bk, d_in, d_out, add_diag, relu, stream);
}
