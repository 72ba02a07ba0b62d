// One-launch GNN layer over per-row entry lists, for Hopper (sm_90a), fp32:
// the list walk of spmm_blockell_update_compact (kernel 5).  Same function,
// per destination row v:
//
//   acc = [s_in_diag[v] * x_diag[v]]
//         + sum_{e in [row_ptr[v], row_ptr[v + 1])} coef[e] * (s_in * x)[src[e]]
//   out = (s_out[v] * acc) @ W + c * (x_self[v] @ W_self) + b,  then ReLU if
//         asked
//
// where the entries are those a walk over the compacted tiles would list
// (core/blocksparse.py row_lists), so no tile is read.  Every row is
// written.  The body is blockell_update.cuh's with the RowLists walk of
// blockell_walk.cuh; see that header for what bounds it.

#include "blockell_update.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers.  coef may
// be null (every coefficient 1); hubs lists the n_hubs rows of more than 512
// entries, ascending, and hub_acc is (n_hubs, d_in) of scratch (both unread
// when n_hubs is 0); bias, w_self and self_coeff may be null
// (no bias; no self term; c = 1); x_self is read only with w_self, x_diag
// and s_in_diag only with add_diag.  Launches on `stream`, does not
// synchronise, and returns 0 or the CUDA error of the attribute call or the
// launch.
extern "C" int spmm_blockell_update_lists(
    const int32_t* row_ptr, const int32_t* src, const float* coef,
    const int32_t* hubs, float* hub_acc, const float* x, const float* s_in,
    const float* s_out, const float* w, const float* bias,
    const float* w_self, const float* self_coeff, const float* x_self,
    const float* x_diag, const float* s_in_diag, float* y, int n_hubs,
    int n_src, int n_dst, int d_in, int d_out, int add_diag, int relu,
    void* stream) {
  if (coef != nullptr)
    return blockell::update::launch_lists(
        blockell::RowLists<true>{row_ptr, src, coef, hubs, n_hubs, hub_acc,
                                 nullptr},
        x, s_in, s_out, w, bias, w_self, self_coeff, x_self, x_diag,
        s_in_diag, y, n_src, n_dst, d_in, d_out, add_diag, relu, stream);
  return blockell::update::launch_lists(
      blockell::RowLists<false>{row_ptr, src, nullptr, hubs, n_hubs,
                                hub_acc, nullptr},
      x, s_in, s_out, w, bias, w_self, self_coeff, x_self, x_diag, s_in_diag,
      y, n_src, n_dst, d_in, d_out, add_diag, relu, stream);
}
