// Block-ELL SpMM over per-row entry lists for Hopper (sm_90a), fp32: the
// list walk of spmm_blockell_compact (kernel 3).  Same function, per
// destination row v:
//
//   y[v] = s_out[v] * ( [s_in_diag[v] * x_diag[v]]
//                       + sum_{e in [row_ptr[v], row_ptr[v + 1])}
//                             coef[e] * s_in[src[e]] * x[src[e]] )
//
// where the entries are those a walk over the compacted tiles would list
// (core/blocksparse.py row_lists), so no tile is read.  Every row is
// written, a row with no entry its self term or zero.  The body is
// blockell_spmm.cuh's with the RowLists walk of blockell_walk.cuh; see that
// header for what bounds it.

#include "blockell_spmm.cuh"

// Plain C entry point for ctypes.  Pointers are device pointers; coef may
// be null (every coefficient 1); hubs lists the n_hubs rows of more than 512
// entries, ascending, and hub_acc is (n_hubs, d) of scratch (both unread
// when n_hubs is 0); order, which may be null, lists the walk's blocks of
// 4 rows in the order to take them; x_diag and s_in_diag (n_dst rows) are
// read only when add_diag is set.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success).
extern "C" int spmm_blockell_lists(const int32_t* row_ptr,
                                   const int32_t* src, const float* coef,
                                   const int32_t* hubs,
                                   const int32_t* order, float* hub_acc,
                                   const float* x, const float* s_in,
                                   const float* s_out, const float* x_diag,
                                   const float* s_in_diag, float* y,
                                   int n_hubs, int n_src, int n_dst, int d,
                                   int add_diag, void* stream) {
  if (coef != nullptr)
    return blockell::spmm::launch_lists(
        blockell::RowLists<true>{row_ptr, src, coef, hubs, n_hubs, hub_acc,
                                 order},
        x, s_in, s_out, x_diag, s_in_diag, y, n_src, n_dst, d, add_diag,
        stream);
  return blockell::spmm::launch_lists(
      blockell::RowLists<false>{row_ptr, src, nullptr, hubs, n_hubs,
                                hub_acc, order},
      x, s_in, s_out, x_diag, s_in_diag, y, n_src, n_dst, d, add_diag,
      stream);
}
