// Slot walks over a block-ELL, for the Hopper (sm_90a) block-ELL kernels:
// the one part in which the compact and padded kernels of a family differ.
//
// A kernel body (blockell_spmm.cuh, blockell_update.cuh) is templated on a
// Slots policy.  Its CUDA block for destination block r visits the slot ids
// s = first(r), next(r, s), ... while s < end(r); slot s holds the (bm, bk)
// tile blocks[tile(r, s)] whose source block is col(r, s).  kEveryRow says
// whether rows of a destination block with no active slot are written (the
// epilogue runs on the self term or zero) or left to the caller.

#pragma once

#include <cstdint>

namespace blockell {

// Slot-compacted (a BlockCompaction): only the n_active row-major-sorted
// slots, row r's at [row_offsets[r], row_offsets[r + 1]).  Rows of blocks
// with no active slot are left unwritten, as on the TPU; the execution plan
// patches them.
struct CompactSlots {
  static constexpr bool kEveryRow = false;
  const int32_t* row_offsets;   // (R + 1,)
  const int32_t* cols;          // (n_active,) source block of each slot

  __device__ __forceinline__ int first(int r) const { return row_offsets[r]; }
  __device__ __forceinline__ int end(int r) const { return row_offsets[r + 1]; }
  __device__ __forceinline__ int next(int, int s) const { return s + 1; }
  __device__ __forceinline__ long long tile(int, int s) const { return s; }
  __device__ __forceinline__ int col(int, int s) const { return cols[s]; }
};

// Padded (a BlockEll): the (R, W) slot table, block_cols[r, w] = -1 for a
// padding slot, which the walk skips at the cost of one (broadcast) index
// load and no tile traffic.  Every row is written, as the Pallas grid does,
// so padded plans need no patch.
struct PaddedSlots {
  static constexpr bool kEveryRow = true;
  const int32_t* block_cols;    // (R, W)
  int width;                    // W

  __device__ __forceinline__ int skip(int r, int w) const {
    const int32_t* row = block_cols + (long long)r * width;
    while (w < width && row[w] < 0) ++w;
    return w;
  }
  __device__ __forceinline__ int first(int r) const { return skip(r, 0); }
  __device__ __forceinline__ int end(int) const { return width; }
  __device__ __forceinline__ int next(int r, int w) const {
    return skip(r, w + 1);
  }
  __device__ __forceinline__ long long tile(int r, int w) const {
    return (long long)r * width + w;
  }
  __device__ __forceinline__ int col(int r, int w) const {
    return block_cols[(long long)r * width + w];
  }
};

}  // namespace blockell
