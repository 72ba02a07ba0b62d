// Slot walks over a block-ELL, for the Hopper (sm_90a) block-ELL kernels:
// the one part in which the compact and padded kernels of a family differ.
//
// A kernel body (blockell_spmm.cuh, blockell_update.cuh) is templated on a
// Slots policy.  Destination block r owns the slot ids
// range(r).first + p for p in [0, range(r).count): slot s holds the (bm, bk)
// tile blocks[s], whose source block is slot_cols()[s] (-1 for a padding
// slot, which only the padded walk has: kPadding).  kEveryRow says whether
// rows of a destination block with no active slot are written (the
// epilogue runs on the self term or zero) or left to the caller.
//
// Both bodies flatten a destination row's slots into one run of count * bk
// tile entries (slot-major, then k) and let the lanes of a warp read it 16
// bytes at a time, all of a row's chunks independent of one another:
// range() and slot_cols().

#pragma once

#include <cstdint>

namespace blockell {

// The slots of one destination block: ids first .. first + count - 1.
struct SlotRange {
  long long first;
  int count;
};

// Slot-compacted (a BlockCompaction): only the n_active row-major-sorted
// slots, row r's at [row_offsets[r], row_offsets[r + 1]).  Rows of blocks
// with no active slot are left unwritten, as on the TPU; the execution plan
// patches them.
struct CompactSlots {
  static constexpr bool kEveryRow = false;
  static constexpr bool kPadding = false;
  const int32_t* row_offsets;   // (R + 1,)
  const int32_t* cols;          // (n_active,) source block of each slot

  __device__ __forceinline__ SlotRange range(int r) const {
    const int a = row_offsets[r];
    return {a, row_offsets[r + 1] - a};
  }
  __device__ __forceinline__ const int32_t* slot_cols() const { return cols; }
};

// Padded (a BlockEll): the (R, W) slot table, block_cols[r, w] = -1 for a
// padding slot.  The walks read its (zero) tile stripe with the others, so
// that no load waits on an index, and mask it.  Row r's slots are ids
// r * W .. r * W + W - 1, so the table's own row-major order is the slot
// order.  Every row is written, as the Pallas grid does, so padded
// plans need no patch.
struct PaddedSlots {
  static constexpr bool kEveryRow = true;
  static constexpr bool kPadding = true;
  const int32_t* block_cols;    // (R, W)
  int width;                    // W

  __device__ __forceinline__ SlotRange range(int r) const {
    return {(long long)r * width, width};
  }
  __device__ __forceinline__ const int32_t* slot_cols() const {
    return block_cols;
  }
};

}  // namespace blockell
