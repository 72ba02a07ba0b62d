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
//
// RowLists is the one policy with no tiles (kLists): each destination row's
// entries, listed by the plan in the order that walk lists them, which the
// bodies gather directly.

#pragma once

#include <cstdint>

#include "blockell_scan.cuh"

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
  static constexpr bool kLists = false;
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
  static constexpr bool kLists = false;
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

// Per-row entry lists (core/blocksparse.py RowLists): row v's entries are
// [row_ptr[v], row_ptr[v + 1]), each an x row and, with COEF, a
// coefficient (without it every coefficient is 1: the 0/1 bitmask), in
// slot-then-k order, so sources ascending: the list a scan of the row's
// tiles makes, without the tiles.  Every row is written, a row with no
// entry its self term or zero.
// The bodies launch it as a tiling of kWarps (spmm) or TM (update) rows a
// destination block with no slots: range() is empty, so no tile is read,
// and each warp gathers its row's list instead.  A hub, a row of more than
// scan::kCap entries, is summed beforehand by a CUDA block of its own
// (blockell_hubs.cuh) into hub_acc, which its warp then reads in place of
// a gather.  order, where given, lists the spmm walk's row blocks longest
// row first, so that the rows that take longest start first.
template <bool COEF>
struct RowLists {
  static constexpr bool kLists = true;
  static constexpr bool kEveryRow = true;
  static constexpr bool kPadding = false;
  const int32_t* row_ptr;   // (n_dst + 1,)
  const int32_t* src;       // (nnz,)
  const float* coef;        // (nnz,), read only with COEF
  const int32_t* hubs;      // (n_hubs,) the hub rows, ascending
  int n_hubs;
  float* hub_acc;           // (n_hubs, d): each hub's self term and sum
  const int32_t* order;     // (ceil(n_dst / kWarps),) or null: in order

  __device__ __forceinline__ SlotRange range(int) const { return {0, 0}; }
  __device__ __forceinline__ const int32_t* slot_cols() const {
    return nullptr;
  }
  // the entries of row v: where they start, and how many (0 past n_dst)
  __device__ __forceinline__ void row(long long v, bool live, int& first,
                                      int& n) const {
    first = live ? __ldg(row_ptr + v) : 0;
    n = live ? __ldg(row_ptr + v + 1) - first : 0;
  }
  __device__ __forceinline__ scan::GlobalList<COEF> list(int first) const {
    return scan::GlobalList<COEF>{src, coef}.at(first);
  }
  // the row block the b-th CUDA block of the walk takes
  __device__ __forceinline__ int block(int b) const {
    return order != nullptr ? __ldg(order + b) : b;
  }
  // hub v's place in hubs (v must be one)
  __device__ __forceinline__ int hub(long long v) const {
    int lo = 0, hi = n_hubs - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(hubs + mid) < v) lo = mid + 1; else hi = mid;
    }
    return lo;
  }
};

}  // namespace blockell
