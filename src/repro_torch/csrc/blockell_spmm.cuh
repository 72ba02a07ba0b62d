// Block-ELL aggregation for Hopper (sm_90a), fp32: the body of
// spmm_blockell_compact.cu (kernel 3), its list walk spmm_blockell_lists.cu,
// spmm_blockell_fused.cu (kernel 2) and spmm_blockell.cu (kernel 1), per
// destination block r:
//
//   y[rows of r] = s_out * ( [s_in_diag * x_diag]_r
//                            + sum_{slots s of r} A_s (s_in * x_tile(col_s)) )
//
// or, with the scales compiled out (SCALED = false), exactly y = A x.  The
// slots come from a walk policy of blockell_walk.cuh: the compact one over
// the n_active slots of a BlockCompaction, the padded one over the (R, W)
// table of a BlockEll.  A_s is a (bm, bk) tile, uint8 0/1 (the exact
// bitmask) or fp32.  The list walk (RowLists) reads no tile: the plan lists
// each row's set entries from the edges, in the order the scan below lists
// them, and the warp goes straight to its gather.
//
// Translation.  The Pallas grid runs its slots in order, keeps one output
// block resident across a row's consecutive slots (first/last predicates)
// and multiplies every dense tile on the MXU.  On Cora's plans the tiles
// are 0.13% full (~22 set entries in 16,384), so here no tile is
// multiplied.  A warp owns one destination row (and a strip of up to 128
// feature columns).  It reads that row's stripe of every slot's tile, the
// slots flattened into one run of count * bk entries, 16 bytes a lane (16
// uint8 entries or 4 fp32; 4 uint8 stripes of bk = 128 a warp load), kDepth
// loads in flight and none waiting on an index.  A warp ballot and prefix
// sum list the set entries, in slot-then-k order, in the warp's shared
// memory as (x row, coefficient) pairs.  The lanes then gather only those
// rows of x: lane groups as narrow as the strip allows (4 lanes, a float4
// each, at d = 16: 8 entries at once) take every G-th entry, kBatch rows in
// flight a lane, and add their partial sums in a fixed butterfly at the
// end.  Where a strip needs all 32 lanes for one entry and one row's list
// is far longer than its CUDA block's mean (a hub of a transposed plan),
// the block's warps cut the block's lists into equal ranges and each row
// adds the warps' partial sums in warp order.  The self term comes first,
// s_out last, then one store.  No atomics, and the order of every sum is
// fixed by the data alone, so a rerun is bit-identical.  The 128-lane
// padding of d, the zero-padded x of C*bk rows and the 2-D scales of the
// TPU plan are gone: x keeps (n_src, d), the scales are 1-D, and the kernel
// masks every ragged edge itself.
//
// Why skipping zeros leaves the sum unchanged.  The dense product adds
// fmaf(a, v, acc) for every entry a of a row.  For a zero entry and finite
// v that is fmaf(0, v, acc) == acc exactly, so a walk over the set entries
// alone, in the same order, gives the same fp32 sum bit for bit, for 0/1
// tiles and for the zeros of fp32 tiles alike (only a non-finite x under a
// zero entry, which the dense chain turns into NaN, is dropped).  Within a
// lane group this kernel keeps that order; where groups or warps split a
// row, it adds their partial sums in a fixed order: the same products,
// reassociated, within the port's 1e-5 fp32 bar.  Plain fp32 FMA, no TF32.
//
// What bounds it on an H100.  Arithmetic is 2*nnz*d FLOP, nothing.  The
// tile walk must read every active tile: on Cora at bm = bk = 128 (~460-480
// active slots) ~7.6-7.9 MB of uint8 tiles (~2.3 us at 3.35 TB/s) and one
// d-wide row of x per edge.  It takes ~8 us (chip_smoke.py): the launch and
// its first loads, then the scan's six dependent steps of 16-byte loads a
// row, then one or two rounds of gathers.  On CITESEER-S the tiles are 8.36
// GB a direction (510 k tiles, 1.6 entries each): 2.5 ms of reading for
// 0.81 M entries.  The list walk reads the list (4 B an entry, 8 with
// coef), the row pointers, x's gathered rows and y once: at CITESEER-S's
// d = 16-256 that is 23-800 MB, and the walk is bound by the latency of
// three dependent loads a row (row pointer, list, x rows), ~3.6 entries a
// row, at 12 CUDA blocks of 4 warps an SM (8 where columns are scalar).
// Hubs (blockell_hubs.cuh) and longest-first order (RowLists::order) keep
// the longest rows of a transposed plan from ending the launch alone.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "blockell_hubs.cuh"
#include "blockell_scan.cuh"
#include "blockell_walk.cuh"

namespace blockell {
namespace spmm {

constexpr int kWarps = 4;              // destination rows per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 2;              // tile chunks in flight per lane
constexpr int kMinBlocks = 5;          // CUDA blocks resident per SM
constexpr int kListBlocks = 12;        // ... for the list walk, float4
constexpr int kListBlocksScalar = 8;   // ... and scalar columns
constexpr int kListBatch = 4;          // x rows in flight a lane, lists
constexpr int kShare = 64;             // a longer list than this, and than
                                       // twice the block's mean, is shared
using namespace scan;   // kCols, kCap, kBatch, kAll and the scan helpers

// E: tile entries a lane loads at once; V: see Lanes.  SCALED: s_in, s_out
// and the optional self term (kernels 2 and 3); without it, y = A x
// (kernel 1).  The self term reads rows < n_diag of x_diag.  With RowLists
// the tile arguments go unread (blocks is null, E 1).
template <typename Slots, typename TileT, int E, int V, bool SCALED>
__global__ void __launch_bounds__(
    kThreads, !Slots::kLists ? kMinBlocks
                             : V == 4 ? kListBlocks : kListBlocksScalar)
kernel(Slots slots, const TileT* __restrict__ blocks,
       const float* __restrict__ x, const float* __restrict__ s_in,
       const float* __restrict__ s_out, const float* __restrict__ x_diag,
       const float* __restrict__ s_in_diag, float* __restrict__ y, int n_src,
       int n_dst, int n_diag, int bm, int bk, int d, int add_diag) {
  __shared__ int list_src[kWarps][kCap];
  __shared__ float list_a[kWarps][kCap];
  __shared__ int list_n[kWarps];
  __shared__ int list_at[kWarps];                 // list walk: row's first
  __shared__ float part[kWarps][kWarps][kCols];   // [warp][row][column]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strips = (bm + kWarps - 1) / kWarps;
  int r = blockIdx.x / strips;
  if constexpr (Slots::kLists) r = slots.block(r);   // longest rows first
  const int m = (blockIdx.x % strips) * kWarps + warp;   // row inside r
  const long long row = (long long)r * bm + m;
  // a warp past the block's rows or n_dst reads nothing and writes
  // nothing, but joins the block's barriers
  const bool live = m < bm && row < n_dst;
  const SlotRange slots_r = slots.range(r);
  if (!Slots::kEveryRow && slots_r.count == 0) return;  // left to the caller
  const Lanes<V> ln(lane, d, blockIdx.y);

  const float so = SCALED && live ? s_out[row] : 1.0f;  // read early
  int first = 0, listed = 0;           // the list walk: the row's entries
  int hub = -1;                        // ... and a hub's place in hub_acc
  if constexpr (Slots::kLists) {
    slots.row(row, live, first, listed);
    if (listed > kCap) {               // summed already: no entry to list
      hub = slots.hub(row);
      listed = 0;
    }
  }

  // the row's slots as one run of count * bk entries, 32 * E a step; this
  // lane's next chunk starts at entry k0 of slot pos, and moves by dpos
  // slots and dk entries a step
  const int per_step = 32 * E;
  const int n_steps =
      live ? (slots_r.count * bk + per_step - 1) / per_step : 0;
  const int dpos = per_step / bk, dk = per_step - dpos * bk;
  int pos = lane * E / bk, k0 = lane * E - pos * bk;
  if (!live) pos = slots_r.count;                 // nothing to read
  const long long tile_elems = (long long)bm * bk;
  const int32_t* cols = slots.slot_cols() + slots_r.first;
  const TileT* tiles = blocks + slots_r.first * tile_elems + (long long)m * bk;
  // the next chunk's bits, source block and first entry; nothing here
  // waits on a load, so kDepth chunks stay in flight
  auto fetch = [&](uint4& c, int& cb, int& k) {
    c = make_uint4(0u, 0u, 0u, 0u);
    cb = -1;
    k = k0;
    if (pos < slots_r.count) {
      cb = cols[pos];
      c = load_chunk<TileT, E>(tiles + pos * tile_elems + k0);
    }
    pos += dpos;
    k0 += dk;
    if (k0 >= bk) {
      k0 -= bk;
      ++pos;
    }
  };

  int* my_src = list_src[warp];
  float* my_a = list_a[warp];
  uint4 ring[kDepth];
  int ring_cb[kDepth], ring_k[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i) fetch(ring[i], ring_cb[i], ring_k[i]);

  // self term first (the Pallas kernel's first step), in group 0's sum; a
  // hub's is in its sum
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (hub >= 0) {
    if constexpr (Slots::kLists)
      if (ln.g == 0) ln.load(slots.hub_acc, hub, d, acc);
  } else if (SCALED && add_diag && live && row < n_diag && ln.g == 0) {
    const float sd = s_in_diag[row];
    ln.load(x_diag, row, d, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] *= sd;
  }

  for (int step = 0; step < n_steps; ++step) {
    const uint4 c = ring[0];
    const int cb = ring_cb[0], k = ring_k[0];
#pragma unroll
    for (int i = 0; i + 1 < kDepth; ++i) {
      ring[i] = ring[i + 1];
      ring_cb[i] = ring_cb[i + 1];
      ring_k[i] = ring_k[i + 1];
    }
    fetch(ring[kDepth - 1], ring_cb[kDepth - 1], ring_k[kDepth - 1]);

    // the set entries of this lane's chunk (padding slots and source rows
    // past n_src have none)
    unsigned mask = 0;
    const int src0 = cb * bk + k;
    if ((c.x | c.y | c.z | c.w) != 0u && (!Slots::kPadding || cb >= 0)) {
      mask = nonzero_mask<TileT, E>(c);
      const int room = n_src - src0;
      if (room < E) mask &= room > 0 ? (1u << room) - 1u : 0u;
    }
    const int cnt = __popc(mask);
    if (!__any_sync(kAll, cnt)) continue;
    int incl = cnt;                      // inclusive prefix sum over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kAll, incl, 31);
    if (listed + total > kCap) {
      gather<V, SCALED>(SharedList{my_src, my_a}, listed, ln, x, s_in, d,
                        acc);
      listed = 0;
    }
    int at = listed + incl - cnt;
    while (mask) {                       // this lane's entries, in k order
      const int i = __ffs(mask) - 1;
      mask &= mask - 1;
      my_src[at] = src0 + i;
      my_a[at] = entry<TileT>(c, i);
      ++at;
    }
    listed += total;
  }
  // Each warp gathers its own list, unless a strip needs every lane for
  // one entry (G = 1) and one list (a hub row) is much longer than the
  // block's mean: then the block's entries are cut into kWarps equal
  // ranges, one a warp, and each row adds its partial sums in warp order.
  // Either way the order is fixed by the data alone.  Row rho's list from
  // its entry a: the warp's in shared memory, or the plan's.
  auto list_of = [&](int rho, int a) {
    if constexpr (Slots::kLists)
      return slots.list(list_at[rho] + a);
    else
      return SharedList{list_src[rho] + a, list_a[rho] + a};
  };
  bool share = false;
  int total = 0;
  if (ln.G == 1) {                     // the same in every warp of the block
    if (lane == 0) {
      list_n[warp] = listed;
      list_at[warp] = first;
    }
    __syncthreads();
    int longest = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += list_n[w];
      longest = max(longest, list_n[w]);
    }
    share = longest > kShare && longest * kWarps > 2 * total;
  }
  if (!share) {
    if constexpr (Slots::kLists)
      gather<V, SCALED, kListBatch>(slots.list(first), listed, ln, x, s_in,
                                    d, acc);
    else
      gather<V, SCALED>(SharedList{my_src, my_a}, listed, ln, x, s_in, d,
                        acc);
  }
  reduce_groups(ln, acc);
  // warp w's range of row rho's list: [a, b)
  auto range = [&](int w, int rho, int& a, int& b) {
    int first = 0;
    for (int i = 0; i < rho; ++i) first += list_n[i];
    a = max(w * total / kWarps - first, 0);
    b = min((w + 1) * total / kWarps - first, list_n[rho]);
  };
  if (share) {
    for (int rho = 0; rho < kWarps; ++rho) {
      int a, b;
      range(warp, rho, a, b);
      if (a >= b) continue;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      gather<V, SCALED, Slots::kLists ? kListBatch : kBatch>(
          list_of(rho, a), b - a, ln, x, s_in, d, p);
      reduce_groups(ln, p);
      if (ln.g == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) part[warp][rho][ln.col(q) - ln.c0] = p[q];
      }
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      int a, b;
      range(w, warp, a, b);
      if (a >= b) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += part[w][warp][ln.col(q) - ln.c0];
    }
  }
  if (!live || ln.g != 0) return;

  // s_out last (the Pallas kernel's last step), then the one store
  float* out = y + row * d;
  if constexpr (V == 4) {
    if (ln.col(0) < d)
      *reinterpret_cast<float4*>(out + ln.col(0)) =
          SCALED ? make_float4(acc[0] * so, acc[1] * so, acc[2] * so,
                               acc[3] * so)
                 : make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ln.col(q) < d) out[ln.col(q)] = SCALED ? acc[q] * so : acc[q];
  }
}

template <typename Slots, typename TileT, int E, bool SCALED>
void launch_typed(dim3 grid, cudaStream_t st, bool float4_cols, Slots slots,
                  const TileT* blocks, const float* x, const float* s_in,
                  const float* s_out, const float* x_diag,
                  const float* s_in_diag, float* y, int n_src, int n_dst,
                  int n_diag, int bm, int bk, int d, int add_diag) {
  if (float4_cols)
    kernel<Slots, TileT, E, 4, SCALED><<<grid, kThreads, 0, st>>>(
        slots, blocks, x, s_in, s_out, x_diag, s_in_diag, y, n_src, n_dst,
        n_diag, bm, bk, d, add_diag);
  else
    kernel<Slots, TileT, E, 1, SCALED><<<grid, kThreads, 0, st>>>(
        slots, blocks, x, s_in, s_out, x_diag, s_in_diag, y, n_src, n_dst,
        n_diag, bm, bk, d, add_diag);
}

template <bool SCALED, typename Slots>
int launch(Slots slots, int n_row_blocks, const void* blocks, int tile_is_u8,
           const float* x, const float* s_in, const float* s_out,
           const float* x_diag, const float* s_in_diag, float* y, int n_src,
           int n_dst, int n_diag, int bm, int bk, int d, int add_diag,
           void* stream) {
  const dim3 grid(n_row_blocks * ((bm + kWarps - 1) / kWarps),
                  (d + kCols - 1) / kCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool float4_cols = d % 4 == 0 && aligned(x) && aligned(y)
                           && !(SCALED && add_diag && !aligned(x_diag));
  if (tile_is_u8) {
    const auto* b = static_cast<const uint8_t*>(blocks);
    if (bk % 16 == 0 && aligned(b))
      launch_typed<Slots, uint8_t, 16, SCALED>(
          grid, st, float4_cols, slots, b, x, s_in, s_out, x_diag, s_in_diag,
          y, n_src, n_dst, n_diag, bm, bk, d, add_diag);
    else
      launch_typed<Slots, uint8_t, 1, SCALED>(
          grid, st, float4_cols, slots, b, x, s_in, s_out, x_diag, s_in_diag,
          y, n_src, n_dst, n_diag, bm, bk, d, add_diag);
  } else {
    const auto* b = static_cast<const float*>(blocks);
    if (bk % 4 == 0 && aligned(b))
      launch_typed<Slots, float, 4, SCALED>(
          grid, st, float4_cols, slots, b, x, s_in, s_out, x_diag, s_in_diag,
          y, n_src, n_dst, n_diag, bm, bk, d, add_diag);
    else
      launch_typed<Slots, float, 1, SCALED>(
          grid, st, float4_cols, slots, b, x, s_in, s_out, x_diag, s_in_diag,
          y, n_src, n_dst, n_diag, bm, bk, d, add_diag);
  }
  return static_cast<int>(cudaGetLastError());
}

// The list walk: kWarps consecutive rows a CUDA block, launched as a tiling
// of bm = kWarps rows (bk = 1) with no slots.
template <bool COEF>
int launch_lists(RowLists<COEF> lists, const float* x, const float* s_in,
                 const float* s_out, const float* x_diag,
                 const float* s_in_diag, float* y, int n_src, int n_dst,
                 int d, int add_diag, void* stream) {
  if (n_dst == 0) return 0;
  const dim3 grid((n_dst + kWarps - 1) / kWarps, (d + kCols - 1) / kCols);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool float4_cols = d % 4 == 0 && aligned(x) && aligned(y)
                           && !(add_diag && !aligned(x_diag));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  hubs::launch(lists, x, s_in, x_diag, s_in_diag, d, add_diag, st);
  launch_typed<RowLists<COEF>, float, 1, true>(
      grid, st, float4_cols, lists, nullptr, x, s_in, s_out, x_diag,
      s_in_diag, y, n_src, n_dst, n_dst, kWarps, 1, d, add_diag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spmm
}  // namespace blockell
