// One-launch GNN layer over a block-ELL, for Hopper (sm_90a), fp32: the body
// of spmm_blockell_update_compact.cu (kernel 5), its list walk
// spmm_blockell_update_lists.cu, and spmm_blockell_update.cu (kernel 4), per
// destination block r:
//
//   acc = [s_in_diag * x_diag]_r + sum_{slots s of r} A_s (s_in * x)_{col_s}
//   out = (s_out * acc) @ W + c * (x_self_r @ W_self) + b,  then ReLU if asked
//
// The slots come from a walk policy of blockell_walk.cuh: the compact one
// over the n_active slots of a BlockCompaction (rows of blocks with no
// active slot unwritten), the padded one over the (R, W) table of a BlockEll
// (every row gets the epilogue, its acc the self term or zero), or the list
// walk over a RowLists (every row written; the plan's list of each row's
// set entries gathered with no tile read).  A_s is a (bm, bk) tile, uint8
// 0/1 (the exact bitmask) or fp32.  W_self, c, b, the self term and ReLU
// are each optional; c is read from device memory (a trained parameter,
// 1 + eps for GIN), so the host never waits for it.
//
// Translation.  The Pallas grid walks the slots in order, multiplies every
// dense tile on the MXU into a (bm, d_in) fp32 accumulator, and keeps the
// whole (d_in, d_out) W resident in VMEM for the product after a row's last
// slot.  On the card a block has at most 227 KB of shared memory (at d_in =
// 1433 the accumulator alone is 733 KB), and on Cora's plans the tiles are
// 0.13% full, so here no tile is multiplied.  Each CUDA block owns one
// (destination block r, 8-row strip, strip of d_out: 128 columns, or 32
// where d_out <= 32); each of its 8 warps owns one row of the strip.
//
// - Aggregation, skipping zeros (the helpers of blockell_scan.cuh, as in
//   blockell_spmm.cuh).  A warp reads its row's stripes of every slot's
//   tile once, as one run of count x bk entries, 16 bytes a lane with
//   kDepth chunks in flight, and lists the set entries (x row, coefficient)
//   in its shared list, in slot-then-k order.  Then, for each 128-column
//   chunk of d_in, it gathers only those rows of x (scaled by s_in) into
//   the row's chunk accumulator after the self term, in lane groups as
//   narrow as the chunk allows; at d_in = 1433 the 12 chunks reuse one
//   list.  A row with more entries than the list holds (a hub) is gathered
//   whenever the list fills and scanned again for every chunk.  The list
//   walk gathers each chunk straight from the plan's list; its hubs are
//   summed beforehand (blockell_hubs.cuh).
// - Epilogue.  The chunk, scaled by s_out (plus c * x_self when W_self is
//   W: GIN passes one tensor, the same function with one product), and
//   c * x_self beside it for a separate W_self, is multiplied in shared
//   memory by the matching rows of W (and W_self), 32 at a time (W's first
//   slice loading during the aggregation, each next one during the
//   product), into an output strip held in registers (4 or 1 columns a
//   thread): plain fp32 FMA, no TF32 (the port's parity bar is 1e-5).
//   Bias, ReLU and one store follow the last chunk.
//
// No atomics, and the order of every sum is fixed by the data alone, so a
// rerun is bit-identical.  The TPU padding (128-lane d_in and d_out, C*bk
// rows of x, 2-D scales) is gone: the kernel masks every ragged edge.
//
// What bounds it on an H100.  At GIN's conv shapes (reordered Cora, bm = bk
// = 128, 461 active slots, 10,556 edges, d_in = d_out = 128) one launch
// must read 7.6 MB of uint8 tiles, x (1.4 MB) and W (64 KB) and write 1.4
// MB: ~3.1 us of HBM time.  Its arithmetic is the edges' 2.7 MFLOP plus the
// W product's 89 MFLOP (~1.3 us at 67 TFLOP/s fp32).  Here it is bound by
// latency and shared memory: a warp's scan is ~6 dependent steps of
// 16-byte loads and ballots, its gathers a round or two of x rows from L2,
// and its W product reads each staged W element for one FMA (the 352
// blocks, 22 x 16, of that grid each stage all of W).  The list walk
// reads no tile: on CITESEER-S (GCN's layer 2, 16 -> 41, 227 k rows of
// ~3.6 entries) it takes ~0.17 ms, against 4.7 ms for the tile walk over
// 8.36 GB of tiles, bound by the gathers' latency: W (d_in <= 32) is
// staged once a block, not once every 8 rows between two barriers (0.38
// ms that way), in an instantiation of its own whose 64 registers fit 4
// blocks an SM (0.21 ms at the 3 of the chunked walk).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "blockell_hubs.cuh"
#include "blockell_scan.cuh"
#include "blockell_walk.cuh"

namespace blockell {
namespace update {

using namespace scan;   // kCols, kCap, kBatch, kAll and the scan helpers

constexpr int NT = 256;                  // threads: 8 warps x 32 lanes
constexpr int TM = NT / 32;              // destination rows: a warp each
constexpr int KC = kCols;                // d_in columns per chunk (128)
constexpr int TN_MAX = 128;              // d_out columns per CUDA block
constexpr int WK = 32;                   // W rows per staged slice
constexpr int kDepth = 2;                // tile chunks in flight per lane
constexpr int kMinBlocks = 2;            // CUDA blocks resident per SM
constexpr int kListBlocks = 3;           // ... for the list walk
constexpr int kListBatch = 2;            // x rows in flight a lane, lists
constexpr int kStagedBlocks = 4;         // ... for the list walk with W
constexpr int kStagedBatch = 1;          // staged once (d_in <= WK)

struct Smem {
  float g[TM][KC];      // s_out * acc (+ c * x_self when W_self is W)
  float h[TM][KC];      // c * x_self (separate W_self only)
  float w[WK][TN_MAX];  // W slice
  float v[WK][TN_MAX];  // W_self slice (separate W_self only)
  int list_src[TM][kCap];      // each warp's listed entries: x row
  float list_a[TM][kCap];      // ... and coefficient (last: the list
};                             // walk has no use for them)
constexpr int SMEM_BYTES = sizeof(Smem);   // 73,728: dynamic, above 48 KB
constexpr int SMEM_LIST_BYTES = offsetof(Smem, list_src);   // 40,960

// E: tile entries a lane loads at once; V: see Lanes (float4 columns or
// scalar ones); CPT: output columns a thread holds (4: a 128-wide strip of
// d_out a CUDA block; 1: 32, for narrow layers); STAGED: the list walk
// where all of W's rows fit one staged slice (d_in <= WK), an
// instantiation of its own so that its registers fit more blocks an SM.
template <typename Slots, typename TileT, int E, int V, int CPT,
          bool STAGED = false>
__global__ void __launch_bounds__(NT, STAGED ? kStagedBlocks
                                      : Slots::kLists ? kListBlocks
                                                      : kMinBlocks)
kernel(Slots slots, const TileT* __restrict__ blocks, const float* x,
       const float* s_in, const float* __restrict__ s_out, const float* w,
       const float* __restrict__ bias, const float* w_self,
       const float* __restrict__ self_coeff, const float* x_self,
       const float* x_diag, const float* s_in_diag, float* __restrict__ y,
       int n_src, int n_dst, int bm, int bk, int d_in, int d_out,
       int add_diag, int relu) {
  constexpr int TN = 32 * CPT;
  constexpr int W_PER_T = WK * TN / NT;  // staged W elements per thread
  const int r = blockIdx.x;
  const SlotRange rng = slots.range(r);
  if (!Slots::kEveryRow && rng.count == 0) return;   // rows left to caller

  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int m = blockIdx.y * TM + warp;   // this warp's row inside block r
  const long long row = (long long)r * bm + m;
  const int j0 = blockIdx.z * TN;         // strip of output columns
  // a warp past the block's rows or n_dst reads and writes nothing, but
  // joins the block's barriers
  const bool live = m < bm && row < n_dst;
  const bool has_self = w_self != nullptr;
  const bool fold = has_self && w_self == w;
  const bool two_w = has_self && !fold;
  const float c = self_coeff != nullptr ? *self_coeff : 1.0f;
  const float so = live ? s_out[row] : 0.0f;
  int first = 0, n_list = 0;           // the list walk: the row's entries
  int hub = -1;                        // ... and a hub's place in hub_acc
  if constexpr (Slots::kLists && !STAGED) {
    slots.row(row, live, first, n_list);
    if (n_list > kCap) {               // summed already, self term too
      hub = slots.hub(row);
      n_list = 0;
    }
  }

  // the row's slots as one run of count * bk entries, 32 * E a step; this
  // lane's next chunk starts at entry k0 of slot pos, and moves by dpos
  // slots and dk entries a step
  const int count = live ? rng.count : 0;
  const int per_step = 32 * E;
  const int n_steps = (count * bk + per_step - 1) / per_step;
  const int dpos = per_step / bk, dk = per_step - dpos * bk;
  const long long tile_elems = (long long)bm * bk;
  const int32_t* cols = slots.slot_cols() + rng.first;
  const TileT* tiles = blocks + rng.first * tile_elems + (long long)m * bk;
  int pos = 0, k0 = 0;
  // the next chunk's bits, source block and first entry; nothing here
  // waits on a load, so kDepth chunks stay in flight
  auto fetch = [&](uint4& cc, int& cb, int& k) {
    cc = make_uint4(0u, 0u, 0u, 0u);
    cb = -1;
    k = k0;
    if (pos < count) {
      cb = cols[pos];
      cc = load_chunk<TileT, E>(tiles + pos * tile_elems + k0);
    }
    pos += dpos;
    k0 += dk;
    if (k0 >= bk) {
      k0 -= bk;
      ++pos;
    }
  };

  int* my_src = s.list_src[warp];
  float* my_a = s.list_a[warp];
  int listed = 0;          // the row's entries in the list
  bool overflow = false;   // the row's entries did not all fit the list

  // scan the run and list the set entries; where the list fills, gather
  // what it holds and start it again (it then no longer holds every entry)
  auto scan_row = [&](const Lanes<V>& ln, float (&acc)[4]) {
    listed = 0;
    pos = lane * E / bk;
    k0 = lane * E - pos * bk;
    uint4 ring[kDepth];
    int ring_cb[kDepth], ring_k[kDepth];
#pragma unroll
    for (int i = 0; i < kDepth; ++i) fetch(ring[i], ring_cb[i], ring_k[i]);
    for (int step = 0; step < n_steps; ++step) {
      const uint4 cc = ring[0];
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
      if ((cc.x | cc.y | cc.z | cc.w) != 0u
          && (!Slots::kPadding || cb >= 0)) {
        mask = nonzero_mask<TileT, E>(cc);
        const int room = n_src - src0;
        if (room < E) mask &= room > 0 ? (1u << room) - 1u : 0u;
      }
      const int cnt = __popc(mask);
      if (!__any_sync(kAll, cnt)) continue;
      int incl = cnt;                    // inclusive prefix sum over lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += t;
      }
      const int total = __shfl_sync(kAll, incl, 31);
      if (listed + total > kCap) {
        gather<V, true>(SharedList{my_src, my_a}, listed, ln, x, s_in, d_in,
                        acc);
        listed = 0;
        overflow = true;
      }
      int at = listed + incl - cnt;
      while (mask) {                     // this lane's entries, in k order
        const int i = __ffs(mask) - 1;
        mask &= mask - 1;
        my_src[at] = src0 + i;
        my_a[at] = entry<TileT>(cc, i);
        ++at;
      }
      listed += total;
    }
  };

  // the W slice of rows kw .. kw + WK of chunk c0, staged through
  // registers so that its loads overlap other work; a separate W_self
  // slice is copied when it is stored (registers kept for the common case)
  float wr[W_PER_T];
  auto w_at = [&](int c0, int kc_end, int kw, int t, long long& at) {
    const int e = threadIdx.x + t * NT;
    const int kk = e / TN, col = e % TN;
    at = (long long)(c0 + kw + kk) * d_out + j0 + col;
    return kw + kk < kc_end && j0 + col < d_out;
  };
  auto load_w = [&](int c0, int kc_end, int kw) {
#pragma unroll
    for (int t = 0; t < W_PER_T; ++t) {
      long long at;
      wr[t] = w_at(c0, kc_end, kw, t, at) ? w[at] : 0.0f;
    }
  };
  auto store_w = [&](int c0, int kc_end, int kw) {
#pragma unroll
    for (int t = 0; t < W_PER_T; ++t) {
      const int e = threadIdx.x + t * NT;
      s.w[e / TN][e % TN] = wr[t];
      if (two_w) {
        long long at;
        s.v[e / TN][e % TN] =
            w_at(c0, kc_end, kw, t, at) ? w_self[at] : 0.0f;
      }
    }
  };

  // the self terms of row v: the aggregation's first (the Pallas kernel's
  // first step, in group 0's sum; a hub's is in its sum) and the epilogue's
  auto self_terms = [&](const Lanes<V>& ln, long long v, bool on, int h,
                        float (&acc)[4], float (&hv)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = hv[q] = 0.0f;
    if (!on || ln.g != 0) return;
    if (add_diag && h < 0) {
      const float sd = s_in_diag[v];
      ln.load(x_diag, v, d_in, acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] *= sd;
    }
    if (has_self) {
      ln.load(x_self, v, d_in, hv);
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[q] *= c;
    }
  };
  // s_out, then the self term, into the product's left operand (zero past
  // d_in and on a row that is not live)
  auto stage = [&](const Lanes<V>& ln, int c0, bool on, float so_v,
                   const float (&acc)[4], const float (&hv)[4]) {
    for (int col = lane; col < KC; col += 32) {
      s.g[warp][col] = 0.0f;
      if (two_w) s.h[warp][col] = 0.0f;
    }
    __syncwarp();
    if (on && ln.g == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = ln.col(q);
        if (col >= d_in) continue;
        float gv = acc[q] * so_v;
        if (fold) gv += hv[q];
        s.g[warp][col - c0] = gv;
        if (two_w) s.h[warp][col - c0] = hv[q];
      }
    }
  };
  // o += g[kw : kw + WK] @ the staged slice (+ h @ W_self's), 4 rows a
  // step (g and h read as float4), up to row kc_end rounded up to 4: past
  // it g, h and the slice are zero, which would add exactly nothing
  auto multiply = [&](int kw, int kc_end, float (&o)[CPT]) {
    const int kn = min(WK, (kc_end - kw + 3) / 4 * 4);
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(&s.g[warp][kw + kk]);
      const float4 hv4 = two_w
          ? *reinterpret_cast<const float4*>(&s.h[warp][kw + kk])
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float gi = (&gv.x)[u];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          o[j] = fmaf(gi, s.w[kk + u][lane + 32 * j], o[j]);
        if (two_w) {
          const float hi = (&hv4.x)[u];
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            o[j] = fmaf(hi, s.v[kk + u][lane + 32 * j], o[j]);
        }
      }
    }
  };
  // bias, ReLU, then the one store
  auto store = [&](long long v, const float (&o)[CPT]) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = j0 + lane + 32 * j;
      if (col < d_out) {
        float val = o[j] + (bias != nullptr ? bias[col] : 0.0f);
        if (relu) val = fmaxf(val, 0.0f);
        y[v * d_out + col] = val;
      }
    }
  };

  // The list walk where all of W's rows fit one staged slice (d_in <= WK:
  // GCN's 16 -> 41): the block stages its strip of W once, then each warp
  // takes rows grp * TM + warp for grp = blockIdx.x, + gridDim.x, ... and
  // multiplies each as it comes, with no barrier between rows.  The sums
  // are the ones below, in the same order.
  if constexpr (STAGED) {
    load_w(0, d_in, 0);
    store_w(0, d_in, 0);
    __syncthreads();
    const Lanes<V> ln(lane, d_in, 0);
    for (long long grp = blockIdx.x; grp * TM < n_dst; grp += gridDim.x) {
      const long long v = grp * TM + warp;
      const bool on = v < n_dst;
      int f, k, h = -1;
      slots.row(v, on, f, k);
      if (k > kCap) {
        h = slots.hub(v);
        k = 0;
      }
      float acc[4], hv[4];
      self_terms(ln, v, on, h, acc, hv);
      if (h < 0)
        gather<V, true, kStagedBatch>(slots.list(f), k, ln, x, s_in,
                                      d_in, acc);
      else if (ln.g == 0)
        ln.load(slots.hub_acc, h, d_in, acc);
      reduce_groups(ln, acc);
      stage(ln, 0, on, on ? s_out[v] : 0.0f, acc, hv);
      __syncwarp();
      float o[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) o[j] = 0.0f;
      multiply(0, d_in, o);
      if (on) store(v, o);
      __syncwarp();                  // s.g is the next row's
    }
    return;
  }

  float out[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) out[j] = 0.0f;

  for (int c0 = 0, ci = 0; c0 < d_in; c0 += KC, ++ci) {
    const Lanes<V> ln(lane, d_in, ci);
    const int kc_end = d_in - c0 < KC ? d_in - c0 : KC;
    load_w(c0, kc_end, 0);       // in flight during the aggregation
    float acc[4], hv[4];
    self_terms(ln, row, live, hub, acc, hv);
    // scan once (again for every chunk where the row's entries overflowed
    // the list), gather every chunk; the list walk gathers the plan's list
    if constexpr (Slots::kLists) {
      if (hub < 0)
        gather<V, true, kListBatch>(slots.list(first), n_list, ln, x, s_in,
                                    d_in, acc);
      else if (ln.g == 0)
        ln.load(slots.hub_acc, hub, d_in, acc);
    } else {
      if (ci == 0 || overflow) scan_row(ln, acc);
      gather<V, true>(SharedList{my_src, my_a}, listed, ln, x, s_in, d_in,
                      acc);
    }
    reduce_groups(ln, acc);
    stage(ln, c0, live, so, acc, hv);

    // out += g @ W[c0 : c0 + KC] (+ h @ W_self[...]), WK rows of W at a
    // time (the next slice's loads in flight)
    for (int kw = 0; kw < kc_end; kw += WK) {
      store_w(c0, kc_end, kw);
      __syncthreads();
      if (kw + WK < kc_end) load_w(c0, kc_end, kw + WK);
      multiply(kw, kc_end, out);
      __syncthreads();
    }
  }

  if (live) store(row, out);
}

template <typename Slots, typename TileT, int E, int V, int CPT,
          bool STAGED>
int launch_kernel(cudaStream_t st, int n_row_blocks, Slots slots,
                  const TileT* blocks, const float* x, const float* s_in,
                  const float* s_out, const float* w, const float* bias,
                  const float* w_self, const float* self_coeff,
                  const float* x_self, const float* x_diag,
                  const float* s_in_diag, float* y, int n_src, int n_dst,
                  int bm, int bk, int d_in, int d_out, int add_diag,
                  int relu) {
  auto kern = kernel<Slots, TileT, E, V, CPT, STAGED>;
  const int smem = Slots::kLists ? SMEM_LIST_BYTES : SMEM_BYTES;
  // above 48 KB of shared memory only on request; set for the current device
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_row_blocks, (bm + TM - 1) / TM,
                  (d_out + 32 * CPT - 1) / (32 * CPT));
  kern<<<grid, NT, smem, st>>>(
      slots, blocks, x, s_in, s_out, w, bias, w_self, self_coeff, x_self,
      x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in, d_out, add_diag,
      relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename Slots, typename TileT, int E, int V,
          bool STAGED = false>
int launch_width(cudaStream_t st, int n_row_blocks, Slots slots,
                const TileT* blocks, const float* x, const float* s_in,
                const float* s_out, const float* w, const float* bias,
                const float* w_self, const float* self_coeff,
                const float* x_self, const float* x_diag,
                const float* s_in_diag, float* y, int n_src, int n_dst,
                int bm, int bk, int d_in, int d_out, int add_diag, int relu) {
  // a narrow layer (d_out <= 32) takes 32 output columns a CUDA block
  if (d_out <= 32)
    return launch_kernel<Slots, TileT, E, V, 1, STAGED>(
        st, n_row_blocks, slots, blocks, x, s_in, s_out, w, bias, w_self,
        self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in,
        d_out, add_diag, relu);
  return launch_kernel<Slots, TileT, E, V, 4, STAGED>(
      st, n_row_blocks, slots, blocks, x, s_in, s_out, w, bias, w_self,
      self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in,
      d_out, add_diag, relu);
}

template <typename Slots, typename TileT, int E, bool STAGED = false>
int launch_cols(bool float4_cols, cudaStream_t st, int n_row_blocks,
                Slots slots, const TileT* blocks, const float* x,
                const float* s_in, const float* s_out, const float* w,
                const float* bias, const float* w_self,
                const float* self_coeff, const float* x_self,
                const float* x_diag, const float* s_in_diag, float* y,
                int n_src, int n_dst, int bm, int bk, int d_in, int d_out,
                int add_diag, int relu) {
  if (float4_cols)
    return launch_width<Slots, TileT, E, 4, STAGED>(
        st, n_row_blocks, slots, blocks, x, s_in, s_out, w, bias, w_self,
        self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in,
        d_out, add_diag, relu);
  return launch_width<Slots, TileT, E, 1, STAGED>(
      st, n_row_blocks, slots, blocks, x, s_in, s_out, w, bias, w_self,
      self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in,
      d_out, add_diag, relu);
}

// Returns 0 or the CUDA error of the attribute call or the launch.
template <typename Slots>
int launch(Slots slots, int n_row_blocks, const void* blocks, int tile_is_u8,
           const float* x, const float* s_in, const float* s_out,
           const float* w, const float* bias, const float* w_self,
           const float* self_coeff, const float* x_self, const float* x_diag,
           const float* s_in_diag, float* y, int n_src, int n_dst, int bm,
           int bk, int d_in, int d_out, int add_diag, int relu,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // x, and the self and diagonal rows where they are read, as float4s
  const bool float4_cols = d_in % 4 == 0 && aligned(x)
                           && !(add_diag && !aligned(x_diag))
                           && !(w_self != nullptr && !aligned(x_self));
  if (tile_is_u8) {
    const auto* b = static_cast<const uint8_t*>(blocks);
    if (bk % 16 == 0 && aligned(b))
      return launch_cols<Slots, uint8_t, 16>(
          float4_cols, st, n_row_blocks, slots, b, x, s_in, s_out, w, bias,
          w_self, self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm,
          bk, d_in, d_out, add_diag, relu);
    return launch_cols<Slots, uint8_t, 1>(
        float4_cols, st, n_row_blocks, slots, b, x, s_in, s_out, w, bias,
        w_self, self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk,
        d_in, d_out, add_diag, relu);
  }
  const auto* b = static_cast<const float*>(blocks);
  if (bk % 4 == 0 && aligned(b))
    return launch_cols<Slots, float, 4>(
        float4_cols, st, n_row_blocks, slots, b, x, s_in, s_out, w, bias,
        w_self, self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk,
        d_in, d_out, add_diag, relu);
  return launch_cols<Slots, float, 1>(
      float4_cols, st, n_row_blocks, slots, b, x, s_in, s_out, w, bias, w_self,
      self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, bm, bk, d_in,
      d_out, add_diag, relu);
}

// The list walk: TM consecutive rows a CUDA block, launched as a tiling of
// bm = TM rows (bk = 1) with no slots.
template <bool COEF>
int launch_lists(RowLists<COEF> lists, const float* x, const float* s_in,
                 const float* s_out, const float* w, const float* bias,
                 const float* w_self, const float* self_coeff,
                 const float* x_self, const float* x_diag,
                 const float* s_in_diag, float* y, int n_src, int n_dst,
                 int d_in, int d_out, int add_diag, int relu, void* stream) {
  if (n_dst == 0) return 0;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool float4_cols = d_in % 4 == 0 && aligned(x)
                           && !(add_diag && !aligned(x_diag))
                           && !(w_self != nullptr && !aligned(x_self));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  hubs::launch(lists, x, s_in, x_diag, s_in_diag, d_in, add_diag, st);
  // where W stays staged (d_in <= WK), one resident wave of blocks takes
  // every row group in turn; else a block a group
  int groups = (n_dst + TM - 1) / TM;
  if (d_in <= WK) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
        == cudaSuccess && sms > 0)
      groups = groups < sms * kStagedBlocks ? groups : sms * kStagedBlocks;
    return launch_cols<RowLists<COEF>, float, 1, true>(
        float4_cols, st, groups, lists, nullptr, x, s_in, s_out, w, bias,
        w_self, self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, TM,
        1, d_in, d_out, add_diag, relu);
  }
  return launch_cols<RowLists<COEF>, float, 1>(
      float4_cols, st, groups, lists, nullptr, x, s_in, s_out, w, bias,
      w_self, self_coeff, x_self, x_diag, s_in_diag, y, n_src, n_dst, TM, 1,
      d_in, d_out, add_diag, relu);
}

}  // namespace update
}  // namespace blockell
