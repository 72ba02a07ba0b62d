// Edge-softmax attention of GAT (arXiv:1710.10903) over per-row entry
// lists, for Hopper (sm_90a), fp32: what gat_attention.cu (forward) and
// gat_attention_bwd.cu (backward) share.
//
// Per destination row v and head h, over v's entries j (a row's list, as
// the plan's AttentionLists holds it, self loop included where the model
// takes one):
//
//   e_vj = LeakyReLU(s_dst[v, h] + s_src[j, h])
//   out[v, h] = sum_j softmax_j(e)_vj z[j, h]      lse[v, h] = log sum_j e^e_vj
//
// z is (n, H, F) row-major, so head h of node j is F consecutive floats.
// A warp takes one (row, head): its lanes hold the F columns, V floats a
// load (float4 where F % 4 == 0 and the pointers are 16-byte aligned) and
// K loads a lane.  The warp walks the list 32 entries at a time: lane t
// loads entry t's index and score, the chunk's max updates the running max
// (the running sums rescaled once a chunk: one pass, an online softmax),
// then each entry's weight and index are broadcast and its z row gathered.
// No (entries, H) tensor is made in the forward.
//
// The lists' geometry is the block-ELL list walk's (kernels/spmm_blockell.py
// list_arrays): a row of more than kHubEntries entries is a hub, split
// across the kHubWarps warps of a CUDA block of its own, whose partial
// results merge in warp order (a log-sum-exp merge in the forward); the
// walk's blocks of kWalkRows rows run in the plan's order, longest first.
// Every sum runs in an order fixed by the data alone, and a warp's
// reductions are xor butterflies, which leave the same bits on every lane,
// so a rerun is bit-identical.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace gat {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHubEntries = 512;   // kernels/spmm_blockell.py HUB_ENTRIES
constexpr int kWalkRows = 4;       // kernels/spmm_blockell.py WALK_ROWS
constexpr int kHubWarps = 16;
constexpr int kHubThreads = 32 * kHubWarps;
constexpr int kMaxHeads = 8;       // the backward's per-row head sums

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : x * slope;
}

// The columns of one head a lane holds: V floats at each of K places.
template <int V, int K>
struct Cols {
  int lane, f;
  __device__ __forceinline__ Cols(int lane_, int f_) : lane(lane_), f(f_) {}
  __device__ __forceinline__ int col(int k) const { return (k * 32 + lane) * V; }
  __device__ __forceinline__ bool has(int k) const { return col(k) < f; }

  __device__ __forceinline__ void load(const float* __restrict__ row,
                                       float (&v)[K][V]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (V == 4) {
        float4 t = has(k) ? __ldg(reinterpret_cast<const float4*>(row + col(k)))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        v[k][0] = t.x; v[k][1] = t.y; v[k][2] = t.z; v[k][3] = t.w;
      } else {
        v[k][0] = has(k) ? __ldg(row + col(k)) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ row,
                                        const float (&v)[K][V],
                                        float scale) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!has(k)) continue;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(row + col(k)) =
            make_float4(v[k][0] * scale, v[k][1] * scale, v[k][2] * scale,
                        v[k][3] * scale);
      } else {
        row[col(k)] = v[k][0] * scale;
      }
    }
  }
};

template <int V, int K>
__device__ __forceinline__ void zero(float (&v)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < V; ++q) v[k][q] = 0.f;
}

// The (n, H, F) row of node j, head h.
__device__ __forceinline__ const float* head_row(const float* base,
                                                 long long j, int H, int h,
                                                 int F) {
  return base + (j * H + h) * (long long)F;
}

// Launch configuration shared by both directions: the float width of a load
// and the loads a lane, or false where F is wider than a warp can hold.
struct Shape {
  int v, k;
};

inline bool pick_shape(int F, bool aligned, Shape& s) {
  s.v = (F % 4 == 0 && aligned) ? 4 : 1;
  for (s.k = 1; s.k <= 8; s.k *= 2)
    if (s.k * 32 * s.v >= F) return true;
  return false;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Every (V, K) a launch may pick: X(V, K) for each.
#define GAT_SHAPES(X) \
  X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(1, 1) X(1, 2) X(1, 4) X(1, 8)

}  // namespace gat
