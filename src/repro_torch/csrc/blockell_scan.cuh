// Tile-scan and gather helpers shared by the zero-skipping block-ELL bodies
// (blockell_spmm.cuh, blockell_update.cuh), for Hopper (sm_90a), fp32.
//
// A warp reads a destination row's stripe of a slot's (bm, bk) tile 16
// bytes a lane (load_chunk), turns each chunk into a bitmask of its set
// entries (nonzero_mask), lists them by ballot and prefix sum as (x row,
// coefficient) pairs in shared memory, and then gathers only those rows of
// x (gather), dealt over lane groups as narrow as the feature strip allows
// (Lanes) and added in a fixed order at the end (reduce_groups).  Why a
// walk over the set entries alone gives the dense product's sum: see
// blockell_spmm.cuh.  The list walks (a RowLists, blockell_walk.cuh) gather
// the same way from a list the plan built, in global memory (GlobalList).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace blockell {
namespace scan {

constexpr int kCols = 128;    // feature columns per strip, 4 a lane
constexpr int kCap = 512;     // listed entries per warp: one step's most
constexpr int kBatch = 8;     // x rows in flight per lane
constexpr unsigned kAll = 0xffffffffu;

// E consecutive entries of a tile row as raw bits: 16 bytes, or one entry
// in .x where bk or the pointer does not allow 16-byte loads.
template <typename TileT, int E>
__device__ __forceinline__ uint4 load_chunk(const TileT* p) {
  if constexpr (E * sizeof(TileT) == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    static_assert(E == 1, "a chunk is 16 bytes or one entry");
    if constexpr (sizeof(TileT) == 1)
      return make_uint4(__ldg(p), 0u, 0u, 0u);
    else
      return make_uint4(__float_as_uint(__ldg(p)), 0u, 0u, 0u);
  }
}

// bit i set: entry i of the chunk is nonzero (for fp32, +0 and -0 are zero)
template <typename TileT, int E>
__device__ __forceinline__ unsigned nonzero_mask(uint4 c) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
  unsigned m = 0;
  if constexpr (sizeof(TileT) == 1) {
#pragma unroll
    for (int q = 0; q < (E + 3) / 4; ++q) {
      unsigned t = w[q] | (w[q] >> 4);
      t |= t >> 2;
      t |= t >> 1;                     // bit 8j: byte j is nonzero
      m |= ((t & 1u) | ((t >> 7) & 2u) | ((t >> 14) & 4u)
            | ((t >> 21) & 8u)) << (4 * q);
    }
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q) m |= unsigned((w[q] << 1) != 0u) << q;
  }
  return m;
}

template <typename TileT>
__device__ __forceinline__ float entry(uint4 c, int i) {
  if constexpr (sizeof(TileT) == 1) {
    const unsigned w = i < 8 ? (i < 4 ? c.x : c.y) : (i < 12 ? c.z : c.w);
    return static_cast<float>((w >> (8 * (i & 3))) & 0xffu);
  } else {
    return __uint_as_float(i < 2 ? (i == 0 ? c.x : c.y)
                                 : (i == 2 ? c.z : c.w));
  }
}

// This lane's place in the gathers: entries e = g, g + G, g + 2G, ... of
// the list go to lane group g of G groups of lg = 32 / G lanes; lane j of
// a group holds 4 feature columns of the warp's strip, as one float4 (V =
// 4: columns c0 + 4j .. c0 + 4j + 3) or 4 floats lg apart (V = 1: c0 + j +
// lg*q).  G = 32 / lg with lg the fewest lanes (a power of 2) that cover
// the strip, so narrow rows keep every lane busy.
template <int V>
struct Lanes {
  int g, G, j, lg, c0;

  __device__ __forceinline__ Lanes(int lane, int d, int strip) {
    const int w = min(d - strip * kCols, kCols);      // columns in the strip
    const int need = (w + 3) / 4;                    // 4 columns a lane
    lg = 1;
    while (lg < need) lg <<= 1;
    G = 32 / lg;
    g = lane / lg;
    j = lane % lg;
    c0 = strip * kCols;
  }
  __device__ __forceinline__ int col(int q) const {
    return V == 4 ? c0 + 4 * j + q : c0 + j + lg * q;
  }
  // this lane's 4 columns of row i of base (0 past d)
  __device__ __forceinline__ void load(const float* __restrict__ base,
                                       long long i, int d,
                                       float (&v)[4]) const {
    const float* p = base + i * d;
    if constexpr (V == 4) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col(0) < d) t = __ldg(reinterpret_cast<const float4*>(p + col(0)));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = col(q) < d ? __ldg(p + col(q)) : 0.f;
    }
  }
};

// Add the lane groups' partial sums, in a fixed order; every group ends
// with the total.
template <int V>
__device__ __forceinline__ void reduce_groups(const Lanes<V>& ln,
                                              float (&acc)[4]) {
  for (int o = 16; o >= ln.lg; o >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += __shfl_xor_sync(kAll, acc[q], o);
  }
}

// A list of (x row, coefficient) entries: a warp's, in shared memory (the
// scan's) ...
struct SharedList {
  const int* src;
  const float* a;
  __device__ __forceinline__ int row(int e) const { return src[e]; }
  __device__ __forceinline__ float coef(int e) const { return a[e]; }
};

// ... or a row's, in global memory (a RowLists row), every coefficient 1
// without COEF
template <bool COEF>
struct GlobalList {
  const int32_t* __restrict__ src;
  const float* __restrict__ a;
  __device__ __forceinline__ int row(int e) const { return __ldg(src + e); }
  __device__ __forceinline__ float coef(int e) const {
    return COEF ? __ldg(a + e) : 1.0f;
  }
  __device__ __forceinline__ GlobalList at(long long e) const {
    return {src + e, COEF ? a + e : a};
  }
};

// Accumulate this lane group's share of the list's first n entries: B
// (kBatch) rows of x in flight per lane, their loads issued before any of
// their FMAs (an index past n reads entry n - 1 and adds nothing), the FMAs
// in list order, whatever B is.
template <int V, bool SCALED, int B = kBatch, typename List>
__device__ __forceinline__ void gather(const List& list, int n,
                                       const Lanes<V>& ln,
                                       const float* __restrict__ x,
                                       const float* __restrict__ s_in, int d,
                                       float (&acc)[4]) {
  __syncwarp();
  for (int e0 = ln.g; e0 < n; e0 += B * ln.G) {
    float xv[B][4], sv[B], av[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int e = min(e0 + u * ln.G, n - 1);
      const int src = list.row(e);
      av[u] = list.coef(e);
      sv[u] = SCALED ? __ldg(s_in + src) : 1.0f;
      ln.load(x, src, d, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (e0 + u * ln.G < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = fmaf(av[u], SCALED ? xv[u][q] * sv[u] : xv[u][q], acc[q]);
      }
    }
  }
  __syncwarp();
}

}  // namespace scan
}  // namespace blockell
