// EmbeddingBag for Hopper (sm_90a), fp32:
//
//   out[b] = sum_{i: bags[i] = b} weights[i] * table[ids[i]]
//
// over entries sorted by bag, every bag written (an empty bag as zeros).
//
// Replaces repro/kernels/embedding_bag.py::embedding_bag, the Pallas TPU
// kernel, and takes its contract: a bag id per entry, sorted, plus the bag
// count (no offsets, so no caller searches num_bags + 1 bounds).  Its grid
// takes one id per step and keeps the bag's output block resident from one
// step to the next (a sequential carry); CUDA blocks run in parallel and in
// no order, so here each warp owns a contiguous range of output rows (the
// rows split evenly over the warps the card holds at once) and no other
// warp touches them.  The warp finds its range's entries with two 32-ary
// searches over the sorted bag ids, side by side (32 probes a step, one
// ballot: 5 dependent steps over 2.6 M entries).  No atomics, so a rerun is
// bit-identical.  Two mappings, chosen by the shape of the table:
//
//   rows  (d % 4 == 0, table and out 16-byte aligned: the deep table, d = 32)
//         Groups of min(32, d/4) lanes per row, float4 loads and stores (at
//         d = 32 a warp instruction moves four rows, 512 B).  The warp walks
//         its entries in 32-entry windows, the next window's indices loaded
//         before this one's gathers; each window's complete runs of one bag
//         are dealt to the groups, which issue up to 8 gathers before their
//         first add and store each run's row when it ends.  The rows between
//         runs are zero stores across the whole warp, written while the
//         first gathers are in flight.  A run longer than the window is
//         split over the groups and their partials added in group order.
//         A sparse output (at least kSparse bags an entry: a backward, 0.066
//         ids a row) is zeroed first by a pass of streaming stores alone,
//         and the rows kernel then writes only the rows with entries: on an
//         H100 the two passes (1.89 ms at 40 M x 32) beat one pass that
//         mixes zero stores with random gathers (2.12 ms).
//   lanes (any other d or alignment: the wide table, d = 1)
//         A lane per entry, 128 entries a batch (the next batch's indices
//         loaded before this one's gathers), and a segmented shuffle sum over
//         each 32-entry sub-chunk: a warp sums many short bags at once, and a
//         long one in 32-entry pieces.  The sums land in a tile of the
//         warp's rows in shared memory, written out whole, zeros included,
//         as 16-byte stores across the warp; a tile no entry reaches is
//         written as zeros straight away.
//
// What bounds it on an H100: bytes.  Each entry brings a table row (4d B, a
// 32-B sector at least) and 12 B of bag, id and weight; each row of out is
// written once (4d B).  The deep lookup at B = 65,536 x 40 fields moves
// ~0.7 GB (~0.21 ms at 3.35 TB/s).  The backward, this kernel over the
// transposed entries (sorted by table row, one bag per row), writes the
// whole table gradient: 5.12 GB at 40 M x 32 (~1.6 ms), 93% of it rows no
// entry reaches, and 160 MB at d = 1.  Random 4-byte gathers (the wide
// lookup) run at the card's random-sector rate, not its bandwidth.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // warps per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinBlocks = 2;           // blocks an SM holds: 128 registers
constexpr int kTile = 1024;             // lanes: floats of a warp's tile
constexpr int kSub = 4;                 // lanes: 32-entry sub-chunks a batch
constexpr int kAhead = 8;               // rows: gathers before the first add
constexpr long long kL2Bytes = 50LL << 20;
// rows: bags an entry for a zero pass.  The pass rewrites the rows with
// entries, at most 1/kSparse of out's bytes.  Only two ratios were timed on
// an H100 (the lookups' 1 bag an entry, one pass faster; the wide & deep
// backwards' 15.3, two passes faster): the crossover between them is not
// measured, and 8 only has to tell those apart.
constexpr int kSparse = 8;

struct Plan {
  int rows;          // 1: the rows mapping, 0: lanes
  int rows_per_warp;
  int warps;
  int tile_rows;     // lanes: rows a tile holds
  int width;         // lanes: columns a tile holds (d, or kTile past it)
  int stream;        // streaming stores: the output outgrows L2
  int zero_pass;     // rows: out is zeroed first, rows with entries follow
  int zero_blocks;   // the zero pass's grid
};

// A warp's shared memory.  Lanes: its output tile.  Rows: one window's
// entries (ids, weights) and complete runs (start, end, bag), and the lane
// groups' partial sums of a run longer than the window.
struct LanesWarp {
  __align__(16) float buf[kTile];
};
struct RowsWarp {
  float4 part[32];
  int id[32];
  float w[32];
  int bag[32];
  int run_s[32];
  int run_e[32];
};

// One 32-ary step of a search for the first index in [lo, hi) whose bag is
// >= target (bags sorted): 32 probes, one ballot; a no-op once the range
// is 32 long or less.
__device__ __forceinline__ void narrow(const int32_t* __restrict__ bags,
                                       int& lo, int& hi, int target,
                                       int lane) {
  if (hi - lo <= 32) return;
  const long long s = (static_cast<long long>(hi) - lo + 31) / 32;
  const long long p = lo + (lane + 1) * s - 1;
  const bool below = p < hi && __ldg(bags + p) < target;
  const long long lo2 = lo + __popc(__ballot_sync(kFull, below)) * s;
  hi = static_cast<int>(min(static_cast<long long>(hi), lo2 + s));
  lo = static_cast<int>(lo2);
}

__device__ __forceinline__ int finish(const int32_t* __restrict__ bags,
                                      int lo, int hi, int target, int lane) {
  const bool below = lo + lane < hi && __ldg(bags + lo + lane) < target;
  return lo + __popc(__ballot_sync(kFull, below));
}

// The entries of rows [r0, r1): both searches side by side, so their probes
// overlap (5 dependent steps over 2^25 entries).
__device__ int2 entry_range(const int32_t* __restrict__ bags, int n, int r0,
                            int r1, int lane) {
  int lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;
  while (hi0 - lo0 > 32 || hi1 - lo1 > 32) {
    narrow(bags, lo0, hi0, r0, lane);
    narrow(bags, lo1, hi1, r1, lane);
  }
  return make_int2(finish(bags, lo0, hi0, r0, lane),
                   finish(bags, lo1, hi1, r1, lane));
}

__device__ int lower_bound_from(const int32_t* __restrict__ bags, int lo,
                                int hi, int target, int lane) {
  while (hi - lo > 32) narrow(bags, lo, hi, target, lane);
  return finish(bags, lo, hi, target, lane);
}

// The warp's rows [r0, r1), or false if it has none.
__device__ __forceinline__ bool warp_rows(const Plan& plan, int num_bags,
                                          int& r0, int& r1) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long first = warp * plan.rows_per_warp;
  if (first >= num_bags) return false;
  r0 = static_cast<int>(first);
  r1 = static_cast<int>(
      min(static_cast<long long>(num_bags), first + plan.rows_per_warp));
  return true;
}

__device__ __forceinline__ void put(float4* p, float4 v, bool stream) {
  if (stream) __stcs(p, v); else *p = v;
}
__device__ __forceinline__ void put(float* p, float v, bool stream) {
  if (stream) __stcs(p, v); else *p = v;
}

// dst[0:n] = src[0:n] (zeros for src == nullptr), 16 bytes a lane where
// both are aligned.
__device__ void store_span(float* __restrict__ dst, const float* src,
                           long long n, int lane, bool stream) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long n4 = n >> 2;
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (long long i = lane; i < n4; i += 32)
      put(d4 + i, src ? s4[i] : make_float4(0.f, 0.f, 0.f, 0.f), stream);
    done = n4 << 2;
  }
  for (long long i = done + lane; i < n; i += 32)
    put(dst + i, src ? src[i] : 0.f, stream);
}

__device__ void zero_tile(float* buf, int n, int lane) {
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int i = lane; i < (n >> 2); i += 32)
    b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (n & ~3) + lane; i < n; i += 32) buf[i] = 0.f;
  __syncwarp();
}

// What every batch shares: the warp's entries end at p1; the tile holds
// rows [R, Rend) at columns [c0, c0 + W) of a d-wide table.
struct Tile {
  int p1, R, Rend, c0, W, d;
};

// The lanes mapping's batch: a lane's entries pos + 32 u + lane (bag
// INT_MAX past the warp's entries, id, weight), and lane 31's bag after the
// batch.
struct Lanes {
  int bag[kSub], id[kSub];
  float w[kSub];
  int after;
};

__device__ __forceinline__ void lanes_load(const int32_t* __restrict__ bags,
                                           const int32_t* __restrict__ ids,
                                           const float* __restrict__ weights,
                                           int pos, int p1, int lane,
                                           Lanes& x) {
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    const long long e = static_cast<long long>(pos) + 32 * u + lane;
    x.bag[u] = INT_MAX;
    x.id[u] = 0;
    x.w[u] = 0.f;
    if (e < p1) {
      x.bag[u] = __ldg(bags + e);
      x.id[u] = __ldg(ids + e);
      x.w[u] = __ldg(weights + e);
    }
  }
  const long long after = static_cast<long long>(pos) + 32 * kSub;
  x.after = lane == 31 && after < p1 ? __ldg(bags + after) : INT_MAX;
}

// The lanes mapping: sums the batch `cur` (at pos) into the tile s.buf as
// far as the tile reaches, loads the batch after what it took into `next`
// before its gathers, returns how many entries it took, and sets `more` if
// the tile may hold more.
__device__ int lanes_batch(const int32_t* __restrict__ bags,
                           const int32_t* __restrict__ ids,
                           const float* __restrict__ weights,
                           const float* __restrict__ table, LanesWarp& s,
                           const Tile& t, int pos, const Lanes& cur,
                           Lanes& next, bool& zeroed, bool& more, int lane) {
  int key[kSub], m[kSub];
  int total = 0;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    const bool on = cur.bag[u] < t.Rend;
    key[u] = on ? cur.bag[u] - t.R : -1;
    m[u] = __popc(__ballot_sync(kFull, on));
    total += m[u];
  }
  more = __shfl_sync(kFull, cur.after, 31) < t.Rend;
  if (total == 0) {
    next = cur;
    return 0;
  }
  lanes_load(bags, ids, weights, pos + total, t.p1, lane, next);
  if (!zeroed) {
    zero_tile(s.buf, (t.Rend - t.R) * t.W, lane);
    zeroed = true;
  }
  // runs of one bag in each sub-chunk: the lane where this lane's run
  // starts, and whether the run ends at this lane
  int start[kSub];
  bool end[kSub];
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    const int above = __shfl_up_sync(kFull, key[u], 1);
    const int below = __shfl_down_sync(kFull, key[u], 1);
    const unsigned heads =
        __ballot_sync(kFull, lane == 0 || above != key[u]);
    start[u] = 31 - __clz(heads & (kFull >> (31 - lane)));
    end[u] = lane < m[u] && (lane == 31 || below != key[u]);
  }
  for (int c = 0; c < t.W; ++c) {
    float v[kSub];
#pragma unroll
    for (int u = 0; u < kSub; ++u)
      v[u] = lane < m[u]
                 ? cur.w[u] * __ldg(table +
                                    static_cast<size_t>(cur.id[u]) * t.d +
                                    t.c0 + c)
                 : 0.f;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      if (m[u] == 0) break;                       // warp-uniform
      float x = v[u];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, x, off);
        if (lane >= start[u] + off) x += y;
      }
      if (end[u]) s.buf[key[u] * t.W + c] += x;
      __syncwarp();
    }
  }
  return total;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_lanes(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ bags,
                    const float* __restrict__ weights,
                    const float* __restrict__ table, float* __restrict__ out,
                    int n_entries, int num_bags, int d, Plan plan) {
  __shared__ LanesWarp smem[kWarps];
  const int lane = threadIdx.x & 31;
  int r0, r1;
  if (!warp_rows(plan, num_bags, r0, r1)) return;   // the whole warp
  LanesWarp& s = smem[threadIdx.x >> 5];
  const int2 range = entry_range(bags, n_entries, r0, r1, lane);
  const int p0 = range.x, p1 = range.y;
  const bool stream = plan.stream;
  for (int c0 = 0; c0 < d; c0 += plan.width) {
    Tile t;
    t.p1 = p1;
    t.c0 = c0;
    t.W = min(plan.width, d - c0);
    t.d = d;
    int pos = p0;
    Lanes cur, next;
    lanes_load(bags, ids, weights, pos, p1, lane, cur);
    for (t.R = r0; t.R < r1; t.R = t.Rend) {
      t.Rend = static_cast<int>(min(static_cast<long long>(r1),
                                    static_cast<long long>(t.R) +
                                        plan.tile_rows));
      bool zeroed = false, more = pos < p1;
      while (more) {
        pos += lanes_batch(bags, ids, weights, table, s, t, pos, cur, next,
                           zeroed, more, lane);
        cur = next;
      }
      const int n_rows = t.Rend - t.R;
      float* dst = out + static_cast<size_t>(t.R) * d + c0;
      if (t.W == d) {
        store_span(dst, zeroed ? s.buf : nullptr, n_rows * d, lane, stream);
      } else {
        for (int r = 0; r < n_rows; ++r)
          store_span(dst + static_cast<size_t>(r) * d,
                     zeroed ? s.buf + r * t.W : nullptr, t.W, lane, stream);
      }
      __syncwarp();
    }
  }
}

// A lane's entry of the rows mapping's 32-entry window: its bag (INT_MAX
// past the warp's entries), id and weight; lane 31 also reads the bag after
// the window.
struct Entry {
  int bag, id;
  float w;
  int after;
};

__device__ __forceinline__ Entry load_entry(const int32_t* __restrict__ bags,
                                            const int32_t* __restrict__ ids,
                                            const float* __restrict__ weights,
                                            int pos, int p1, int lane) {
  Entry x = {INT_MAX, 0, 0.f, INT_MAX};
  const long long e = static_cast<long long>(pos) + lane;
  if (e < p1) {
    x.bag = __ldg(bags + e);
    x.id = __ldg(ids + e);
    x.w = __ldg(weights + e);
  }
  if (lane == 31 && e + 1 < p1) x.after = __ldg(bags + e + 1);
  return x;
}

// A lane group's next kAhead entries of a window's complete runs, across
// its runs (run g, g + groups, ...), each gather issued.
struct Batch {
  int ent[kAhead], run[kAhead];
  bool last[kAhead];
  float4 v[kAhead];
};

__device__ __forceinline__ void gather(const float4* __restrict__ table4,
                                       const RowsWarp& s, int n_runs,
                                       int groups, int d4, int c4, int& k,
                                       int& i, Batch& b) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    b.ent[u] = -1;
    b.run[u] = k;
    b.last[u] = false;
    if (k < n_runs) {
      b.ent[u] = i++;
      if (i == s.run_e[k]) {
        b.last[u] = true;
        k += groups;
        if (k < n_runs) i = s.run_s[k];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    b.v[u] = b.ent[u] < 0
                 ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : __ldg(table4 + static_cast<size_t>(s.id[b.ent[u]]) * d4 +
                         c4);
}

// Adds a batch in order; a run's row leaves when its last entry is added.
__device__ __forceinline__ void add(float4* __restrict__ out4,
                                    const RowsWarp& s, int d4, int c4,
                                    const Batch& b, float4& acc,
                                    bool stream) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (b.ent[u] < 0) break;
    const float wt = s.w[b.ent[u]];
    acc.x = fmaf(wt, b.v[u].x, acc.x);
    acc.y = fmaf(wt, b.v[u].y, acc.y);
    acc.z = fmaf(wt, b.v[u].z, acc.z);
    acc.w = fmaf(wt, b.v[u].w, acc.w);
    if (b.last[u]) {
      put(out4 + static_cast<size_t>(s.bag[b.run[u]]) * d4 + c4, acc, stream);
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// A window's complete runs: groups of C lanes, one run each at a time.  The
// first batch's gathers are in flight while the warp writes the zero rows
// before each run (16-byte stores, unless `gaps` is false: out was zeroed
// first); rows [done, last run's bag] leave.
__device__ void rows_runs(const float4* __restrict__ table4,
                          float* __restrict__ out, const RowsWarp& s,
                          int n_runs, int d, bool gaps, int& done,
                          int lane, bool stream) {
  const int d4 = d >> 2;
  const int C = min(32, d4), groups = 32 / C, g = lane / C;
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  int k = g, i = g < n_runs ? s.run_s[g] : 0;
  Batch b;
  if (g < groups) gather(table4, s, n_runs, groups, d4, lane % C, k, i, b);
  for (int r = 0; r < n_runs && gaps; ++r) {
    const int bag = s.bag[r];
    if (bag > done)
      store_span(out + static_cast<size_t>(done) * d, nullptr,
                 static_cast<long long>(bag - done) * d, lane, stream);
    done = bag + 1;
  }
  if (g >= groups) return;
  for (int c4 = lane % C; c4 < d4; c4 += C) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c4 != lane % C) {                         // the next columns
      k = g;
      i = g < n_runs ? s.run_s[g] : 0;
      gather(table4, s, n_runs, groups, d4, c4, k, i, b);
    }
    add(out4, s, d4, c4, b, acc, stream);
    while (k < n_runs) {
      gather(table4, s, n_runs, groups, d4, c4, k, i, b);
      add(out4, s, d4, c4, b, acc, stream);
    }
  }
}

// A run longer than the window, entries [e0, e1) of bag b: group g sums
// entries e0 + g, e0 + g + groups, ...; the groups' partials meet in shared
// memory and are added in group order.
__device__ void rows_long_run(const float4* __restrict__ table4,
                              const int32_t* __restrict__ ids,
                              const float* __restrict__ weights,
                              float4* __restrict__ out4, RowsWarp& s, int b,
                              int e0, int e1, int d4, int lane, bool stream) {
  const int C = min(32, d4), groups = 32 / C, g = lane / C;
  for (int base = 0; base < d4; base += C) {
    const int c4 = base + lane % C;
    if (g < groups && c4 < d4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const long long step = static_cast<long long>(groups) * kAhead;
      for (long long i = e0 + g; i < e1; i += step) {
        int id[kAhead];
        float wt[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long e = i + static_cast<long long>(groups) * u;
          id[u] = e < e1 ? __ldg(ids + e) : -1;
          wt[u] = e < e1 ? __ldg(weights + e) : 0.f;
        }
        float4 v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          v[u] = id[u] < 0
                     ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : __ldg(table4 + static_cast<size_t>(id[u]) * d4 + c4);
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (id[u] < 0) break;
          acc.x = fmaf(wt[u], v[u].x, acc.x);
          acc.y = fmaf(wt[u], v[u].y, acc.y);
          acc.z = fmaf(wt[u], v[u].z, acc.z);
          acc.w = fmaf(wt[u], v[u].w, acc.w);
        }
      }
      s.part[lane] = acc;
    }
    __syncwarp();
    if (lane < C && base + lane < d4) {
      float4 r = s.part[lane];
      for (int h = 1; h < groups; ++h) {
        const float4 p = s.part[h * C + lane];
        r.x += p.x;
        r.y += p.y;
        r.z += p.z;
        r.w += p.w;
      }
      put(out4 + static_cast<size_t>(b) * d4 + base + lane, r, stream);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_rows(const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ bags,
                   const float* __restrict__ weights,
                   const float* __restrict__ table, float* __restrict__ out,
                   int n_entries, int num_bags, int d, Plan plan) {
  __shared__ RowsWarp smem[kWarps];
  const int lane = threadIdx.x & 31;
  int r0, r1;
  if (!warp_rows(plan, num_bags, r0, r1)) return;   // the whole warp
  RowsWarp& s = smem[threadIdx.x >> 5];
  const int2 range = entry_range(bags, n_entries, r0, r1, lane);
  const int p1 = range.y;
  const int d4 = d >> 2;
  const float4* __restrict__ table4 = reinterpret_cast<const float4*>(table);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  const bool stream = plan.stream;
  int done = r0;                  // rows [r0, done) are written
  int pos = range.x;
  const bool gaps = !plan.zero_pass;
  Entry cur = load_entry(bags, ids, weights, pos, p1, lane);
  while (pos < p1) {
    const int below = __shfl_down_sync(kFull, cur.bag, 1);
    const int after = lane == 31 ? cur.after : below;
    const bool end = cur.bag != INT_MAX && after != cur.bag;
    const unsigned ends = __ballot_sync(kFull, end);
    if (ends == 0) {
      // one run fills the window and goes on past it
      const int b = __shfl_sync(kFull, cur.bag, 0);
      const int e1 = lower_bound_from(bags, pos + 32, p1, b + 1, lane);
      if (gaps)
        store_span(out + static_cast<size_t>(done) * d, nullptr,
                 static_cast<long long>(b - done) * d, lane, stream);
      rows_long_run(table4, ids, weights, out4, s, b, pos, e1, d4, lane,
                    stream);
      done = b + 1;
      pos = e1;
      cur = load_entry(bags, ids, weights, pos, p1, lane);
      continue;
    }
    // the window's complete runs: entries [pos, pos + m)
    const int m = 32 - __clz(ends), n_runs = __popc(ends);
    if (lane < m) {
      s.id[lane] = cur.id;
      s.w[lane] = cur.w;
    }
    if (end) {
      const unsigned before = ends & ((1u << lane) - 1);
      const int k = __popc(before);
      s.run_s[k] = before ? 32 - __clz(before) : 0;
      s.run_e[k] = lane + 1;
      s.bag[k] = cur.bag;
    }
    __syncwarp();
    pos += m;
    cur = load_entry(bags, ids, weights, pos, p1, lane);     // the next one
    rows_runs(table4, out, s, n_runs, d, gaps, done, lane, stream);
    __syncwarp();
  }
  if (gaps)
    store_span(out + static_cast<size_t>(done) * d, nullptr,
               static_cast<long long>(r1 - done) * d, lane, stream);
}

// The zero pass of a sparse output: 16-byte streaming stores, nothing read.
__global__ void __launch_bounds__(kThreads)
embedding_bag_zero(float4* __restrict__ out, long long n4) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads)
    __stcs(out + i, make_float4(0.f, 0.f, 0.f, 0.f));
}

// The launch shape: the mapping; rows split evenly over the warps the card
// holds at once (a multiple of 4 a warp, so that the lanes mapping's tiles
// start 16-byte aligned at any d); and, for the rows mapping of a sparse
// output (at least kSparse bags an entry, as in a backward), a zero pass
// first: streaming zeros alone, then the rows with entries, beat one pass
// that mixes the two.
cudaError_t make_plan(int n_entries, int num_bags, int d, const void* table,
                      const void* out, Plan* p) {
  p->rows = d % 4 == 0 &&
            ((reinterpret_cast<uintptr_t>(table) |
              reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  static int sms = 0, resident[2] = {0, 0};  // warps the card holds at once
  if (!resident[p->rows]) {
    int dev = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, p->rows ? embedding_bag_rows : embedding_bag_lanes,
          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident[p->rows] = sms * per_sm * kWarps;
  }
  p->width = d < kTile ? d : kTile;
  p->tile_rows = kTile / p->width;
  if (p->tile_rows >= 4) p->tile_rows &= ~3;
  const int res = resident[p->rows];
  long long per = (static_cast<long long>(num_bags) + res - 1) / res;
  per = (per + 3) & ~3LL;
  p->rows_per_warp = static_cast<int>(per);
  p->warps = static_cast<int>((num_bags + per - 1) / per);
  p->stream = static_cast<long long>(num_bags) * d * 4 > kL2Bytes;
  p->zero_pass = p->rows && static_cast<long long>(n_entries) * kSparse <=
                                num_bags;
  p->zero_blocks = 8 * sms;
  return cudaSuccess;
}

}  // namespace
// Plain C entry points for ctypes.  Pointers are device pointers: ids (L)
// int32, each a row of table; bags (L) int32, non-decreasing, each in
// [0, num_bags); weights (L) fp32; table (V, d) fp32; out (num_bags, d)
// fp32, every row written.  Launches on `stream`, does not synchronise, and
// returns the first CUDA error (0 on success).
extern "C" int embedding_bag(const int32_t* ids, const int32_t* bags,
                             const float* weights, const float* table,
                             float* out, int n_entries, int num_bags, int d,
                             void* stream) {
  if (num_bags <= 0 || d <= 0) return 0;
  Plan p;
  cudaError_t err = make_plan(n_entries, num_bags, d, table, out, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.warps + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.zero_pass)
    embedding_bag_zero<<<p.zero_blocks, kThreads, 0, s>>>(
        reinterpret_cast<float4*>(out),
        static_cast<long long>(num_bags) * d / 4);
  const auto kernel = p.rows ? embedding_bag_rows : embedding_bag_lanes;
  kernel<<<blocks, kThreads, 0, s>>>(ids, bags, weights, table, out,
                                     n_entries, num_bags, d, p);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape embedding_bag takes for these operands: plan[0] the
// mapping (1 rows, 0 lanes), then rows per warp, warps, tile rows, tile
// width, streaming stores and the zero pass (1 or 0 each).
extern "C" int embedding_bag_plan(int n_entries, int num_bags, int d,
                                  const void* table, const void* out,
                                  long long* plan) {
  Plan p = {};
  if (num_bags > 0 && d > 0) {
    cudaError_t err = make_plan(n_entries, num_bags, d, table, out, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int fields[7] = {p.rows,  p.rows_per_warp, p.warps,    p.tile_rows,
                         p.width, p.stream,        p.zero_pass};
  for (int i = 0; i < 7; ++i) plan[i] = fields[i];
  return 0;
}
