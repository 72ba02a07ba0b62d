// Flash-decode attention for Hopper (sm_90a), fp32 or bf16 in
//
//   out[b, h] = softmax_s( q[b, h] . k[b, s, h / G] / sqrt(d) ) v[b, s, h / G]
//
// over the positions s < cache_len[b] (all S of them when cache_len > S; a
// row with cache_len <= 0 comes out as zeros).  G = H / KV query heads
// share each KV head (GQA); G = 1 is the reference's contract.
//
// Replaces repro/kernels/decode_attention.py::decode_attention, the Pallas
// TPU kernel: grid (B, H, S / bs) with the S axis innermost and sequential,
// carrying the online-softmax state (m, l, acc[d]) in VMEM scratch from one
// S block to the next; k @ q on bf16 operands into fp32, and p V with p
// rounded to v's dtype.  Hopper has no sequential grid axis, and B x KV is
// small on the decode path (64 (b, kv-head) pairs at decode_32k with B = 8,
// 8 at long_500k) against 132 SMs, so the S axis is split instead:
//
//   pass 1: CTA (chunk c, kv head, b) walks its chunk of S in tiles of T
//     positions through a ring of stages: cp.async copies the K and V rows
//     of the tiles ahead into shared memory (16 bytes a copy; 8, 4 or 2
//     where d or the pointers do not allow 16) while a tile is computed on,
//     one barrier a tile.  With one chunk it writes the output; otherwise
//     fp32 partials (m, l, acc).
//   pass 2 (decode_merge_kernel): one CTA per (b, h) merges the valid
//     chunks' partials with the log-sum-exp recurrence (the one the
//     reference runs across chips in repro/dist/attention.py).
//
// Pass 1 in bf16 (decode_split_mma), the decode path: both products on the
// tensor cores, mma.sync m16n8k16 bf16 -> fp32 with operands from shared
// memory by ldmatrix.  Positions lie on the MMA's M side and a CTA's query
// heads on N, 8 a tile: S^T (16 positions x 8 heads) = K q^T, q's
// fragments held in registers for the whole chunk.  The online softmax
// runs on that fragment (a head's max over the quad's rows by shuffles),
// and O^T (d x 8 heads) += V^T P^T takes the probabilities, rounded to
// bf16 as the Pallas kernel rounds them, as its B operand: each 8 x 8 half
// of the score fragment transposed in registers (movmatrix), V^T loaded by
// ldmatrix.trans.  Each warp owns 16-position slabs of a tile and its own
// (m, l, O^T) for its 8 heads in registers, so a tile needs no barrier
// beyond the ring's; the warps' states are merged once, at the chunk's
// end, by the same recurrence as pass 2, in a fixed order.  A CTA serves
// up to 32 query heads of its KV head (8 warps: 8, 4 or 2 warps an n-tile
// of 8 heads, over alternate slabs); more heads take more CTAs.
// d is zero-padded to a multiple of 16 in shared memory (K's pad columns
// zeroed once: q's are zero in registers; V's pad only feeds rows of O^T
// that are never stored), and rows past cache_len in a tile are copied as
// zeros, so masked positions add exactly nothing.
//
// Pass 1 in fp32 (decode_split_kernel) keeps CUDA-core FMA (fp32 MMA would
// be TF32): 128 / T threads per row compute its scores for 4 heads at a
// time, one warp per head folds the tile into that head's (m, l), and a
// thread per (4 heads, column) folds p V into acc, three barriers a tile.
//
// Each K and V row is read from device memory once for all G heads that
// share it (G <= 32 in bf16; the cache is read GQA-native, never
// expanded).  Only positions below cache_len are read: chunks and tiles
// wholly past it are skipped.  No atomics: a rerun is bit-identical.
//
// What bounds it on an H100: bytes.  K and V are read once: at
// granite-8b's decode_32k layer shape (B = 8, S = 32,768, 8 KV heads,
// d = 128, bf16) that is 1.07 GB a launch, ~0.32 ms at 3.35 TB/s; the
// operations (4 FLOP per head and cache element, G = 4) are ~4.3 GFLOP,
// 4.4 us at the bf16 tensor-core rate.  The CUDA-core body needed ~3,300
// warp instructions for a 64-position tile (32 KB of K and V), which an SM
// has ~1.3 us to consume at the HBM rate: it ran out of issue slots at 80%
// of HBM.  The tensor-core body needs ~10x fewer instructions per byte for
// its products, and its copies step pointers instead of dividing (and ask
// L2 for whole 256-byte rows), so what remains is keeping bytes in flight:
// one CTA of 8 warps an SM with a double buffer of 128-position tiles (136
// KB at that shape, 64 KB of K and V landing while a tile is computed
// on).  decode_attention_plan halves the tile where the device grants less
// shared memory (d = 256) and sizes the chunk count to one wave of
// resident CTAs, as the occupancy calculator counts them.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the fp32 pass 1 is held to 128 registers (4 CTAs an SM), so that
// registers never hold occupancy below what shared memory allows
constexpr int kMinBlocks = 4;
// tiles in the fp32 ring: while one is computed on, kStages - 1 are in
// flight (measured on the H100 for the CUDA-core body: a double buffer of
// 64-position tiles beat 3 or 4 stages, whose shared memory left fewer
// CTAs per SM)
constexpr int kStages = 2;
// the bf16 body: 8 warps over a double buffer of 128-position tiles (136
// KB at d = 128, one CTA an SM, 64 KB of K and V in flight while a tile is
// computed on).  On the H100 at decode_32k, rings of 3 and 4 tiles, tiles
// of 32 and 64 positions, 2 or 3 CTAs of 4 warps an SM, and 12 or 16 warps
// a CTA were each slower.
constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaStages = 2;
constexpr int kMmaMinBlocks = 1;
constexpr int kMmaTile = 128;
constexpr int kHeadsPerCta = 32;          // bf16: 4 n-tiles of 8 heads
constexpr int kHeads = 4;                 // query heads per register chunk
// positions per tile, halved (down to 16) while a CTA's shared memory would
// exceed what the device grants one block
constexpr int kTile = 64;
// chunks are at least this long: a shorter one would spend more on its
// partials and the merge than on its positions
constexpr int kMinChunk = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// 16 bytes of shared memory as fp32 (4 floats)
template <typename E> struct Wide;
template <> struct Wide<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void get(const float* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

struct Shapes {
  int B, S, H, KV, d, G;
  long long k_sb, k_ss, k_sh;   // k strides (elements) over b, s, kv head
  long long v_sb, v_ss, v_sh;
  int chunk;                    // positions per chunk (a multiple of T)
  int n_split;                  // chunks per (b, kv head)
  int T;                        // positions per tile: 16, 32, 64 or 128
  float scale;
  int hg;                       // CTAs per (b, kv head, chunk): head groups
};

// The shared-memory layout, in elements: rows of the K and V tiles are dq
// (d rounded up to a 16-byte vector) plus a pad that makes the row stride
// an odd number of 16-byte units, so the 16-byte reads of 8 neighbouring
// rows fall in distinct banks; heads are padded to a multiple of kHeads.
struct Layout {
  int dq, ld, Gp;
  __host__ __device__ Layout(int d, int G, int esize) {
    const int ve = 16 / esize;
    dq = (d + ve - 1) / ve * ve;
    ld = dq + ((dq * esize / 16) % 2 == 0 ? ve : 2 * ve);
    Gp = (G + kHeads - 1) / kHeads * kHeads;
  }
  // kStages x (K tile, V tile) (T x ld of E), then fp32 q (Gp x dq), acc
  // (Gp x d), p (T x Gp), m, l, alpha (Gp each)
  __host__ __device__ size_t bytes(int T, int d, int esize) const {
    return 2 * kStages * static_cast<size_t>(T) * ld * esize
           + (static_cast<size_t>(Gp) * dq + static_cast<size_t>(Gp) * d
              + static_cast<size_t>(T) * Gp + 3 * Gp) * sizeof(float);
  }
};

// Copy rows [s0, s0 + n) of one (b, kv head) of k and v into the tiles ks
// and vs (rows of ld elements), VB bytes a copy, asynchronously: cp.async
// (16 bytes bypass L1 and have L2 fetch the aligned 256 bytes around them,
// a bf16 row at d = 128; 4 and 8 are cached) lands in shared memory
// without passing through registers, completing at the next
// cp.async.wait_group.
// A 2-byte row (odd d in bf16, or a misaligned view) has no cp.async: it
// is copied synchronously, which the pipeline takes as an early arrival.
template <int VB>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VB == 2) {
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  } else {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (VB == 16)
      asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                   :: "r"(s), "l"(src), "n"(VB));
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The tiles' rows [0, n) by copy_async from positions s0 .. s0 + n - 1,
// and rows [n, nfill) as zeros (plain stores), so that the positions past
// cache_len in the bf16 body's last 16-row slab hold no stale values.
// Where a row's copies divide the CTA's threads (d = 64, 128, 256 at 16
// bytes), each thread keeps one column and steps its pointers over rows:
// no division in the loop, which a tile repeats 16 times a thread.
template <typename E, int VB, int NTHREADS>
__device__ __forceinline__ void load_tiles(const E* __restrict__ kb,
                                           const E* __restrict__ vb,
                                           int s0, int n, int nfill, E* ks,
                                           E* vs, int ld, const Shapes& sh) {
  using V = typename Vec<VB>::type;
  const int per_row = sh.d * static_cast<int>(sizeof(E)) / VB;
  const int row_bytes = ld * static_cast<int>(sizeof(E));
  if (NTHREADS % per_row == 0) {
    const int step = NTHREADS / per_row;
    int r = threadIdx.x / per_row;
    const int c = threadIdx.x - r * per_row;
    const char* kg = reinterpret_cast<const char*>(kb + (s0 + r) * sh.k_ss)
                     + c * VB;
    const char* vg = reinterpret_cast<const char*>(vb + (s0 + r) * sh.v_ss)
                     + c * VB;
    char* kd = reinterpret_cast<char*>(ks) + r * row_bytes + c * VB;
    char* vd = reinterpret_cast<char*>(vs) + r * row_bytes + c * VB;
    const long long kstep = step * sh.k_ss * static_cast<long long>(sizeof(E));
    const long long vstep = step * sh.v_ss * static_cast<long long>(sizeof(E));
    const int dstep = step * row_bytes;
    for (; r < n; r += step) {
      copy_async<VB>(kd, kg);
      copy_async<VB>(vd, vg);
      kg += kstep;
      vg += vstep;
      kd += dstep;
      vd += dstep;
    }
    for (; r < nfill; r += step) {
      *reinterpret_cast<V*>(kd) = V{};
      *reinterpret_cast<V*>(vd) = V{};
      kd += dstep;
      vd += dstep;
    }
    return;
  }
  for (int i = threadIdx.x; i < nfill * per_row; i += NTHREADS) {
    const int r = i / per_row, c = i - r * per_row;
    const long long s = s0 + r;
    char* kd = reinterpret_cast<char*>(ks) + r * row_bytes + c * VB;
    char* vd = reinterpret_cast<char*>(vs) + r * row_bytes + c * VB;
    if (r < n) {
      copy_async<VB>(kd, reinterpret_cast<const char*>(kb + s * sh.k_ss)
                             + c * VB);
      copy_async<VB>(vd, reinterpret_cast<const char*>(vb + s * sh.v_ss)
                             + c * VB);
    } else {
      *reinterpret_cast<V*>(kd) = V{};
      *reinterpret_cast<V*>(vd) = V{};
    }
  }
}

template <typename E, int VB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_split_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v,
                    const int32_t* __restrict__ cache_len,
                    E* __restrict__ out, float* __restrict__ ws_m,
                    float* __restrict__ ws_l, float* __restrict__ ws_acc,
                    Shapes sh) {
  constexpr int VE = Wide<E>::n;
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = sh.G, d = sh.d, T = sh.T;
  const Layout lay(d, G, sizeof(E));
  const int dq = lay.dq, ld = lay.ld, Gp = lay.Gp;
  const int len = min(max(cache_len[b], 0), sh.S);
  const int start = c * sh.chunk;
  const int end = min(start + sh.chunk, len);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);             // kStages x (K, V) tiles
  float* qs = reinterpret_cast<float*>(
      ks + 2LL * kStages * static_cast<long long>(T) * ld);
  float* acc = qs + Gp * dq;
  float* ps = acc + Gp * d;
  float* ms = ps + T * Gp;
  float* ls = ms + Gp;
  float* alphas = ls + Gp;

  if (start >= end) {
    // a chunk wholly past cache_len is never read; with one chunk the
    // output row is written here (zeros), else pass 2 skips the chunk
    if (sh.n_split == 1) {
      for (int i = threadIdx.x; i < G * d; i += kThreads)
        from_f32(0.f, out + (static_cast<long long>(b) * sh.H
                             + kvh * G) * d + i);
    }
    return;
  }

  // q in fp32, zero past d and for the padding heads; K's columns past d
  // zero (the loads write only the first d), so the score loop runs over
  // whole vectors
  const E* qb = q + (static_cast<long long>(b) * sh.H + kvh * G) * d;
  for (int i = threadIdx.x; i < Gp * dq; i += kThreads) {
    const int g = i / dq, j = i - g * dq;
    qs[i] = (g < G && j < d) ? to_f32(qb[g * d + j]) : 0.f;
  }
  for (int i = threadIdx.x; i < Gp * d; i += kThreads) acc[i] = 0.f;
  for (int g = threadIdx.x; g < Gp; g += kThreads) {
    ms[g] = -CUDART_INF_F;
    ls[g] = 0.f;
  }
  if (dq > d) {                    // every stage's K rows (and V's: unread)
    for (int i = threadIdx.x; i < 2 * kStages * T * (dq - d);
         i += kThreads) {
      const int r = i / (dq - d);
      from_f32(0.f, ks + static_cast<long long>(r) * ld + d
                        + (i - r * (dq - d)));
    }
  }
  const E* kb = k + b * sh.k_sb + kvh * sh.k_sh;
  const E* vb = v + b * sh.v_sb + kvh * sh.v_sh;
  // scores: kThreads / T threads per row, each over every tpr-th vector
  const int tpr = kThreads / T;
  const int row = threadIdx.x / tpr, sub = threadIdx.x - row * tpr;
  const int n_vec = dq / VE;
  const long long stage = 2LL * T * ld;          // elements of K + V tiles
  const int n_tiles = (end - start + T - 1) / T;

  // prologue: the first kStages - 1 tiles in flight, one group each
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      E* st = ks + t * stage;
      const int n = min(T, end - start - t * T);
      load_tiles<E, VB, kThreads>(kb, vb, start + t * T, n, n, st,
                                  st + T * ld, ld, sh);
    }
    commit_copies();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = start + t * T;
    const int n = min(T, end - t0);
    E* kt = ks + (t % kStages) * stage;
    E* vt = kt + T * ld;
    wait_copies<kStages - 2>();                  // tile t has landed
    __syncthreads();                             // ... for every thread,
    {                                            // and tile t - 1 is done
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        E* st = ks + (tn % kStages) * stage;
        const int nn = min(T, end - start - tn * T);
        load_tiles<E, VB, kThreads>(kb, vb, start + tn * T, nn, nn, st,
                                    st + T * ld, ld, sh);
      }
      commit_copies();
    }

    // scores for kHeads heads at a time: the row's K vectors once per
    // chunk of heads, q broadcast from shared memory
    const E* kr = kt + static_cast<long long>(row) * ld;
    for (int g0 = 0; g0 < Gp; g0 += kHeads) {
      float s[kHeads] = {};
      for (int vi = sub; vi < n_vec; vi += tpr) {
        float kf[VE];
        Wide<E>::get(kr + vi * VE, kf);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float* qg = qs + (g0 + h) * dq + vi * VE;
#pragma unroll
          for (int e = 0; e < VE; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qg + e);
            s[h] = fmaf(kf[e], q4.x, s[h]);
            s[h] = fmaf(kf[e + 1], q4.y, s[h]);
            s[h] = fmaf(kf[e + 2], q4.z, s[h]);
            s[h] = fmaf(kf[e + 3], q4.w, s[h]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        for (int off = tpr / 2; off > 0; off >>= 1)
          s[h] += __shfl_xor_sync(kFull, s[h], off);
      if (sub == 0) {
        float4 o;
        o.x = row < n ? s[0] * sh.scale : -CUDART_INF_F;
        o.y = row < n ? s[1] * sh.scale : -CUDART_INF_F;
        o.z = row < n ? s[2] * sh.scale : -CUDART_INF_F;
        o.w = row < n ? s[3] * sh.scale : -CUDART_INF_F;
        *reinterpret_cast<float4*>(ps + row * Gp + g0) = o;
      }
    }
    __syncthreads();

    // online softmax: one warp per head, lanes over the tile's rows
    for (int g = warp; g < Gp; g += kWarps) {
      float mt = -CUDART_INF_F;
      for (int r = lane; r < T; r += 32) mt = fmaxf(mt, ps[r * Gp + g]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int r = lane; r < T; r += 32) {
        const float sc = ps[r * Gp + g];
        const float p = (sc == -CUDART_INF_F) ? 0.f : expf(sc - m_new);
        ps[r * Gp + g] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha =
            (m_prev == -CUDART_INF_F) ? 0.f : expf(m_prev - m_new);
        alphas[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, col] = acc * alpha[g] + sum_r p[r, g] v[r, col]: a thread per
    // (chunk of kHeads heads, column), the V element read once for them
    for (int i = threadIdx.x; i < (Gp / kHeads) * d; i += kThreads) {
      const int g0 = i / d * kHeads, col = i - (i / d) * d;
      float a[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        a[h] = acc[(g0 + h) * d + col] * alphas[g0 + h];
      const E* vc = vt + col;
      const float* pr = ps + g0;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float x = to_f32(vc[static_cast<long long>(r) * ld]);
        const float4 p4 = *reinterpret_cast<const float4*>(pr + r * Gp);
        a[0] = fmaf(p4.x, x, a[0]);
        a[1] = fmaf(p4.y, x, a[1]);
        a[2] = fmaf(p4.z, x, a[2]);
        a[3] = fmaf(p4.w, x, a[3]);
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) acc[(g0 + h) * d + col] = a[h];
    }
  }
  __syncthreads();

  if (sh.n_split == 1) {
    E* ob = out + (static_cast<long long>(b) * sh.H + kvh * G) * d;
    for (int i = threadIdx.x; i < G * d; i += kThreads)
      from_f32(acc[i] / fmaxf(ls[i / d], 1e-30f), ob + i);
    return;
  }
  const long long p0 =
      ((static_cast<long long>(b) * sh.KV + kvh) * sh.n_split + c) * G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ws_m[p0 + g] = ms[g];
    ws_l[p0 + g] = ls[g];
  }
  for (int i = threadIdx.x; i < G * d; i += kThreads)
    ws_acc[p0 * d + i] = acc[i];
}

// The bf16 body's shared-memory layout, in elements: rows of the K and V
// tiles are dk (d rounded up to the MMA's 16-deep k-step) plus 8, so the
// row stride is an odd number of 16-byte units and ldmatrix's 8 row
// addresses fall in distinct banks.  After the last tile the ring holds the
// warps' states for the merge: m and l (8 heads a warp), then O (8 x dk).
struct MmaLayout {
  int dk, ld;
  __host__ __device__ explicit MmaLayout(int d) {
    dk = (d + 15) / 16 * 16;
    ld = dk + 8;
  }
  __host__ __device__ size_t bytes(int T) const {
    const size_t ring =
        static_cast<size_t>(kMmaStages) * 2 * T * ld * sizeof(__nv_bfloat16);
    const size_t merge =
        static_cast<size_t>(kMmaWarps) * 8 * (dk + 2) * sizeof(float);
    return ring > merge ? ring : merge;
  }
};

// Four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each lane the transposed
// fragment.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// an 8 x 8 b16 matrix held as an MMA fragment, transposed across the warp
__device__ __forceinline__ unsigned transpose8x8(unsigned x) {
  unsigned y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// two fp32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Pass 1 in bf16.  CTA (chunk c, kv head x head group, b); warp w serves
// n-tile nt = w / wpn (8 query heads) over the 16-position slabs s of each
// tile with s % wpn == w % wpn.  DK: the most 16-deep k-steps of d the
// instantiation holds in registers (8: d <= 128; 16: d <= 256).
template <int VB, int DK>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
decode_split_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int32_t* __restrict__ cache_len,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws_m,
                 float* __restrict__ ws_l, float* __restrict__ ws_acc,
                 Shapes sh) {
  using E = __nv_bfloat16;
  const int c = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / sh.hg;
  const int g0 = (blockIdx.y - kvh * sh.hg) * kHeadsPerCta;  // first head
  const int G = sh.G, d = sh.d, T = sh.T;
  const int Gc = min(G - g0, kHeadsPerCta);         // this CTA's heads
  const int ntc = (Gc + 7) / 8;                     // ... in n-tiles of 8
  const int wpn = kMmaWarps / ntc;                     // warps per n-tile
  const MmaLayout lay(d);
  const int dk = lay.dk, ld = lay.ld, nks = dk / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = warp / wpn, sg = warp - nt * wpn;
  const bool active = nt < ntc;                     // 3 n-tiles idle a warp
  const int len = min(max(cache_len[b], 0), sh.S);
  const int start = c * sh.chunk;
  const int end = min(start + sh.chunk, len);
  const long long head0 = static_cast<long long>(b) * sh.H + kvh * G + g0;

  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);       // kMmaStages x (K, V) tiles

  if (start >= end) {
    // a chunk wholly past cache_len is never read; with one chunk the
    // output rows are written here (zeros), else pass 2 skips the chunk
    if (sh.n_split == 1) {
      for (int i = threadIdx.x; i < Gc * d; i += kMmaThreads)
        out[head0 * d + i] = __float2bfloat16(0.f);
    }
    return;
  }

  // K's columns past d are zero in every stage (the loads write only the
  // first d; q's are zero too, so the padded k-step adds nothing)
  if (dk > d) {
    for (int i = threadIdx.x; i < kMmaStages * 2 * T * (dk - d);
         i += kMmaThreads) {
      const int r = i / (dk - d);
      ks[static_cast<long long>(r) * ld + d + (i - r * (dk - d))] =
          __float2bfloat16(0.f);
    }
  }

  // q^T's B fragments, once a chunk: lane holds head lane / 4 of its
  // n-tile, columns 2 (lane % 4) + {0, 1} (+ 8) of each k-step
  unsigned qf[DK][2];
  {
    const int h = nt * 8 + (lane >> 2);             // within this CTA
    const bool live = active && h < Gc;
    const unsigned short* qr =
        reinterpret_cast<const unsigned short*>(q) + (head0 + h) * d;
#pragma unroll
    for (int s = 0; s < DK; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = s * 16 + half * 8 + 2 * (lane & 3);
        const unsigned lo = live && col < d ? qr[col] : 0u;
        const unsigned hi = live && col + 1 < d ? qr[col + 1] : 0u;
        qf[s][half] = lo | (hi << 16);
      }
    }
  }

  // this lane's state for heads 2 (lane % 4) + {0, 1} of its n-tile: m in
  // log2 units, l as its own partial sum (the quad's rows are added once,
  // at the end), and O^T rows lane / 4 (+ 8) of each 16-row m-tile of d
  float o[DK][4];
#pragma unroll
  for (int i = 0; i < DK; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const float scale2 = sh.scale * 1.4426950408889634f;   // log2(e) / sqrt(d)

  const E* kb = k + b * sh.k_sb + kvh * sh.k_sh;
  const E* vb = v + b * sh.v_sb + kvh * sh.v_sh;
  const long long stage = 2LL * T * ld;           // elements of K + V tiles
  const int n_tiles = (end - start + T - 1) / T;
  const int slabs = T / 16;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      E* st = ks + (t % kMmaStages) * stage;
      const int n = min(T, end - start - t * T);
      load_tiles<E, VB, kMmaThreads>(kb, vb, start + t * T, n,
                                    min(T, (n + 15) / 16 * 16),
                        st, st + T * ld, ld, sh);
    }
    commit_copies();
  };
  // ldmatrix addresses: K rows (lane % 16) at column 8 (lane / 16); V^T's
  // matrices over rows 8 (lane / 16) + lane % 8 at column 8 ((lane / 8) % 2)
  const int k_off = (lane & 15) * ld + (lane >> 4) * 8;
  const int v_off = (((lane >> 4) << 3) + (lane & 7)) * ld
                    + ((lane >> 3) & 1) * 8;

  for (int t = 0; t < kMmaStages - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    const int n = min(T, end - start - t * T);
    const E* kt = ks + (t % kMmaStages) * stage;
    const E* vt = kt + T * ld;
    wait_copies<kMmaStages - 2>();               // tile t has landed
    __syncthreads();                             // ... for every thread,
    issue(t + kMmaStages - 1);                   // and tile t - 1 is done
    if (!active) continue;
    for (int j = 0; j < slabs && j * 16 < n; ++j) {
      if ((t * slabs + j) % wpn != sg) continue;
      const int p0 = j * 16;
      // S^T (16 positions x 8 heads) = K q^T
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < DK; ++s) {
        if (s < nks) {
          unsigned a[4];
          ldmatrix_x4(a, kt + p0 * ld + k_off + s * 16);
          mma_bf16(sc, a, qf[s][0], qf[s][1]);
        }
      }
      // online softmax over the slab: positions p0 + lane / 4 (+ 8), the
      // Pallas kernel's guards (an all-masked head keeps m = -inf, no NaN)
      const int pr = p0 + (lane >> 2);
      const float s0 = pr < n ? sc[0] * scale2 : -CUDART_INF_F;
      const float s1 = pr < n ? sc[1] * scale2 : -CUDART_INF_F;
      const float s2 = pr + 8 < n ? sc[2] * scale2 : -CUDART_INF_F;
      const float s3 = pr + 8 < n ? sc[3] * scale2 : -CUDART_INF_F;
      float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m2[0], mx0), mn1 = fmaxf(m2[1], mx1);
      const float a0 = m2[0] == -CUDART_INF_F ? 0.f : exp2f(m2[0] - mn0);
      const float a1 = m2[1] == -CUDART_INF_F ? 0.f : exp2f(m2[1] - mn1);
      const float p0v = s0 == -CUDART_INF_F ? 0.f : exp2f(s0 - mn0);
      const float p1v = s1 == -CUDART_INF_F ? 0.f : exp2f(s1 - mn1);
      const float p2v = s2 == -CUDART_INF_F ? 0.f : exp2f(s2 - mn0);
      const float p3v = s3 == -CUDART_INF_F ? 0.f : exp2f(s3 - mn1);
      l[0] = l[0] * a0 + (p0v + p2v);
      l[1] = l[1] * a1 + (p1v + p3v);
      m2[0] = mn0;
      m2[1] = mn1;
      // P^T as the B operand, in bf16: each 8-position half transposed
      const unsigned b0 = transpose8x8(pack_bf16(p0v, p1v));
      const unsigned b1 = transpose8x8(pack_bf16(p2v, p3v));
      // O^T (d x 8 heads) = alpha O^T + V^T P^T
#pragma unroll
      for (int mt = 0; mt < DK; ++mt) {
        if (mt < nks) {
          o[mt][0] *= a0;
          o[mt][1] *= a1;
          o[mt][2] *= a0;
          o[mt][3] *= a1;
          unsigned a[4];
          ldmatrix_x4_trans(a, vt + p0 * ld + v_off + mt * 16);
          mma_bf16(o[mt], a, b0, b1);
        }
      }
    }
  }
  wait_copies<0>();
  __syncthreads();     // the ring is free: the warps' states go through it

  float* sm_m = reinterpret_cast<float*>(smem);   // [warp][8] (log2 units)
  float* sm_l = sm_m + kMmaWarps * 8;                // [warp][8]
  float* sm_o = sm_l + kMmaWarps * 8;                // [warp][8][dk]
  if (active) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l[0] += __shfl_xor_sync(kFull, l[0], off);
      l[1] += __shfl_xor_sync(kFull, l[1], off);
    }
    const int hc = 2 * (lane & 3), dr = lane >> 2;
    if (lane < 4) {
      sm_m[warp * 8 + hc] = m2[0];
      sm_m[warp * 8 + hc + 1] = m2[1];
      sm_l[warp * 8 + hc] = l[0];
      sm_l[warp * 8 + hc + 1] = l[1];
    }
    float* ow = sm_o + warp * 8 * dk;
#pragma unroll
    for (int mt = 0; mt < DK; ++mt) {
      if (mt < nks) {
        ow[hc * dk + mt * 16 + dr] = o[mt][0];
        ow[(hc + 1) * dk + mt * 16 + dr] = o[mt][1];
        ow[hc * dk + mt * 16 + dr + 8] = o[mt][2];
        ow[(hc + 1) * dk + mt * 16 + dr + 8] = o[mt][3];
      }
    }
  }
  __syncthreads();

  // a thread per (head, column): the n-tile's warps merged in warp order
  const long long p0 =
      ((static_cast<long long>(b) * sh.KV + kvh) * sh.n_split + c) * G + g0;
  for (int i = threadIdx.x; i < Gc * d; i += kMmaThreads) {
    const int hh = i / d, col = i - hh * d;
    const int w0 = (hh >> 3) * wpn, hl = hh & 7;
    float m = -CUDART_INF_F;
    for (int w = w0; w < w0 + wpn; ++w) m = fmaxf(m, sm_m[w * 8 + hl]);
    float lsum = 0.f, acc = 0.f;
    for (int w = w0; w < w0 + wpn; ++w) {
      const float mw = sm_m[w * 8 + hl];
      if (mw == -CUDART_INF_F) continue;
      const float e = exp2f(mw - m);
      lsum += sm_l[w * 8 + hl] * e;
      acc += sm_o[(w * 8 + hl) * dk + col] * e;
    }
    if (sh.n_split == 1) {
      out[(head0 + hh) * d + col] =
          __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
    } else {
      if (col == 0) {
        ws_m[p0 + hh] = m * 0.6931471805599453f;     // natural units
        ws_l[p0 + hh] = lsum;
      }
      ws_acc[(p0 + hh) * d + col] = acc;
    }
  }
}

// Pass 2: CTA (b, h) merges the partials of b's valid chunks, threads over
// the d columns.
template <typename E>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const int32_t* __restrict__ cache_len,
                    const float* __restrict__ ws_m,
                    const float* __restrict__ ws_l,
                    const float* __restrict__ ws_acc, E* __restrict__ out,
                    Shapes sh) {
  const int b = blockIdx.x / sh.H, h = blockIdx.x - b * sh.H;
  const int kvh = h / sh.G, g = h - kvh * sh.G;
  const int len = min(max(cache_len[b], 0), sh.S);
  const int n_valid = (len + sh.chunk - 1) / sh.chunk;
  const long long base =
      (static_cast<long long>(b) * sh.KV + kvh) * sh.n_split * sh.G + g;
  float m = -CUDART_INF_F;
  for (int c = 0; c < n_valid; ++c) m = fmaxf(m, ws_m[base + c * sh.G]);
  float l = 0.f;
  for (int c = 0; c < n_valid; ++c) {
    const float mc = ws_m[base + c * sh.G];
    if (mc != -CUDART_INF_F) l += ws_l[base + c * sh.G] * expf(mc - m);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  E* ob = out + static_cast<long long>(blockIdx.x) * sh.d;
  for (int col = threadIdx.x; col < sh.d; col += kThreads) {
    float a = 0.f;
    for (int c = 0; c < n_valid; ++c) {
      const long long p = base + c * sh.G;
      const float mc = ws_m[p];
      if (mc != -CUDART_INF_F) a += ws_acc[p * sh.d + col] * expf(mc - m);
    }
    from_f32(a * inv, ob + col);
  }
}

template <int VB>
const void* mma_kernel(int d) {
  return d > 128 ? reinterpret_cast<const void*>(decode_split_mma<VB, 16>)
                 : reinterpret_cast<const void*>(decode_split_mma<VB, 8>);
}

// The pass-1 kernel: fp32 (dtype 0) by its load width, bf16 (dtype 1) by
// load width and the k-steps of d it holds; nullptr where none exists.
const void* split_kernel(int dtype, int vec_bytes, int d) {
  if (dtype == 0) {
    switch (vec_bytes) {
      case 16: return reinterpret_cast<const void*>(
          decode_split_kernel<float, 16>);
      case 8: return reinterpret_cast<const void*>(
          decode_split_kernel<float, 8>);
      case 4: return reinterpret_cast<const void*>(
          decode_split_kernel<float, 4>);
    }
    return nullptr;
  }
  if (dtype != 1 || d > 256) return nullptr;
  switch (vec_bytes) {
    case 16: return mma_kernel<16>(d);
    case 8: return mma_kernel<8>(d);
    case 4: return mma_kernel<4>(d);
    case 2: return mma_kernel<2>(d);
  }
  return nullptr;
}

// shared memory of a pass-1 CTA at tile T
size_t split_smem(int dtype, int d, int G, int T) {
  return dtype == 0 ? Layout(d, G, sizeof(float)).bytes(T, d, sizeof(float))
                    : MmaLayout(d).bytes(T);
}

int split_threads(int dtype) { return dtype == 0 ? kThreads : kMmaThreads; }

// CTAs per (b, kv head, chunk): bf16 serves kHeadsPerCta heads a CTA
int head_groups(int dtype, int G) {
  return dtype == 0 ? 1 : (G + kHeadsPerCta - 1) / kHeadsPerCta;
}

int launch(int dtype, int vec_bytes, const void* q, const void* k,
           const void* v, const int32_t* cache_len, void* out, float* ws,
           const Shapes& sh, cudaStream_t stream) {
  const void* kern = split_kernel(dtype, vec_bytes, sh.d);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split_smem(dtype, sh.d, sh.G, sh.T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long parts =
      static_cast<long long>(sh.B) * sh.KV * sh.n_split * sh.G;
  float* ws_m = ws;
  float* ws_l = ws + parts;
  float* ws_acc = ws + 2 * parts;
  const dim3 grid(sh.n_split, sh.KV * sh.hg, sh.B);
  Shapes shapes = sh;
  void* args[] = {&q, &k, &v, &cache_len, &out, &ws_m, &ws_l, &ws_acc,
                  &shapes};
  cudaError_t err = cudaLaunchKernel(kern, grid, dim3(split_threads(dtype)),
                                     args, smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || sh.n_split == 1) return static_cast<int>(err);
  if (dtype == 0)
    decode_merge_kernel<float><<<sh.B * sh.H, kThreads, 0, stream>>>(
        cache_len, ws_m, ws_l, ws_acc, static_cast<float*>(out), sh);
  else
    decode_merge_kernel<__nv_bfloat16><<<sh.B * sh.H, kThreads, 0, stream>>>(
        cache_len, ws_m, ws_l, ws_acc, static_cast<__nv_bfloat16*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch shape for the current device, written to plan: positions per
// tile, the chunk count, the chunk length (a multiple of the tile) and the
// workspace's length in floats.  S is split into as many chunks as one wave
// of resident pass-1 CTAs holds (B x KV x head groups CTAs a chunk; a
// second, partial wave would leave most SMs idle), of at least kMinChunk
// positions; a short cache is one chunk,
// one pass, and needs no workspace (1 float).  dtype and vec_bytes as for
// decode_attention.  Returns the CUDA error code; plan[0] == 0 when the G
// heads of d columns do not fit one CTA's shared memory at any tile.
extern "C" int decode_attention_plan(int B, int S, int KV, int G, int d,
                                     int dtype, int vec_bytes,
                                     long long* plan) {
  plan[0] = plan[1] = plan[2] = plan[3] = 0;
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = split_kernel(dtype, vec_bytes, d);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tile = dtype == 0 ? kTile : kMmaTile;
  while (tile > 16
         && split_smem(dtype, d, G, tile) > static_cast<size_t>(limit))
    tile /= 2;
  const size_t smem = split_smem(dtype, d, G, tile);
  if (smem > static_cast<size_t>(limit)) return 0;
  int resident = 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kern, split_threads(dtype), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(B) * KV;
  const long long ctas = pairs * head_groups(dtype, G);
  long long n = (S + kMinChunk - 1) / kMinChunk;
  n = std::max(1LL, std::min(n, static_cast<long long>(sms) * resident
                                    / ctas));
  const long long per = (S + n - 1) / n;
  const long long chunk = (per + tile - 1) / tile * tile;
  n = (S + chunk - 1) / chunk;
  plan[0] = tile;
  plan[1] = n;
  plan[2] = chunk;
  plan[3] = n > 1 ? pairs * n * G * (d + 2) : 1;
  return 0;
}

// Plain C entry point for ctypes.  Pointers are device pointers: q (B, H, d)
// and out (B, H, d) contiguous; k, v (B, S, KV, d) with unit stride on d and
// the given element strides over b, s and kv head; cache_len (B) int32; ws
// fp32 workspace of plan[3] floats (B * KV * n_split * G * (d + 2); unused
// when n_split == 1).  n_split, chunk and tile as decode_attention_plan
// gives them.  dtype: 0 fp32, 1 bf16 (q, k, v and out alike).
// vec_bytes: the load width (16, 8, 4 or, for bf16, 2); it must divide
// d * sizeof(element), every k/v stride in bytes and the k/v pointers.
// Launches on `stream`, does not synchronise, and returns the CUDA error
// code (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int32_t* cache_len, void* out,
                                float* ws, int B, int S, int H, int KV, int d,
                                int dtype, int n_split, int chunk, int tile,
                                int vec_bytes, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, float scale,
                                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || d <= 0 || S <= 0 || n_split <= 0 || chunk <= 0
      || (tile != 16 && tile != 32 && tile != 64 && tile != 128)
      || chunk % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shapes sh{B, S, H, KV, d, H / KV, k_sb, k_ss, k_sh, v_sb, v_ss,
                  v_sh, chunk, n_split, tile, scale,
                  head_groups(dtype, H / KV)};
  return launch(dtype, vec_bytes, q, k, v, cache_len, out, ws, sh,
                static_cast<cudaStream_t>(stream));
}
