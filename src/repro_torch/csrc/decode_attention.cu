// Flash-decode attention for Hopper (sm_90a), fp32 or bf16 in, fp32 math
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
// S block to the next.  Hopper has no sequential grid axis, and B x KV is
// small on the decode path (64 (b, kv-head) pairs at decode_32k with B = 8,
// 8 at long_500k) against 132 SMs, so the S axis is split instead:
//
//   pass 1 (decode_split_kernel): CTA (chunk c, kv head, b) walks its chunk
//     of S in tiles of T positions, double-buffered: cp.async copies tile
//     t + 1's K and V rows into shared memory (16 bytes a copy; 8, 4 or 2
//     where d or the pointers do not allow 16) while tile t is computed
//     on; 128 / T threads per row compute its scores for 4 heads at a
//     time (16-byte shared reads of K, q broadcast, 4 independent FMA
//     chains), one warp per head folds the tile into that head's (m, l)
//     with the guards of the Pallas kernel (an all-masked block keeps
//     m = -inf, no NaN), and a thread per (4 heads, column) folds p V into
//     acc, each V element read once for the 4 heads.  With one chunk it
//     writes the output; otherwise fp32 partials (m, l, acc).
//   pass 2 (decode_merge_kernel): one CTA per (b, h) merges the valid
//     chunks' partials with the log-sum-exp recurrence (the one the
//     reference runs across chips in repro/dist/attention.py).
//
// Each K and V row is read from device memory once for all G heads that
// share it (the cache is read GQA-native, never expanded).  Only positions
// below cache_len are read: chunks and tiles wholly past it are skipped.
//
// What bounds it on an H100: bytes.  K and V are read once: at
// granite-8b's decode_32k layer shape (B = 8, S = 32,768, 8 KV heads,
// d = 128, bf16) that is 1.07 GB a launch, ~0.32 ms at 3.35 TB/s; the
// operations (4 FLOP per head and cache element, G = 4) are ~4.3 GFLOP,
// ~0.064 ms even at the fp32 rate of 67 TFLOP/s.  So the design spends
// nothing on MMA: the chunk count (from S and the SM count) fills the card
// with CTAs whose copies keep bytes in flight; decode_attention_plan sizes
// the split to one wave of resident CTAs, as the occupancy calculator
// counts them for the tile's shared memory.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// pass 1 is held to 128 registers (4 CTAs an SM), so that registers never
// hold occupancy below what shared memory allows (3 CTAs at the decode
// path's shape)
constexpr int kMinBlocks = 4;
// tiles in the ring: while one is computed on, kStages - 1 are in flight
// (measured on the H100: a double buffer of 64-position tiles beats 3 or 4
// stages, whose shared memory leaves fewer CTAs per SM)
constexpr int kStages = 2;
constexpr int kHeads = 4;                 // query heads per register chunk
// positions per tile, halved (down to 16) while a CTA's shared memory would
// exceed what the device grants one block
constexpr int kTile = 64;
// chunks are at least this long: a shorter one would spend more on its
// partials and the merge than on its positions
constexpr int kMinChunk = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// 16 bytes of shared memory as fp32: 4 floats, or 8 bf16 widened (a bf16
// is the top half of an fp32)
template <typename E> struct Wide;
template <> struct Wide<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void get(const float* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};
template <> struct Wide<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void get(const __nv_bfloat16* p,
                                             float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
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
// (16 bytes bypass L1; 4 and 8 are cached) lands in shared memory without
// passing through registers, completing at the next cp.async.wait_group.
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
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
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

template <typename E, int VB>
__device__ __forceinline__ void load_tiles(const E* __restrict__ kb,
                                           const E* __restrict__ vb,
                                           int s0, int n, E* ks, E* vs,
                                           int ld, const Shapes& sh) {
  const int per_row = sh.d * static_cast<int>(sizeof(E)) / VB;
  const int row_bytes = ld * static_cast<int>(sizeof(E));
  const int total = n * per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / per_row, c = i - r * per_row;
    const long long s = s0 + r;
    char* kd = reinterpret_cast<char*>(ks) + r * row_bytes + c * VB;
    char* vd = reinterpret_cast<char*>(vs) + r * row_bytes + c * VB;
    copy_async<VB>(kd, reinterpret_cast<const char*>(kb + s * sh.k_ss)
                           + c * VB);
    copy_async<VB>(vd, reinterpret_cast<const char*>(vb + s * sh.v_ss)
                           + c * VB);
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
      load_tiles<E, VB>(kb, vb, start + t * T, min(T, end - start - t * T),
                        st, st + T * ld, ld, sh);
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
        load_tiles<E, VB>(kb, vb, start + tn * T,
                          min(T, end - start - tn * T), st, st + T * ld, ld,
                          sh);
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

template <typename E, int VB>
int launch(const void* q, const void* k, const void* v,
           const int32_t* cache_len, void* out, float* ws, const Shapes& sh,
           cudaStream_t stream) {
  const size_t smem =
      Layout(sh.d, sh.G, sizeof(E)).bytes(sh.T, sh.d, sizeof(E));
  auto kern = decode_split_kernel<E, VB>;
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
  dim3 grid(sh.n_split, sh.KV, sh.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), cache_len, static_cast<E*>(out), ws_m, ws_l,
      ws_acc, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.n_split == 1) return static_cast<int>(err);
  decode_merge_kernel<E><<<sh.B * sh.H, kThreads, 0, stream>>>(
      cache_len, ws_m, ws_l, ws_acc, static_cast<E*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
const void* split_kernel(int vec_bytes) {
  switch (vec_bytes) {
    case 16: return reinterpret_cast<const void*>(decode_split_kernel<E, 16>);
    case 8: return reinterpret_cast<const void*>(decode_split_kernel<E, 8>);
    case 4: return reinterpret_cast<const void*>(decode_split_kernel<E, 4>);
    case 2:
      if (sizeof(E) == 2)
        return reinterpret_cast<const void*>(decode_split_kernel<E, 2>);
      break;
  }
  return nullptr;
}

template <typename E>
int dispatch_vec(int vec_bytes, const void* q, const void* k, const void* v,
                 const int32_t* cache_len, void* out, float* ws,
                 const Shapes& sh, cudaStream_t stream) {
  switch (vec_bytes) {
    case 16: return launch<E, 16>(q, k, v, cache_len, out, ws, sh, stream);
    case 8: return launch<E, 8>(q, k, v, cache_len, out, ws, sh, stream);
    case 4: return launch<E, 4>(q, k, v, cache_len, out, ws, sh, stream);
    case 2:
      if (sizeof(E) == 2)
        return launch<E, 2>(q, k, v, cache_len, out, ws, sh, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The launch shape for the current device, written to plan: positions per
// tile, the chunk count, the chunk length (a multiple of the tile) and the
// workspace's length in floats.  S is split into as many chunks as one wave
// of resident pass-1 CTAs holds (a second, partial wave would leave most
// SMs idle), of at least kMinChunk positions; a short cache is one chunk,
// one pass, and needs no workspace (1 float).  dtype and vec_bytes as for
// decode_attention.  Returns the CUDA error code; plan[0] == 0 when the G
// heads of d columns do not fit one CTA's shared memory at any tile.
extern "C" int decode_attention_plan(int B, int S, int KV, int G, int d,
                                     int dtype, int vec_bytes,
                                     long long* plan) {
  plan[0] = plan[1] = plan[2] = plan[3] = 0;
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = dtype == 0 ? split_kernel<float>(vec_bytes)
                     : dtype == 1 ? split_kernel<__nv_bfloat16>(vec_bytes)
                                  : nullptr;
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  int dev = 0, limit = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout lay(d, G, esize);
  int tile = kTile;
  while (tile > 16 && lay.bytes(tile, d, esize) > static_cast<size_t>(limit))
    tile /= 2;
  const size_t smem = lay.bytes(tile, d, esize);
  if (smem > static_cast<size_t>(limit)) return 0;
  int resident = 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(B) * KV;
  long long n = (S + kMinChunk - 1) / kMinChunk;
  n = std::max(1LL, std::min(n, static_cast<long long>(sms) * resident
                                    / pairs));
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
  Shapes sh{B, S, H, KV, d, H / KV, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            chunk, n_split, tile, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_vec<float>(vec_bytes, q, k, v, cache_len, out, ws, sh,
                               st);
  if (dtype == 1)
    return dispatch_vec<__nv_bfloat16>(vec_bytes, q, k, v, cache_len, out,
                                       ws, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
