// Dense decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel decode_attention_fwd (_dec_kernel) in
// src/repro/kernels/decode_attention/kernel.py: one query per batch row,
// q (B, Hq, D), over a dense cache k / v (B, S, Hkv, D), every row at the
// same scalar pos.  Key j is visible iff j < pos and, when window > 0,
// j >= pos - window.  GQA head hq reads kv head hq / (Hq / Hkv); q is
// scaled by D^-0.5 in f32; the output (B, Hq, D) has q's dtype.  The
// denominator is clamped at 1e-30, so a row with no visible key (pos <= 0)
// gives zeros, as the TPU kernel's does.
//
// What bounds it on the card: bytes.  Each visible K/V row is read once and
// does 4 * group flops per pair of elements it brings (4 at zamba2's 32/32
// heads, 8 at gemma3's 8/4), far under the ~295 flop/byte where a bf16 H100
// turns compute-bound.  At B 8, S 4096, 32 heads of 80, pos 3000 the live
// K and V are 245.8 MB: 0.073 ms at 3.35 TB/s.
//
// bf16 design: split-K over the cache, two passes.  A dense cache is a
// paged cache whose block table is the identity, so kSplitKeys consecutive
// keys count as one page and a split is pages_per_split of them, which the
// wrapper chooses from the shapes, pos and the SM count so that B * Hkv *
// live splits covers the 132 SMs many times (3072 blocks at zamba2's
// shape, 544 at gemma3's local layers, where one block a (row, kv head)
// gave 256 and 32).  Pass 1 runs one block of four warps per (row b, kv
// head [x group tile], live split) and streams the split's visible keys
// with 16-byte loads straight into registers, as paged_decode_attention.cu
// does: a key's D spread over the next power of two of D / 8 lanes, the
// next round's keys loaded before this round's are used, the group's
// queries in f32 registers so each key serves all of them (a one-head tile
// for zamba2's group of 1), dot products by shuffles, the online softmax in
// f32 with exp2.  Only the splits that hold a visible key are launched.  It
// writes f32 partials (m, l, acc) in the layout of split_merge.cuh at T = 1;
// pass 2 is that header's merge kernel, shared with the paged kernels,
// launched as a programmatic dependent (pdl.cuh) with the row's first query
// at pos - 1 for every row, so its live-page test gives exactly the dense
// span [max(pos - window, 0), pos).  Pass 1 reads at about the rate of a
// plain read kernel with the same mapping; a merge folded into each (row,
// kv head)'s last block measured slower (tools/dense_decode_variants.py
// times pass 1 alone and those read kernels).

// f32 design (exact FMA, so float32 results track the CPU closely): one
// block of 128 threads per (row b, kv head) walks only the keys [lo, hi)
// that pos and the window reach, kChunk at a time.  K and V chunks are
// staged in shared memory by 16-byte cp.async copies, double buffered;
// scores for (query head, key) pairs are split over groups of lanes and
// reduced by shuffles, one warp per query head runs the online softmax in
// f32, and the f32 accumulator lives in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "split_merge.cuh"

namespace {

using repro_mma::kNegInf;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

using repro_mma::cp_async16;
using repro_mma::cp_async_commit;
using repro_mma::cp_async_wait;

// Keys staged per chunk: C * D elements of K (and of V) per stage.
__host__ __device__ constexpr int chunk_keys(int D) { return D <= 128 ? 64 : 32; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dense_decode_attention_kernel(const T* __restrict__ q,   // (B, Hq, D)
                              const T* __restrict__ k,   // (B, S, Hkv, D)
                              const T* __restrict__ v,
                              T* __restrict__ out,       // (B, Hq, D)
                              int S, int Hq, int Hkv, int pos, int window,
                              float sm_scale, int tpp) {
  constexpr int C = chunk_keys(D);
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr int NV = D / VEC;              // copies per key row
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // (2, C, D) staged keys
  T* vs = ks + 2 * C * D;                  // (2, C, D) staged values
  float* qs = reinterpret_cast<float*>(vs + 2 * C * D);   // (G, D) scaled queries
  float* acc = qs + G * D;                 // (G, D)
  float* s = acc + G * D;                  // (G, C) scores, then probabilities
  float* m = s + G * C;                    // (G,) running max
  float* l = m + G;                        // (G,) running sum
  float* alpha = l + G;                    // (G,) rescale of this chunk

  const int hi = min(pos, S);                              // visible keys [lo, hi)
  const int lo = window > 0 ? max(pos - window, 0) : 0;
  const int n_keys = max(hi - lo, 0);
  const int n_chunks = (n_keys + C - 1) / C;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * Hkv + kvh) * D;

  auto stage = [&](int c, int buf) {       // chunk c's live rows -> buffer buf
    const int k0 = lo + c * C;
    const int nk = min(C, hi - k0);
    T* kd = ks + buf * C * D;
    T* vd = vs + buf * C * D;
    for (int i = tid; i < nk * NV; i += kThreads) {
      const int j = i / NV, e = (i % NV) * VEC;
      const size_t g = static_cast<size_t>(k0 + j) * row_stride + e;
      cp_async16(kd + j * D + e, kb + g, true);
      cp_async16(vd + j * D + e, vb + g, true);
    }
    cp_async_commit();
  };

  if (n_chunks > 0) stage(0, 0);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[i] = to_f32(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int lane_sub = tid % tpp;          // this thread's slice of a dot product
  const int per_pass = kThreads / tpp;     // (query head, key) pairs per pass
  const int warp = tid / 32, lane = tid % 32;
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      stage(c + 1, buf ^ 1);               // in flight while chunk c is used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // chunk c visible to every thread
    const int nk = min(C, hi - (lo + c * C));
    const T* kc = ks + buf * C * D;
    const T* vc = vs + buf * C * D;

    // scores: pair (g, j) = q_g . k_j, summed by tpp lanes over strided d
    for (int base = 0; base < G * C; base += per_pass) {
      const int pi = base + tid / tpp;
      const int g = pi / C, j = pi % C;
      const bool live = pi < G * C && j < nk;
      float dot = 0.f;
      if (live) {
#pragma unroll 4
        for (int d = lane_sub; d < D; d += tpp) dot = fmaf(qs[g * D + d], to_f32(kc[j * D + d]), dot);
      }
      for (int off = tpp / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (pi < G * C && lane_sub == 0) s[pi] = live ? dot : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp per query head; masked lanes get p = 0
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < C; j += 32) mx = fmaxf(mx, s[g * C + j]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float x = s[g * C + j];
        const float pj = x == -INFINITY ? 0.f : expf(x - m_new);
        s[g * C + j] = pj;
        sum += pj;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float o = acc[i] * alpha[g];
      const float* pg = s + g * C;
      for (int j = 0; j < nk; ++j) o = fmaf(pg[j], to_f32(vc[j * D + d]), o);
      acc[i] = o;
    }
    __syncthreads();                       // buffer buf free for chunk c + 2
  }
  __syncthreads();                         // l written by other threads (pos <= 0 too)

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    out[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] =
        from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int Hq, int Hkv, int pos, int window, float sm_scale, cudaStream_t stream) {
  constexpr int C = chunk_keys(D);
  const int G = Hq / Hkv;
  int tpp = 32;                            // lanes per dot product: fill the block
  while (tpp > 1 && G * C * tpp > 2 * kThreads) tpp >>= 1;
  const size_t smem = sizeof(T) * 4 * C * D + sizeof(float) * (2 * G * D + G * C + 3 * G);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = dense_decode_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Hq, Hkv, pos, window, sm_scale, tpp);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v, void* out, int B,
                         int S, int Hq, int Hkv, int pos, int window, float sm_scale,
                         cudaStream_t st) {
#define REPRO_F32(DD) \
  case DD: return launch<float, DD>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st)
  switch (D) {
    REPRO_F32(16);
    REPRO_F32(32);
    REPRO_F32(64);
    REPRO_F32(80);
    REPRO_F32(128);
    REPRO_F32(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_F32
}

// ---------------------------------------------------------------------------------
// bf16: split-K over the cache, 16-byte loads into registers
// ---------------------------------------------------------------------------------

constexpr int kSplitKeys = 64;    // keys of one "page" of the split plan
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;

__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Pass 1.  One block of four warps per (row b, kv head, tile of GT of its
// query heads, live split); blockIdx.z counts the live splits from the
// first, split0.  A warp holds KPW keys at once, a key's D spread over LPK
// lanes: the lane that holds elements [c * 8, c * 8 + 8) of a key holds the
// same elements of the GT queries and of their accumulators.
template <int D, int GT>
__global__ void __launch_bounds__(kSplitThreads)
dense_decode_split_kernel(const __nv_bfloat16* __restrict__ q,   // (B, Hq, D)
                          const __nv_bfloat16* __restrict__ k,   // (B, S, Hkv, D)
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ part_ml,    // (B, Hkv, n_splits, group, 2)
                          float* __restrict__ part_acc,   // (B, Hkv, n_splits, group, D)
                          int S, int Hq, int Hkv, int pos, int window, float scale_log2,
                          int pps, int n_splits, int split0, int g_tiles) {
  constexpr int E = 8;                   // bf16 elements of one 16-byte load
  constexpr int CH = D / E;              // lanes that hold a key's D
  constexpr int LPK = pow2_ceil(CH);     // lanes given to a key
  constexpr int KPW = 32 / LPK;          // keys a warp holds at once
  constexpr int KPB = KPW * kSplitWarps;
  // keys a lane holds per round
  constexpr int U = GT == 1 && D <= 128 ? 8 : GT * E >= 64 ? 2 : 4;
  static_assert(D % E == 0 && CH <= 32, "head dim");

  const int b = blockIdx.x;
  const int kvh = blockIdx.y / g_tiles;
  const int g0 = (blockIdx.y % g_tiles) * GT;
  const int split = split0 + blockIdx.z;
  const int group = Hq / Hkv;
  repro_pdl::release_dependents();            // the merge may launch and wait

  // the keys of this split that the query sees: [kbeg, kend)
  const int klo = window > 0 ? max(0, pos - window) : 0;
  const int kbeg = max(split * pps * kSplitKeys, klo);
  const int kend = min(min((split + 1) * pps * kSplitKeys, pos), S);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPK, c = lane % LPK;
  const bool holds = c < CH;                   // lanes past a key's D hold zeros

  float qf[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const bool in = holds && g0 + g < group;
    const __nv_bfloat16* src = q + (static_cast<size_t>(b) * Hq + kvh * group + g0 + g) * D + c * E;
    bf16x8_to_f32(in ? ldg16(src) : make_uint4(0, 0, 0, 0), qf[g]);
  }
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row = static_cast<size_t>(Hkv) * D;   // elements between keys
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * Hkv + kvh) * D + c * E;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * Hkv + kvh) * D + c * E;
  // one round: U keys a lane, KPB keys a block each; the next round's K
  // and V are loaded into registers before this round's are used
  uint4 kn[U], vn[U];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = k0 + u * KPB + warp * KPW + sub;
      const bool in = key < kend && holds;
      kn[u] = in ? ldg16(kb + key * row) : make_uint4(0, 0, 0, 0);
      vn[u] = in ? ldg16(vb + key * row) : make_uint4(0, 0, 0, 0);
    }
  };
  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += U * KPB) {     // uniform across the block
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) valid[u] = k0 + u * KPB + warp * KPW + sub < kend;
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
    if (k0 + U * KPB < kend) load(k0 + U * KPB);

    float s[GT][U];                            // raw scores, then p
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[E];
      bf16x8_to_f32(kr[u], kx);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[g][e], kx[e], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[g][u] = dot;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) mx = fmaxf(mx, s[g][u]);
      const float alpha = repro_mma::fast_exp2((m[g] - mx) * scale_log2);
      const float neg = -mx * scale_log2;
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = valid[u] ? repro_mma::fast_exp2(fmaf(s[g][u], scale_log2, neg)) : 0.f;
        s[g][u] = p;                           // explicit p = 0 on a masked key
        l[g] += p;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[E];
      bf16x8_to_f32(vr[u], vx);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(s[g][u], vx[e], acc[g][e]);
    }
  }

  // merge the warp's KPW keys' partial states (lanes c, c + LPK, ...)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = repro_mma::fast_exp2((m[g] - mn) * scale_log2);
      const float ao = repro_mma::fast_exp2((mo - mn) * scale_log2);
      m[g] = mn;
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * ao;
    }
  }

  // then the four warps' states, through shared memory, into the partials
  __shared__ float sm_ml[kSplitWarps][GT][2];
  __shared__ __align__(16) float sm_acc[kSplitWarps][GT][D];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_ml[warp][g][0] = m[g];
        sm_ml[warp][g][1] = l[g];
      }
      if (holds) {
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(&sm_acc[warp][g][c * E + e]) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
      }
    }
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(b * Hkv + kvh) * n_splits;
  for (int i = tid; i < GT * D; i += kSplitThreads) {
    const int g = i / D, d = i % D;
    if (g0 + g >= group) break;                // i ascends: the rest are past the group
    float M = sm_ml[0][g][0];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) M = fmaxf(M, sm_ml[w][g][0]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = repro_mma::fast_exp2((sm_ml[w][g][0] - M) * scale_log2);
      L += sm_ml[w][g][1] * wt;
      A += sm_acc[w][g][d] * wt;
    }
    const size_t r = (base + split) * group + g0 + g;
    part_acc[r * D + d] = A;
    if (d == 0) {
      part_ml[2 * r] = M;
      part_ml[2 * r + 1] = L;
    }
  }
}

template <int D, int GT>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out,
                         float* part_ml, float* part_acc, int B, int S, int Hq, int Hkv,
                         int pos, int window, float sm_scale, int pps, cudaStream_t stream) {
  const int g_tiles = (Hq / Hkv + GT - 1) / GT;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  const int n = (S + kSplitKeys - 1) / kSplitKeys;
  const int n_splits = (n + pps - 1) / pps;
  // the live splits, found as the merge finds them: the query sits at pos - 1
  int plo, phi;
  repro_split::live_pages(pos - 1, 1, kSplitKeys, n, window, plo, phi);
  if (phi > plo) {
    const int s_lo = plo / pps, s_hi = (phi - 1) / pps;
    dense_decode_split_kernel<D, GT><<<dim3(B, Hkv * g_tiles, s_hi - s_lo + 1), kSplitThreads,
                                       0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), part_ml, part_acc, S, Hq, Hkv, pos, window,
        scale_log2, pps, n_splits, s_lo, g_tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // pass 2, the paged kernels' merge: every row's query at pos - 1
  return repro_split::launch_split_merge(part_ml, part_acc, nullptr, pos - 1, out, B, 1, Hq,
                                         Hkv, D, kSplitKeys, n, window, pps, n_splits,
                                         scale_log2, stream);
}

template <int D>
cudaError_t dispatch_group(const void* q, const void* k, const void* v, void* out,
                           float* part_ml, float* part_acc, int B, int S, int Hq, int Hkv,
                           int pos, int window, float sm_scale, int pps,
                           cudaStream_t stream) {
  // query heads a block: the group rounded up to 1, 2, 4 or 8; a larger
  // group takes several tiles
  const int group = Hq / Hkv;
#define REPRO_GT(GT)                                                                        \
  return launch_split<D, GT>(q, k, v, out, part_ml, part_acc, B, S, Hq, Hkv, pos, window,  \
                             sm_scale, pps, stream)
  if (group <= 1) REPRO_GT(1);
  if (group <= 2) REPRO_GT(2);
  if (group <= 4) REPRO_GT(4);
  REPRO_GT(8);
#undef REPRO_GT
}

cudaError_t dispatch_split(int D, const void* q, const void* k, const void* v, void* out,
                           float* part_ml, float* part_acc, int B, int S, int Hq, int Hkv,
                           int pos, int window, float sm_scale, int pps,
                           cudaStream_t stream) {
#define REPRO_SPLIT(DD)                                                                    \
  case DD:                                                                                 \
    return dispatch_group<DD>(q, k, v, out, part_ml, part_acc, B, S, Hq, Hkv, pos, window,  \
                              sm_scale, pps, stream)
  switch (D) {
    REPRO_SPLIT(16);
    REPRO_SPLIT(32);
    REPRO_SPLIT(64);
    REPRO_SPLIT(80);
    REPRO_SPLIT(128);
    REPRO_SPLIT(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SPLIT
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, caches and out alike).  Caches
// contiguous (B, S, Hkv, D), 16-byte aligned.  A bf16 q takes the split-K
// kernel: pages_per_split sets the split (of kSplitKeys = 64 keys a page);
// part_ml (B, Hkv, n_splits, group, 2) and part_acc (B, Hkv, n_splits,
// group, D) are its f32 scratch, n_splits = ceil(ceil(S / 64) /
// pages_per_split).  A f32 q takes the FMA kernel, which ignores those
// three.  Returns cudaGetLastError() after the launches;
// cudaErrorInvalidValue for an unsupported dtype, head dim or a group too
// large for shared memory.
extern "C" int dense_decode_attention(int dtype, const void* q, const void* k_cache,
                                      const void* v_cache, void* out, float* part_ml,
                                      float* part_acc, int B, int S, int Hq, int Hkv, int D,
                                      int pos, int window, float sm_scale, int pages_per_split,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        dispatch_f32(D, q, k_cache, v_cache, out, B, S, Hq, Hkv, pos, window, sm_scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_split(D, q, k_cache, v_cache, out, part_ml, part_acc, B,
                                           S, Hq, Hkv, pos, window, sm_scale, pages_per_split,
                                           st));
  return static_cast<int>(cudaErrorInvalidValue);
}
