// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paged_decode_attention_fwd (_paged_dec_kernel) in
// src/repro/kernels/decode_attention/kernel.py: one query per batch row
// (B, Hq, D) attends over its own pages of a (P, ps, Hkv, D) pool through
// block_table (B, n).  Key j of row b is visible iff j < lengths[b] (the
// length counts the current token) and, when window > 0,
// j >= lengths[b] - window.  GQA head h reads kv head h / group; int8 pages
// carry f32 scales (P, ps, Hkv, 1) and are dequantized after the load.  At
// lengths = starts + 1 it computes exactly what paged_mixed_attention.cu
// computes at T = 1.
//
// What bounds it on the card: bytes, and the latency of reaching them.
// Each live K/V page is read once and does 4 * group flops per byte pair
// it brings (about 6 at group = 3), far under the ~295 flop/byte where a
// bf16 H100 turns compute-bound.  At the bucketed decode shape (8 rows,
// lengths 64 .. 640, 3 kv heads of 64) the live pages are ~2 MB, under a
// microsecond at 3.35 TB/s: the call is set by how many SMs the grid keeps
// busy and by how many dependent loads each block waits on.
//
// bf16 design (q bf16; pages bf16 or int8): split-K over pages, two passes,
// with the split plan of the mixed kernel.  Pass 1 runs one block of four
// warps per (row b, kv head [x group tile], split), a split being
// pages_per_split consecutive table entries of the row (at the serving
// shape 4 pages, 16 splits, 384 blocks).  The block finds the row's live
// page range from lengths[b] as the mixed kernel does from starts[b] =
// lengths[b] - 1 at T = 1, and exits at once if its split lies outside it:
// dead table entries are never read, nor are keys before the window's
// first.  Each lane loads 16 bytes of a key's K and V straight into
// registers (8 bf16 or 16 int8 elements; neighbouring lanes on
// neighbouring addresses), a key's D spread over the next power of two of
// D / 8 (or D / 16) lanes, so a warp holds 32 / that many keys at once and
// a lane keeps several keys' loads in flight before it uses them.  The kv
// head's query heads (up to GT of them a block) stay in registers in f32,
// so each loaded key serves all of them; a key's dot product is a shuffle
// reduction over the lanes that hold its D.  CUDA-core FMAs, not tensor
// cores: at group 3 an m16 tile would be 3/16 live, and the kernel waits on
// memory, not on arithmetic.  The online softmax is f32 (exp2 of raw scores
// times sm_scale * log2(e), p = 0 on masked keys); the lanes' partial sums
// merge by shuffles, then across warps in shared memory, into the f32
// partials (m, l, acc) of split_merge.cuh, in the layout the mixed kernel's
// pass 1 writes at T = 1.  Pass 2 is that header's merge kernel, the mixed
// kernel's own, launched as a programmatic dependent of pass 1 (pdl.cuh) so
// that its launch overlaps pass 1.  Int8 pages are dequantized as the plain
// version rounds them: (x * scale) to bf16.
//
// f32 design (q f32; pages f32 or int8; exact FMA, so float32 results track
// the CPU closely): one block per (row b, kv head) walks the row's pages in
// logical order, kChunk keys at a time, and never reads a page the query
// cannot see.  Scores, probabilities, (m, l) and the accumulator live in
// shared memory; one warp per query head runs the softmax of a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "split_merge.cuh"

namespace {

using repro_mma::kNegInf;

// ---------------------------------------------------------------------------------
// f32: exact FMA
// ---------------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;        // keys staged per iteration (whole pages)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const float* __restrict__ q,        // (B, Hq, D)
                              const KT* __restrict__ k_pages,     // (P, ps, Hkv, D)
                              const KT* __restrict__ v_pages,
                              const float* __restrict__ k_scale,  // (P, ps, Hkv) or null
                              const float* __restrict__ v_scale,
                              const int32_t* __restrict__ block_table,  // (B, n)
                              const int32_t* __restrict__ lengths,      // (B,)
                              float* __restrict__ out,            // (B, Hq, D)
                              int Hq, int Hkv, int D, int ps, int n, int window,
                              float sm_scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  const int pages_per_chunk = max(1, kChunk / ps);
  const int C = pages_per_chunk * ps;         // keys per chunk
  const int DP = D + 1;                       // padded K row: no bank conflicts

  extern __shared__ float smem[];
  float* qs = smem;                  // (G, D) scaled queries
  float* acc = qs + G * D;           // (G, D)
  float* ks = acc + G * D;           // (C, D + 1)
  float* vs = ks + C * DP;           // (C, D)
  float* s = vs + C * D;             // (G, C) scores, then probabilities
  float* m = s + G * C;              // (G,) running max
  float* l = m + G;                  // (G,) running sum
  float* alpha = l + G;              // (G,) rescale of this chunk
  int* live = reinterpret_cast<int*>(alpha + G);   // (pages_per_chunk,)

  const int tid = threadIdx.x;
  const int length = lengths[b];
  const int lo = window > 0 ? length - window : 0;    // first visible key
  const int32_t* tbl = block_table + static_cast<size_t>(b) * n;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[i] = q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] * sm_scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // pages [first, last] hold every visible key
  const int first = max(lo, 0) / ps;
  const int last = min((length - 1) / ps, n - 1);
  for (int p0 = first; p0 <= last; p0 += pages_per_chunk) {
    __syncthreads();                 // the last chunk's readers are done
    for (int c = tid; c < pages_per_chunk; c += kThreads) {
      const int pi = p0 + c;
      const int k_start = pi * ps;
      live[c] = pi <= last && k_start < length && k_start + ps - 1 >= lo;
    }
    __syncthreads();
    for (int i = tid; i < C * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int c = j / ps;
      float kv = 0.f, vv = 0.f;
      if (live[c]) {                 // dead pages are never read
        const size_t page = static_cast<size_t>(tbl[p0 + c]);
        const size_t tok = (page * ps + j % ps) * Hkv + kvh;
        kv = to_f32(k_pages[tok * D + d]);
        vv = to_f32(v_pages[tok * D + d]);
        if (k_scale != nullptr) {
          kv *= k_scale[tok];
          vv *= v_scale[tok];
        }
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * C; i += kThreads) {
      const int g = i / C, j = i % C;
      const int k_pos = p0 * ps + j;
      const bool valid = live[j / ps] && k_pos < length && k_pos >= lo;
      float dot = -INFINITY;         // marks a masked lane
      if (valid) {
        dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], ks[j * DP + d], dot);
      }
      s[i] = dot;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < C; j += 32) mx = fmaxf(mx, s[g * C + j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float x = s[g * C + j];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);   // explicit p = 0
        s[g * C + j] = p;
        sum += p;
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
      for (int j = 0; j < C; ++j) o = fmaf(s[g * C + j], vs[j * D + d], o);
      acc[i] = o;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    out[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] = acc[i] / fmaxf(l[g], 1e-30f);
  }
}

template <typename KT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, const int32_t* tbl, const int32_t* lengths, void* out,
                       int B, int Hq, int Hkv, int D, int ps, int n, int window, float sm_scale,
                       cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int ppc = ps >= kChunk ? 1 : kChunk / ps;
  const int C = ppc * ps;
  const size_t smem = sizeof(float) * (2 * G * D + C * (D + 1) + C * D + G * C + 3 * G) +
                      sizeof(int) * ppc;
  auto kernel = paged_decode_attention_kernel<KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), ks,
      vs, tbl, lengths, static_cast<float*>(out), Hq, Hkv, D, ps, n, window, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// bf16: split-K over pages, 16-byte loads into registers
// ---------------------------------------------------------------------------------

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;

__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

// One lane's 16 bytes of a page row as f32: 8 bf16, or 16 int8 dequantized
// as the plain version rounds them, (x * scale) to bf16.
template <typename KV> struct Row16;
template <> struct Row16<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void to_f32(const uint4& raw, float, float (&x)[E]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <> struct Row16<int8_t> {
  static constexpr int E = 16;
  __device__ __forceinline__ static void to_f32(const uint4& raw, float scale, float (&x)[E]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float v = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff));
      x[i] = __bfloat162float(__float2bfloat16(v * scale));
    }
  }
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Pass 1.  GT query heads a block (the kv head's group, in tiles of GT);
// the lane that holds elements [c * E, (c + 1) * E) of a key holds the same
// elements of every query and of the accumulators.
template <typename KV, int D, int GT>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,    // (B, Hq, D)
                          const KV* __restrict__ k_pages,         // (P, ps, Hkv, D)
                          const KV* __restrict__ v_pages,
                          const float* __restrict__ k_scale,      // (P, ps, Hkv) or null
                          const float* __restrict__ v_scale,
                          const int32_t* __restrict__ block_table,  // (B, n)
                          const int32_t* __restrict__ lengths,      // (B,)
                          float* __restrict__ part_ml,    // (B, Hkv, n_splits, group, 2)
                          float* __restrict__ part_acc,   // (B, Hkv, n_splits, group, D)
                          int Hq, int Hkv, int ps, int n, int window, float scale_log2,
                          int pps, int n_splits, int g_tiles) {
  using Row = Row16<KV>;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int E = Row::E;              // elements of one 16-byte load
  constexpr int CH = D / E;              // lanes that hold a key's D
  constexpr int LPK = pow2_ceil(CH);     // lanes given to a key
  constexpr int KPW = 32 / LPK;          // keys a warp holds at once
  constexpr int KPB = KPW * kSplitWarps;
  constexpr int U = GT * E >= 64 ? 2 : 4;   // keys a lane holds per round
  static_assert(D % E == 0 && CH <= 32, "head dim");

  const int b = blockIdx.x;
  const int kvh = blockIdx.y / g_tiles;
  const int g0 = (blockIdx.y % g_tiles) * GT;
  const int split = blockIdx.z;
  const int group = Hq / Hkv;
  repro_pdl::release_dependents();            // the merge may launch and wait

  const int start = lengths[b] - 1;            // the query's position
  int plo, phi;
  repro_split::live_pages(start, 1, ps, n, window, plo, phi);
  const int pa = max(plo, split * pps), pe = min(phi, (split + 1) * pps);
  if (pa >= pe) return;                        // no live page in this split
  const int klo = window > 0 ? max(0, start + 1 - window) : 0;
  const int kbeg = max(pa * ps, klo), kend = min(pe * ps, start + 1);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPK, c = lane % LPK;
  const bool holds = c < CH;                   // lanes past a key's D hold zeros

  float qf[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const bool in = holds && g0 + g < group;
    const __nv_bfloat16* src = q + (static_cast<size_t>(b) * Hq + kvh * group + g0 + g) * D + c * E;
#pragma unroll
    for (int h = 0; h < E / 8; ++h) {
      float x[8];
      Row16<__nv_bfloat16>::to_f32(in ? ldg16(src + 8 * h) : make_uint4(0, 0, 0, 0), 1.f, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][8 * h + e] = x[e];
    }
  }
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const int32_t* tbl = block_table + static_cast<size_t>(b) * n;
  for (int kb = kbeg; kb < kend; kb += U * KPB) {      // uniform across the block
    int key[U];
    size_t tok[U];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = kb + u * KPB + warp * KPW + sub;
      valid[u] = key[u] < kend;                // key >= kbeg: inside the window
      tok[u] = valid[u] ? (static_cast<size_t>(tbl[key[u] / ps]) * ps + key[u] % ps) * Hkv + kvh
                        : 0;
    }
    uint4 kr[U], vr[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = valid[u] && holds;
      kr[u] = in ? ldg16(k_pages + tok[u] * D + c * E) : make_uint4(0, 0, 0, 0);
      vr[u] = in ? ldg16(v_pages + tok[u] * D + c * E) : make_uint4(0, 0, 0, 0);
      ksc[u] = vsc[u] = 1.f;
      if constexpr (INT8) {
        ksc[u] = valid[u] ? __ldg(k_scale + tok[u]) : 0.f;
        vsc[u] = valid[u] ? __ldg(v_scale + tok[u]) : 0.f;
      }
    }

    float s[GT][U];                            // raw scores, then p
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[E];
      Row::to_f32(kr[u], ksc[u], kx);
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
      Row::to_f32(vr[u], vsc[u], vx);
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

  // then the four warps' states, through shared memory
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
    const size_t base =
        (static_cast<size_t>(b * Hkv + kvh) * n_splits + split) * group + g0 + g;
    part_acc[base * D + d] = A;
    if (d == 0) {
      part_ml[2 * base] = M;
      part_ml[2 * base + 1] = L;
    }
  }
}

template <typename KV, int D, int GT>
cudaError_t launch_split(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, const int32_t* tbl, const int32_t* lengths,
                         void* out, float* part_ml, float* part_acc, int B, int Hq, int Hkv,
                         int ps, int n, int window, float sm_scale, int pps, int n_splits,
                         cudaStream_t stream) {
  const int g_tiles = (Hq / Hkv + GT - 1) / GT;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  paged_decode_split_kernel<KV, D, GT><<<dim3(B, Hkv * g_tiles, n_splits), kSplitThreads, 0,
                                         stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tbl, lengths, part_ml, part_acc, Hq, Hkv, ps, n,
      window, scale_log2, pps, n_splits, g_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // pass 2, the mixed kernel's merge: the query sits at lengths[b] - 1
  return repro_split::launch_split_merge(part_ml, part_acc, lengths, -1, out, B, 1, Hq, Hkv,
                                         D, ps, n, window, pps, n_splits, scale_log2, stream);
}

template <typename KV, int D>
cudaError_t dispatch_group(const void* q, const void* k, const void* v, const float* ks,
                           const float* vs, const int32_t* tbl, const int32_t* lengths,
                           void* out, float* part_ml, float* part_acc, int B, int Hq, int Hkv,
                           int ps, int n, int window, float sm_scale, int pps, int n_splits,
                           cudaStream_t stream) {
  // query heads a block: the group rounded up to 2, 4 or 8 (int8: at most
  // 4, its lanes hold 16 elements); a larger group takes several tiles
  const int group = Hq / Hkv;
#define REPRO_GT(GT)                                                                         \
  return launch_split<KV, D, GT>(q, k, v, ks, vs, tbl, lengths, out, part_ml, part_acc, B,  \
                                 Hq, Hkv, ps, n, window, sm_scale, pps, n_splits, stream)
  if (group <= 2) REPRO_GT(2);
  if constexpr (!std::is_same<KV, int8_t>::value) {
    if (group > 4) REPRO_GT(8);
  }
  REPRO_GT(4);
#undef REPRO_GT
}

template <typename KV>
cudaError_t dispatch_split(int D, const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int32_t* tbl,
                           const int32_t* lengths, void* out, float* part_ml, float* part_acc,
                           int B, int Hq, int Hkv, int ps, int n, int window, float sm_scale,
                           int pps, int n_splits, cudaStream_t stream) {
#define REPRO_SPLIT(DD)                                                                      \
  case DD:                                                                                   \
    return dispatch_group<KV, DD>(q, k, v, ks, vs, tbl, lengths, out, part_ml, part_acc, B, \
                                  Hq, Hkv, ps, n, window, sm_scale, pps, n_splits, stream)
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

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).  A bf16 q
// takes the split-K kernel (D 16, 32, 64, 80, 128 or 256; 16-byte aligned
// pools and q): pages_per_split and n_splits set the split, part_ml (B,
// Hkv, n_splits, group, 2) and part_acc (B, Hkv, n_splits, group, D) are
// its f32 scratch.  A f32 q takes the FMA kernel, which ignores those four.
// Returns cudaGetLastError() after the launches; cudaErrorInvalidValue for
// an unsupported dtype pair or head dim.
extern "C" int paged_decode_attention(int q_dtype, int kv_dtype, const void* q,
                                      const void* k_pages, const void* v_pages,
                                      const float* k_scale, const float* v_scale,
                                      const int32_t* block_table, const int32_t* lengths,
                                      void* out, float* part_ml, float* part_acc, int B,
                                      int Hq, int Hkv, int D, int ps, int n, int window,
                                      float sm_scale, int pages_per_split, int n_splits,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && (kv_dtype == 0 || kv_dtype == 2)) {
    auto f = kv_dtype == 0 ? launch_f32<float> : launch_f32<int8_t>;
    return static_cast<int>(f(q, k_pages, v_pages, k_scale, v_scale, block_table, lengths,
                              out, B, Hq, Hkv, D, ps, n, window, sm_scale, st));
  }
  if (q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2)) {
    auto f = kv_dtype == 1 ? dispatch_split<__nv_bfloat16> : dispatch_split<int8_t>;
    return static_cast<int>(f(D, q, k_pages, v_pages, k_scale, v_scale, block_table, lengths,
                              out, part_ml, part_acc, B, Hq, Hkv, ps, n, window, sm_scale,
                              pages_per_split, n_splits, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
