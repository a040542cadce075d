// Paged mixed-span attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paged_mixed_attention_fwd (_paged_mixed_kernel) in
// src/repro/kernels/decode_attention/kernel.py.  Each batch row carries T
// queries at logical positions starts[b] + t (a prefill chunk, a speculative
// verify block, or a plain decode row when T == 1) and attends over its own
// pages of a (P, ps, Hkv, D) pool through block_table (B, n): per-query
// causal, minus the sliding window (window <= 0: unlimited), GQA head
// h -> kv head h / group, online softmax in f32.  Int8 pages carry f32
// scales (P, ps, Hkv, 1) and are dequantized after the load.
//
// What bounds it on the card: bytes.  Every live K/V page of a row is read
// once per (row, kv head) while the work per byte is 2 * T * group flops --
// about 96 at the serving shape (T = 16, group = 3), under the ~295
// flop/byte a bf16 H100 needs before compute binds.  At the serving shape a
// row holds up to 64 live pages, so a block that walks a whole row is bound
// by the latency of its serial page walk, not by the 3 MB it reads.
//
// bf16 design (q bf16; pages bf16 or int8): split-K over pages, two passes.
// Pass 1 runs one block per (row b, kv head [x row tile], split), a split
// being pages_per_split consecutive pages of the row.  The block computes
// the row's live page range itself -- from the first page the window
// reaches to (start + T - 1) / ps, the liveness test of kernel.py -- and
// exits at once if its split lies outside it; dead table entries are never
// read, and neither are keys before the window's first or after the span's
// last.  The T * group query rows of the kv head (one (t, g) pair each, so
// each staged K/V page serves the whole GQA group) are the M dimension of
// m16n8k16 bf16 MMAs, one warp per 16 rows, up to 8 warps (mma_bf16.cuh):
// scores and the online softmax stay in registers and P feeds P V from
// registers.  Key tiles of 32 are gathered through block_table by 16-byte
// cp.async, double-buffered; int8 tiles land as int8 with their f32 scales
// and are dequantized to bf16 in shared memory, (k * scale) rounded to bf16
// as the plain version rounds.  Pass 1 writes f32 partials (m, l, acc) per
// query row and split to scratch the wrapper allocates.  Pass 2, one thread
// per output element, merges a row's live splits by the log-sum-exp rule
// (a split in which the row sees no key has l = 0 and m = -1e30 and adds
// nothing) and writes q's dtype.
//
// f32 design (q f32; pages f32 or int8; exact FMA, so float32 results track
// the CPU closely): one block per (row b, kv head, tile of 16 query rows)
// walks the row's pages in logical order and skips dead pages without
// reading them.  Scores and the f32 accumulators live in shared memory.
//
// Masked lanes get p = 0 explicitly in both, so a query whose window starts
// past a live page does not accumulate exp(0) garbage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using repro_mma::kNegInf;
using repro_mma::ld_bf16;
constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename KT>
__global__ void __launch_bounds__(kThreads)
paged_mixed_attention_kernel(const float* __restrict__ q,           // (B, T, Hq, D)
                             const KT* __restrict__ k_pages,     // (P, ps, Hkv, D)
                             const KT* __restrict__ v_pages,
                             const float* __restrict__ k_scale,  // (P, ps, Hkv) or null
                             const float* __restrict__ v_scale,
                             const int32_t* __restrict__ block_table,  // (B, n)
                             const int32_t* __restrict__ starts,       // (B,)
                             float* __restrict__ out,            // (B, T, Hq, D)
                             int T, int Hq, int Hkv, int D, int ps, int n,
                             int window, float sm_scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = Hq / Hkv;
  const int r0 = blockIdx.z * kRowsPerBlock;
  const int R = min(kRowsPerBlock, T * group - r0);   // query rows of this block
  const int DP = D + 1;                               // padded K row: no bank conflicts

  extern __shared__ float smem[];
  float* qs = smem;                  // (R, D) scaled queries
  float* acc = qs + kRowsPerBlock * D;
  float* ks = acc + kRowsPerBlock * D;   // (ps, D + 1)
  float* vs = ks + ps * DP;              // (ps, D)
  float* s = vs + ps * D;                // (R, ps) scores, then probabilities
  float* m = s + kRowsPerBlock * ps;     // (R,) running max
  float* l = m + kRowsPerBlock;          // (R,) running sum
  float* alpha = l + kRowsPerBlock;      // (R,) rescale of this page

  const int tid = threadIdx.x;
  const int start = starts[b];

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = (r0 + r) / group, h = kvh * group + (r0 + r) % group;
    qs[i] = q[((static_cast<size_t>(b) * T + t) * Hq + h) * D + d] * sm_scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  __syncthreads();

  for (int pi = 0; pi < n; ++pi) {
    const int k_start = pi * ps;
    // the page is live if ANY query of the row can see ANY of its keys
    bool live = k_start < start + T;
    if (window > 0) live = live && (k_start + ps - 1 >= start + 1 - window);
    if (!live) continue;             // uniform across the block
    const size_t page = static_cast<size_t>(block_table[static_cast<size_t>(b) * n + pi]);

    for (int i = tid; i < ps * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const size_t tok = (page * ps + j) * Hkv + kvh;
      float kv = to_f32(k_pages[tok * D + d]);
      float vv = to_f32(v_pages[tok * D + d]);
      if (k_scale != nullptr) {
        kv *= k_scale[tok];
        vv *= v_scale[tok];
      }
      ks[j * DP + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < R * ps; i += kThreads) {
      const int r = i / ps, j = i % ps;
      const int q_pos = start + (r0 + r) / group;
      const int k_pos = k_start + j;
      const bool valid = k_pos <= q_pos && (window <= 0 || k_pos > q_pos - window);
      float dot = -INFINITY;         // marks a masked lane
      if (valid) {
        dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * D + d], ks[j * DP + d], dot);
      }
      s[i] = dot;
    }
    __syncthreads();

    for (int r = tid; r < R; r += kThreads) {
      float m_cur = m[r];
      for (int j = 0; j < ps; ++j) m_cur = fmaxf(m_cur, s[r * ps + j]);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float x = s[r * ps + j];
        const float p = (x == -INFINITY) ? 0.f : expf(x - m_cur);   // explicit p = 0
        s[r * ps + j] = p;
        sum += p;
      }
      const float a = expf(m[r] - m_cur);
      alpha[r] = a;
      l[r] = l[r] * a + sum;
      m[r] = m_cur;
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float o = acc[i] * alpha[r];
      for (int j = 0; j < ps; ++j) o = fmaf(s[r * ps + j], vs[j * D + d], o);
      acc[i] = o;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = (r0 + r) / group, h = kvh * group + (r0 + r) % group;
    out[((static_cast<size_t>(b) * T + t) * Hq + h) * D + d] =
        acc[i] / fmaxf(l[r], 1e-30f);
  }
}

// ---------------------------------------------------------------------------------
// bf16: split-K over pages on the tensor cores
// ---------------------------------------------------------------------------------

constexpr int kKT = 32;          // keys per staged tile
constexpr int kMaxWarps = 8;     // query rows per block: up to 8 x 16
constexpr int kMergeThreads = 256;

// Pages [lo, hi) of a row that any of its T queries can see: the liveness
// test of kernel.py (k_start < start + T and, with a window, k_start + ps - 1
// >= start + 1 - window), capped at the table's n entries.
__device__ __forceinline__ void live_pages(int start, int T, int ps, int n, int window,
                                           int& lo, int& hi) {
  hi = min(n, (start + T - 1) / ps + 1);
  lo = window > 0 ? max(0, start + 1 - window) / ps : 0;
}

template <typename KV, int D>
size_t smem_split(int rows_blk) {
  constexpr int LD = ld_bf16<D>();
  if (std::is_same<KV, int8_t>::value)        // Q, one bf16 K/V tile, int8 staging, scales
    return 2 * (rows_blk + 2 * kKT) * LD + 4 * kKT * D + 4 * 4 * kKT;
  return 2 * (rows_blk + 4 * kKT) * LD;       // Q, double-buffered bf16 K/V tiles
}

template <typename KV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_mixed_split_kernel(const __nv_bfloat16* __restrict__ q,    // (B, T, Hq, D)
                         const KV* __restrict__ k_pages,         // (P, ps, Hkv, D)
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scale,      // (P, ps, Hkv) or null
                         const float* __restrict__ v_scale,
                         const int32_t* __restrict__ block_table,  // (B, n)
                         const int32_t* __restrict__ starts,       // (B,)
                         float* __restrict__ part_ml,    // (B, Hkv, splits, T * group, 2)
                         float* __restrict__ part_acc,   // (B, Hkv, splits, T * group, D)
                         int T, int Hq, int Hkv, int ps, int n, int window,
                         float scale_log2, int pps, int n_splits, int row_tiles) {
  using repro_mma::cp_async16;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int LD = ld_bf16<D>();
  constexpr int CH = D / 8;                   // 16-byte chunks of a bf16 row
  constexpr int CH8 = D / 16;                 // of an int8 row
  using Warp = repro_mma::WarpAttention<D, kKT, LD, (D <= 128)>;

  const int b = blockIdx.x;
  const int kvh = blockIdx.y / row_tiles;
  const int r0 = (blockIdx.y % row_tiles) * kMaxWarps * 16;
  const int split = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = T * group;
  const int nthr = blockDim.x;
  const int rows_blk = nthr / 2;              // 16 rows per warp
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const int start = starts[b];
  int plo, phi;
  live_pages(start, T, ps, n, window, plo, phi);
  const int pa = max(plo, split * pps), pe = min(phi, (split + 1) * pps);
  if (pa >= pe) return;                       // no live page in this split
  // keys no query of the span can see are not read either
  const int klo = window > 0 ? max(0, start + 1 - window) : 0;
  const int kbeg = max(pa * ps, klo), kend = min(pe * ps, start + T);
  const int n_tiles = (kend - kbeg + kKT - 1) / kKT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [rows_blk][LD]
  __nv_bfloat16* ks = qs + rows_blk * LD;     // bf16: [2][kKT][LD]; int8: [kKT][LD]
  __nv_bfloat16* vs = ks + (INT8 ? 1 : 2) * kKT * LD;
  int8_t* k8 = reinterpret_cast<int8_t*>(vs + (INT8 ? 1 : 2) * kKT * LD);   // [2][kKT][D]
  int8_t* v8 = k8 + 2 * kKT * D;
  float* scl = reinterpret_cast<float*>(v8 + 2 * kKT * D);   // [k, v][2][kKT]

  for (int i = tid; i < rows_blk * CH; i += nthr) {
    const int r = i / CH, c = (i % CH) * 8;
    const int rr = r0 + r;
    const bool in = rr < rows;
    const __nv_bfloat16* src =
        in ? q + ((static_cast<size_t>(b) * T + rr / group) * Hq + kvh * group + rr % group) * D + c
           : q;
    cp_async16(qs + r * LD + c, src, in);
  }

  auto token = [&](int key) {                 // (P, ps, Hkv) index of a live key
    const size_t page = static_cast<size_t>(block_table[static_cast<size_t>(b) * n + key / ps]);
    return (page * ps + key % ps) * Hkv + kvh;
  };
  auto stage = [&](int tile, int buf) {       // keys past kend zero-filled, not read
    const int k0 = kbeg + tile * kKT;
    if constexpr (INT8) {
      for (int i = tid; i < kKT * CH8; i += nthr) {
        const int j = i / CH8, c = (i % CH8) * 16;
        const bool in = k0 + j < kend;
        const size_t tok = in ? token(k0 + j) : 0;
        cp_async16(k8 + (buf * kKT + j) * D + c, k_pages + tok * D + c, in);
        cp_async16(v8 + (buf * kKT + j) * D + c, v_pages + tok * D + c, in);
      }
      for (int j = tid; j < kKT; j += nthr) {
        const bool in = k0 + j < kend;
        const size_t tok = in ? token(k0 + j) : 0;
        repro_mma::cp_async4(scl + buf * kKT + j, k_scale + tok, in);
        repro_mma::cp_async4(scl + (2 + buf) * kKT + j, v_scale + tok, in);
      }
    } else {
      for (int i = tid; i < kKT * CH; i += nthr) {
        const int j = i / CH, c = (i % CH) * 8;
        const bool in = k0 + j < kend;
        const size_t tok = in ? token(k0 + j) : 0;
        cp_async16(ks + (buf * kKT + j) * LD + c, k_pages + tok * D + c, in);
        cp_async16(vs + (buf * kKT + j) * LD + c, v_pages + tok * D + c, in);
      }
    }
  };

  stage(0, 0);
  repro_mma::cp_async_commit();               // group: Q and the first tile

  Warp wa;
  wa.init();
  const int rl = warp * 16 + lane / 4;        // this thread's rows: rl, rl + 8
  const int qp0 = start + (r0 + rl) / group;
  const int qp1 = start + (r0 + rl + 8) / group;
  const __nv_bfloat16* qw = qs + warp * 16 * LD;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, buf ^ 1);
      repro_mma::cp_async_commit();
      repro_mma::cp_async_wait<1>();          // this tile has landed, the next in flight
    } else {
      repro_mma::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + (INT8 ? 0 : buf * kKT * LD);
    const __nv_bfloat16* vt = vs + (INT8 ? 0 : buf * kKT * LD);
    if constexpr (INT8) {                     // dequantize: (x * scale) rounded to bf16
      for (int i = tid; i < kKT * (D / 4); i += nthr) {
        const int j = i / (D / 4), d = (i % (D / 4)) * 4;
        const char4 kx = *reinterpret_cast<const char4*>(k8 + (buf * kKT + j) * D + d);
        const char4 vx = *reinterpret_cast<const char4*>(v8 + (buf * kKT + j) * D + d);
        const float sk = scl[buf * kKT + j], sv = scl[(2 + buf) * kKT + j];
        __nv_bfloat162* kd = reinterpret_cast<__nv_bfloat162*>(ks + j * LD + d);
        __nv_bfloat162* vd = reinterpret_cast<__nv_bfloat162*>(vs + j * LD + d);
        kd[0] = __floats2bfloat162_rn(static_cast<float>(kx.x) * sk, static_cast<float>(kx.y) * sk);
        kd[1] = __floats2bfloat162_rn(static_cast<float>(kx.z) * sk, static_cast<float>(kx.w) * sk);
        vd[0] = __floats2bfloat162_rn(static_cast<float>(vx.x) * sv, static_cast<float>(vx.y) * sv);
        vd[1] = __floats2bfloat162_rn(static_cast<float>(vx.z) * sv, static_cast<float>(vx.w) * sv);
      }
      __syncthreads();
    }
    if (tile == 0) wa.load_q(qw, lane);

    float s[Warp::NT][4];
    wa.scores(s, qw, kt, lane);
    const int k0 = kbeg + tile * kKT;
    // no pair of this tile needs a test: every key is in the split, precedes
    // every query, and lies inside every query's window
    const bool full = k0 + kKT <= kend && k0 + kKT - 1 <= start &&
                      (window <= 0 || k0 > start + T - 1 - window);
    if (full) {
      wa.template softmax<false>(s, scale_log2, [](int, int, int) { return true; });
    } else {
      const int kc = k0 + 2 * (lane % 4);
      wa.template softmax<true>(s, scale_log2, [&](int hh, int j, int e) {
        const int qp = hh ? qp1 : qp0, kp = kc + j * 8 + e;
        return kp < kend && kp <= qp && (window <= 0 || kp > qp - window);
      });
    }
    wa.pv(s, vt, lane);
    __syncthreads();                          // the tile's buffers are free again
  }
  wa.finish();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = r0 + rl + 8 * hh;
    if (rr >= rows) continue;
    const size_t base = (static_cast<size_t>(b * Hkv + kvh) * n_splits + split) * rows + rr;
    if (lane % 4 == 0) {
      part_ml[2 * base] = wa.m[hh];
      part_ml[2 * base + 1] = wa.l[hh];
    }
    float* acc = part_acc + base * D + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < Warp::ND; ++t)
      *reinterpret_cast<float2*>(acc + t * 8) =
          make_float2(wa.o[t][2 * hh], wa.o[t][2 * hh + 1]);
  }
}

// Pass 2: out[b, t, h, d] from the row's live splits, log-sum-exp merged.
__global__ void __launch_bounds__(kMergeThreads)
paged_mixed_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         const int32_t* __restrict__ starts, __nv_bfloat16* __restrict__ out,
                         int T, int Hq, int Hkv, int D, int ps, int n, int window, int pps,
                         int n_splits, float scale_log2) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = T * group;
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= rows * D) return;
  const int rr = i / D, d = i % D;
  const int start = starts[b];
  int plo, phi;
  live_pages(start, T, ps, n, window, plo, phi);
  float M = -INFINITY, L = 0.f, A = 0.f;
  if (phi > plo) {
    const size_t base = static_cast<size_t>(b * Hkv + kvh) * n_splits;
    const int s_lo = plo / pps, s_hi = (phi - 1) / pps;
    for (int s = s_lo; s <= s_hi; ++s) M = fmaxf(M, part_ml[2 * ((base + s) * rows + rr)]);
    for (int s = s_lo; s <= s_hi; ++s) {
      const size_t r = (base + s) * rows + rr;
      // m is the split's max raw score; 0 for a split the row cannot see
      const float w = exp2f((part_ml[2 * r] - M) * scale_log2);
      L += part_ml[2 * r + 1] * w;
      A += part_acc[r * D + d] * w;
    }
  }
  const int t = rr / group, h = kvh * group + rr % group;
  out[((static_cast<size_t>(b) * T + t) * Hq + h) * D + d] =
      __float2bfloat16(A / fmaxf(L, 1e-30f));
}

template <typename KV, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, const int32_t* tbl, const int32_t* starts,
                         void* out, float* part_ml, float* part_acc, int B, int T, int Hq,
                         int Hkv, int ps, int n, int window, float sm_scale, int pps,
                         int n_splits, cudaStream_t stream) {
  const int rows = T * (Hq / Hkv);
  const int row_tiles = (rows + kMaxWarps * 16 - 1) / (kMaxWarps * 16);
  const int warps = (min(rows, kMaxWarps * 16) + 15) / 16;
  const size_t smem = smem_split<KV, D>(warps * 16);
  auto kernel = paged_mixed_split_kernel<KV, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  kernel<<<dim3(B, Hkv * row_tiles, n_splits), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tbl, starts, part_ml, part_acc, T, Hq, Hkv, ps, n,
      window, scale_log2, pps, n_splits, row_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((rows * D + kMergeThreads - 1) / kMergeThreads, Hkv, B);
  paged_mixed_merge_kernel<<<grid2, kMergeThreads, 0, stream>>>(
      part_ml, part_acc, starts, static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, D, ps, n,
      window, pps, n_splits, scale_log2);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch_split(int D, const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int32_t* tbl,
                           const int32_t* starts, void* out, float* part_ml, float* part_acc,
                           int B, int T, int Hq, int Hkv, int ps, int n, int window,
                           float sm_scale, int pps, int n_splits, cudaStream_t stream) {
#define REPRO_SPLIT(DD)                                                                     \
  case DD:                                                                                  \
    return launch_split<KV, DD>(q, k, v, ks, vs, tbl, starts, out, part_ml, part_acc, B, T, \
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

// ---------------------------------------------------------------------------------
// f32: exact FMA
// ---------------------------------------------------------------------------------

template <typename KT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, const int32_t* tbl, const int32_t* starts, void* out,
                       int B, int T, int Hq, int Hkv, int D, int ps, int n, int window,
                       float sm_scale, cudaStream_t stream) {
  const int rows = T * (Hq / Hkv);
  const dim3 grid(B, Hkv, (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = sizeof(float) * (2 * kRowsPerBlock * D + ps * (D + 1) + ps * D +
                                       kRowsPerBlock * ps + 3 * kRowsPerBlock);
  auto kernel = paged_mixed_attention_kernel<KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), ks,
      vs, tbl, starts, static_cast<float*>(out), T, Hq, Hkv, D, ps, n, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).  A bf16 q
// takes the split-K tensor-core kernels (D 16, 32, 64, 80, 128 or 256;
// 16-byte aligned pools and q): pages_per_split and n_splits set the split,
// part_ml (B, Hkv, n_splits, T * group, 2) and part_acc (B, Hkv, n_splits,
// T * group, D) are its f32 scratch.  A f32 q takes the FMA kernel, which
// ignores those four.  Returns cudaGetLastError() after the launches;
// cudaErrorInvalidValue for an unsupported dtype pair or head dim.
extern "C" int paged_mixed_attention(int q_dtype, int kv_dtype, const void* q,
                                     const void* k_pages, const void* v_pages,
                                     const float* k_scale, const float* v_scale,
                                     const int32_t* block_table, const int32_t* starts,
                                     void* out, float* part_ml, float* part_acc, int B, int T,
                                     int Hq, int Hkv, int D, int ps, int n, int window,
                                     float sm_scale, int pages_per_split, int n_splits,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && (kv_dtype == 0 || kv_dtype == 2)) {
    auto f = kv_dtype == 0 ? launch_f32<float> : launch_f32<int8_t>;
    return static_cast<int>(f(q, k_pages, v_pages, k_scale, v_scale, block_table, starts, out,
                              B, T, Hq, Hkv, D, ps, n, window, sm_scale, st));
  }
  if (q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2)) {
    auto f = kv_dtype == 1 ? dispatch_split<__nv_bfloat16> : dispatch_split<int8_t>;
    return static_cast<int>(f(D, q, k_pages, v_pages, k_scale, v_scale, block_table, starts,
                              out, part_ml, part_acc, B, T, Hq, Hkv, ps, n, window, sm_scale,
                              pages_per_split, n_splits, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
