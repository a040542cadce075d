// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel paged_decode_attention_fwd (_paged_dec_kernel) in
// src/repro/kernels/decode_attention/kernel.py: one query per batch row
// (B, Hq, D) attends over its own pages of a (P, ps, Hkv, D) pool through
// block_table (B, n).  Key j of row b is visible iff j < lengths[b] (the
// length counts the current token) and, when window > 0,
// j >= lengths[b] - window.  GQA head h reads kv head h / group; int8 pages
// carry f32 scales (P, ps, Hkv, 1) and are dequantized in registers.  At
// lengths = starts + 1 it computes exactly what paged_mixed_attention.cu
// computes at T = 1.
//
// What bounds it on the card: bytes.  Each live K/V page is read once and
// does 4 * group flops per byte pair it brings (about 6 at group = 3), far
// under the ~295 flop/byte where a bf16 H100 turns compute-bound.  At the
// bucketed decode shape (8 rows, lengths 64 .. 640, 3 kv heads of 64) the
// live pages are ~2 MB, so the least time is under a microsecond; a step is
// dominated by launch latency and by how many SMs the grid fills.
//
// Design: one block per (row b, kv head).  The block walks the row's pages
// in logical order, kChunk keys (several pages) at a time, reading its own
// block_table entries.  A page whose keys the query cannot see (k_start >=
// length, or wholly before the window) is never read: dead table entries
// may point at page 0 or anywhere.  The staged keys serve all `group` query
// heads of the kv head at once.  Scores, probabilities, (m, l) and the f32
// accumulator live in shared memory; one warp per query head runs the
// softmax of a chunk, and masked lanes get p = 0 explicitly.  The grid is
// only B * Hkv blocks (24 at the serving shape, for 132 SMs): split-K over
// pages is the known next fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;        // keys staged per iteration (whole pages)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const QT* __restrict__ q,           // (B, Hq, D)
                              const KT* __restrict__ k_pages,     // (P, ps, Hkv, D)
                              const KT* __restrict__ v_pages,
                              const float* __restrict__ k_scale,  // (P, ps, Hkv) or null
                              const float* __restrict__ v_scale,
                              const int32_t* __restrict__ block_table,  // (B, n)
                              const int32_t* __restrict__ lengths,      // (B,)
                              QT* __restrict__ out,               // (B, Hq, D)
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
    qs[i] = to_f32(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]) * sm_scale;
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
    out[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] =
        from_f32<QT>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int32_t* tbl, const int32_t* lengths, void* out,
                   int B, int Hq, int Hkv, int D, int ps, int n, int window, float sm_scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int ppc = ps >= kChunk ? 1 : kChunk / ps;
  const int C = ppc * ps;
  const size_t smem = sizeof(float) * (2 * G * D + C * (D + 1) + C * D + G * C + 3 * G) +
                      sizeof(int) * ppc;
  auto kernel = paged_decode_attention_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), ks,
      vs, tbl, lengths, static_cast<QT*>(out), Hq, Hkv, D, ps, n, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for an
// unsupported dtype pair.
extern "C" int paged_decode_attention(int q_dtype, int kv_dtype, const void* q,
                                      const void* k_pages, const void* v_pages,
                                      const float* k_scale, const float* v_scale,
                                      const int32_t* block_table, const int32_t* lengths,
                                      void* out, int B, int Hq, int Hkv, int D, int ps, int n,
                                      int window, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(QT, KT)                                                                 \
  return static_cast<int>(launch<QT, KT>(q, k_pages, v_pages, k_scale, v_scale, block_table, \
                                         lengths, out, B, Hq, Hkv, D, ps, n, window,         \
                                         sm_scale, st))
  if (q_dtype == 0 && kv_dtype == 0) REPRO_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) REPRO_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) REPRO_LAUNCH(__nv_bfloat16, int8_t);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
