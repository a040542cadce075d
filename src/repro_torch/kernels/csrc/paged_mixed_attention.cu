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
// once per (row, kv head, row tile) while the work per byte is 2 * T * group
// flops -- about 96 at the serving shape (T = 16, group = 3), under the
// ~295 flop/byte a bf16 H100 needs before compute binds.
//
// Design: one block per (row b, kv head, tile of RB query rows), where a
// query row is one (t, g) pair of that kv head, so the K/V page staged in
// shared memory serves every query head of its group.  The block reads its
// own block_table entries, walks the row's pages in logical order and skips
// dead pages (the liveness test of kernel.py) without reading them: dead
// table entries may point at page 0 or anywhere.  Masked lanes get p = 0
// explicitly, so a query whose window starts past a live page does not
// accumulate exp(0) garbage.  Scores and the f32 accumulators live in
// shared memory; the first version favours being right over tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 16;

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
paged_mixed_attention_kernel(const QT* __restrict__ q,           // (B, T, Hq, D)
                             const KT* __restrict__ k_pages,     // (P, ps, Hkv, D)
                             const KT* __restrict__ v_pages,
                             const float* __restrict__ k_scale,  // (P, ps, Hkv) or null
                             const float* __restrict__ v_scale,
                             const int32_t* __restrict__ block_table,  // (B, n)
                             const int32_t* __restrict__ starts,       // (B,)
                             QT* __restrict__ out,               // (B, T, Hq, D)
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
    qs[i] = to_f32(q[((static_cast<size_t>(b) * T + t) * Hq + h) * D + d]) * sm_scale;
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
        from_f32<QT>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int32_t* tbl, const int32_t* starts, void* out,
                   int B, int T, int Hq, int Hkv, int D, int ps, int n, int window,
                   float sm_scale, cudaStream_t stream) {
  const int rows = T * (Hq / Hkv);
  const dim3 grid(B, Hkv, (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = sizeof(float) * (2 * kRowsPerBlock * D + ps * (D + 1) + ps * D +
                                       kRowsPerBlock * ps + 3 * kRowsPerBlock);
  auto kernel = paged_mixed_attention_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), ks,
      vs, tbl, starts, static_cast<QT*>(out), T, Hq, Hkv, D, ps, n, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for an
// unsupported dtype pair.
extern "C" int paged_mixed_attention(int q_dtype, int kv_dtype, const void* q,
                                     const void* k_pages, const void* v_pages,
                                     const float* k_scale, const float* v_scale,
                                     const int32_t* block_table, const int32_t* starts,
                                     void* out, int B, int T, int Hq, int Hkv, int D, int ps,
                                     int n, int window, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(QT, KT)                                                                \
  return static_cast<int>(launch<QT, KT>(q, k_pages, v_pages, k_scale, v_scale, block_table, \
                                         starts, out, B, T, Hq, Hkv, D, ps, n, window,     \
                                         sm_scale, st))
  if (q_dtype == 0 && kv_dtype == 0) REPRO_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) REPRO_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) REPRO_LAUNCH(__nv_bfloat16, int8_t);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
