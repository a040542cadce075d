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
// Design: one block of 128 threads per (row b, kv head), the TPU grid's
// (B, key tiles) with the key loop inside the block.  The block walks only
// the keys [lo, hi) that pos and the window reach, kChunk at a time; keys
// outside are never read, as the TPU kernel's pl.when(live) skips dead
// tiles.  K and V chunks are staged in shared memory in their own dtype by
// 16-byte cp.async copies (a row of D = 80 bf16 is ten of them), double
// buffered so the next chunk's loads are in flight while this one is used:
// PR 12's paged decode kernel was latency-bound on dependent 2-byte loads.
// Each staged chunk serves the whole GQA group: scores for (query head,
// key) pairs are split over groups of lanes and reduced by shuffles, one
// warp per query head runs the online softmax in f32, and the f32
// accumulator lives in shared memory.  The grid is B * Hkv blocks (256 at
// zamba2's shape, 32 at gemma3's local layers); split-K over the cache is
// the known next step for the small grids.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
      cp_async16(kd + j * D + e, kb + g);
      cp_async16(vd + j * D + e, vb + g);
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

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* out, int B,
                     int S, int Hq, int Hkv, int pos, int window, float sm_scale,
                     cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st);
    case 80: return launch<T, 80>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Hq, Hkv, pos, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, caches and out alike).  Caches
// contiguous (B, S, Hkv, D), 16-byte aligned.  Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for an unsupported dtype, head dim
// or a group too large for shared memory.
extern "C" int dense_decode_attention(int dtype, const void* q, const void* k_cache,
                                      const void* v_cache, void* out, int B, int S, int Hq,
                                      int Hkv, int D, int pos, int window, float sm_scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        dispatch<float>(D, q, k_cache, v_cache, out, B, S, Hq, Hkv, pos, window, sm_scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(D, q, k_cache, v_cache, out, B, S, Hq, Hkv,
                                                    pos, window, sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
