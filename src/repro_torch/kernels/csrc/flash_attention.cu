// Causal flash attention with a runtime sliding window for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel flash_attention_fwd (_fa_kernel) in
// src/repro/kernels/flash_attention/kernel.py: blockwise online-softmax
// attention over q (B, S, Hq, D) and k/v (B, S, Hkv, D), query head h reading
// kv head h / group (GQA), key j visible to query i iff j <= i and, when
// window > 0, j > i - window.  One build serves gemma3's local and global
// layers: the window is a runtime int.  The prefill path calls it once per
// layer with S a power-of-two bucket (16 .. 1024).
//
// What bounds it on the card: at the prefill shape of smollm-135m (B = 8,
// S = 512, 9/3 heads of 64, bf16) the causal half is ~2.4 GFLOP against
// ~12.6 MB of q, k, v and out, so the least time is set by the bytes
// (~3.8 us at 3.35 TB/s) with the flops close behind.  This first version
// multiplies in f32 on the CUDA cores from shared memory, so in practice it
// is bound by shared-memory loads feeding the FMAs.
//
// Design: one block of 256 threads per (query tile of 64 rows, q head, b).
// The block walks key tiles of 64 in order, from the first tile its window
// can reach to the diagonal tile, so tiles above the diagonal or wholly
// outside the window are never read.  Each key tile of kv head h / group is
// staged in shared memory as f32 (K transposed, for conflict-free reads).
// Every thread owns a 4 x 4 tile of the 64 x 64 score block and a 4 x D/16
// tile of the output, both in registers: S = Q K^T and O += P V are register
// micro-tiles fed from shared memory, and the row max / row sum of the
// online softmax reduce over the 16 lanes that share a row.  (m, l, acc) stay
// in f32; masked lanes get p = 0 explicitly, so a row whose every key in a
// tile is masked adds nothing (the TPU kernel relies on alpha = 0 to wash such
// garbage out later).  Query rows past S (a bucket smaller than the tile) are
// computed on zeros and not stored.  q, k and v are read through their batch,
// sequence and head strides, so (B, S, H, D) needs no transposed copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kPad = kBQ + 1;     // padded row of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       int S, int Hq, int Hkv, int window, float sm_scale) {
  constexpr int NJ = D / 16;                 // output columns per thread
  extern __shared__ float smem[];
  float* qsT = smem;                         // [D][kPad]   scaled Q, transposed
  float* ksT = qsT + D * kPad;               // [D][kPad]   K tile, transposed
  float* vs = ksT + D * kPad;                // [kBK][D]    V tile
  float* ps = vs + kBK * D;                  // [kBQ][kPad] probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    qsT[d * kPad + r] = s < S ? to_f32(qb[s * qss + d]) * sm_scale : 0.f;
  }

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // key tiles from the first one the window reaches to the diagonal
  const int kt_hi = min((S - 1) / kBK, (q0 + kBQ - 1) / kBK);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                         // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int s = k0 + j;
      const bool in = s < S;
      ksT[d * kPad + j] = in ? to_f32(kb[s * kss + d]) : 0.f;
      vs[j * D + d] = in ? to_f32(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qsT[d * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ksT[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q0 + r;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool valid = k_pos < S && k_pos <= q_pos &&
                           (window <= 0 || k_pos > q_pos - window);
        if (!valid) sc[i][j] = -INFINITY;    // marks a masked lane
        row_max = fmaxf(row_max, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off, 16));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        ps[r * kPad + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off, 16);
      // one value for all 16 lanes of the row, whatever order each summed in
      row_sum = __shfl_sync(0xffffffffu, row_sum, 0, 16);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                         // ps complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPad + j];
#pragma unroll
      for (int c = 0; c < NJ; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * S + s) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const long long* st, int B, int S, int Hq, int Hkv, int window,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * kPad + kBK * D + kBQ * kPad);
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      S, Hq, Hkv, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                       const long long* st, int B, int S, int Hq, int Hkv, int window,
                       float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, st, B, S, Hq, Hkv, window, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, st, B, S, Hq, Hkv, window, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, st, B, S, Hq, Hkv, window, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, st, B, S, Hq, Hkv, window, sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, st, B, S, Hq, Hkv, window, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share one).
// strides: 9 element strides, (batch, sequence, head) of q, then k, then v;
// the head dim is contiguous.  out is a contiguous (B, S, Hq, D).  D must be
// 16, 32, 64, 128 or 256.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B, int S, int Hq,
                               int Hkv, int D, int window, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_d<float>(D, q, k, v, out, strides, B, S, Hq, Hkv,
                                              window, sm_scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<__nv_bfloat16>(D, q, k, v, out, strides, B, S, Hq,
                                                      Hkv, window, sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
