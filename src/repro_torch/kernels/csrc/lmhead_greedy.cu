// Fused lm-head + greedy epilogue for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel lmhead_epilogue_fwd (_lmhead_epilogue_kernel) in
// src/repro/kernels/sampling/kernel.py: for hidden rows h (N, d) and the
// head weight w (d, V), return each row's greedy token argmax(h @ w) and its
// log-probability, without materializing the (N, V) logits in device memory.
// Ties resolve to the first maximal index, as torch.argmax / jnp.argmax do.
//
// What bounds it on the card: bytes.  The weight (56.6 MB at bf16 for
// smollm-135m) is read once per call and the product does 2 * N flops per
// weight element -- 256 at N = 128, just under the ~295 flop/byte where a
// bf16 H100 turns compute-bound; this first version multiplies in f32 on the
// CUDA cores, so at N = 128 it is compute-bound in practice.
//
// Design, two passes:
//  1. lmhead_partials_kernel: one block per (vocab tile of kTileV, row tile of
//     kTileN).  The block computes its logits tile in registers from shared-
//     memory tiles of h and w (f32 multiply-add of bf16 or f32 inputs), then
//     reduces each row of the tile to (max, sum of exp(x - max), first argmax)
//     and writes only those partials.  kTileN = 128 covers a whole serving
//     step (8 rows x 16 span positions), so w streams from memory once.
//     w is read through its strides: a tied head is embed.T, read row by row
//     of the (V, d) embedding with no transposed copy.
//  2. lmhead_fold_kernel: one warp per row folds the row's partials.  Each
//     lane walks its tiles in vocab order; lanes merge by larger value, then
//     lower index, so the result is the first maximal index of the row.
//
// Greedy epilogue over existing logits (second entry, greedy_epilogue).
// Replaces the TPU kernel greedy_epilogue_fwd (_epilogue_kernel) in
// src/repro/kernels/sampling/kernel.py: for f32 logits (B, V), each row's
// first argmax and its log-probability max - logsumexp, without writing the
// normalized (B, V) log-probs.  Bound by bytes: the logits are read once
// (1.6 MB at B = 8, V = 49152, ~0.5 us at 3.35 TB/s); at that size the two
// launches' latency dominates.  Pass 1 (logits_partials_kernel) gives each
// (row, vocab tile of kTileE) one block, which reduces its tile to the same
// (max, sum of exp(x - max), first argmax) partials pass 1 above writes;
// pass 2 is the same fold kernel.  V need not be a multiple of the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTileN = 128;     // rows per block
constexpr int kTileV = 64;      // vocab columns per block
constexpr int kTileK = 16;      // reduction depth per shared-memory stage
constexpr int kThreads = 256;   // 16 x 16; each thread owns 8 rows x 4 columns
constexpr int kRowsPerThread = kTileN / 16;
constexpr int kColsPerThread = kTileV / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lmhead_partials_kernel(const T* __restrict__ h,      // (N, d) contiguous
                       const T* __restrict__ w,      // (d, V) at strides (sd, sv)
                       long long sd, long long sv, int N, int d, int V, int n_tiles,
                       float* __restrict__ pmax,     // (N, n_tiles)
                       float* __restrict__ psum,
                       int32_t* __restrict__ pidx) {
  __shared__ float hs[kTileK][kTileN + 1];
  __shared__ float ws[kTileK][kTileV + 1];
  const int vt = blockIdx.x;
  const int v0 = vt * kTileV;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTileK) {
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int kk = i % kTileK, r = i / kTileK;     // k fastest: h rows are contiguous
      const int n = n0 + r, k = k0 + kk;
      hs[kk][r] = (n < N && k < d) ? to_f32(h[static_cast<size_t>(n) * d + k]) : 0.f;
    }
    for (int i = tid; i < kTileK * kTileV; i += kThreads) {
      // walk the tile along whichever axis of w is contiguous
      int kk, c;
      if (sd == 1) { kk = i % kTileK; c = i / kTileK; }
      else { c = i % kTileV; kk = i / kTileV; }
      const int v = v0 + c, k = k0 + kk;
      ws[kk][c] = (v < V && k < d) ? to_f32(w[k * sd + v * sv]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = hs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: per row, reduce the 64 columns held by the 16 threads of a
  // half-warp (same ty) to (max, first argmax, sum of exp(x - max))
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float best = -INFINITY;
    int best_i = INT32_MAX;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {     // ascending column order
      const int v = v0 + tx + 16 * j;
      if (v < V && acc[i][j] > best) {
        best = acc[i][j];
        best_i = v;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off, 16);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      if (v0 + tx + 16 * j < V) sum += expf(acc[i][j] - best);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
    const int n = n0 + ty + 16 * i;
    if (tx == 0 && n < N) {
      const size_t o = static_cast<size_t>(n) * n_tiles + vt;
      pmax[o] = best;
      psum[o] = sum;
      pidx[o] = best_i;
    }
  }
}

__global__ void lmhead_fold_kernel(const float* __restrict__ pmax,
                                   const float* __restrict__ psum,
                                   const int32_t* __restrict__ pidx, int N, int n_tiles,
                                   int32_t* __restrict__ tok, float* __restrict__ lp) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (n >= N) return;                // whole warps exit together
  float m = kNegInf, l = 0.f, best = kNegInf;
  int best_i = INT32_MAX;
  for (int t = lane; t < n_tiles; t += 32) {
    const size_t o = static_cast<size_t>(n) * n_tiles + t;
    const float tm = pmax[o];
    if (tm > best) {                 // strictly greater: earlier tiles win ties
      best = tm;
      best_i = pidx[o];
    }
    const float m_cur = fmaxf(m, tm);
    l = l * expf(m - m_cur) + psum[o] * expf(tm - m_cur);
    m = m_cur;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float ol = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_cur = fmaxf(m, om);
    l = l * expf(m - m_cur) + ol * expf(om - m_cur);
    m = m_cur;
  }
  if (lane == 0) {
    tok[n] = best_i;
    lp[n] = best - (m + logf(fmaxf(l, 1e-30f)));
  }
}

constexpr int kTileE = 2048;     // logits per pass-1 block of the greedy epilogue
constexpr int kEThreads = 256;
constexpr int kEPerThread = kTileE / kEThreads;

__global__ void __launch_bounds__(kEThreads)
logits_partials_kernel(const float* __restrict__ logits, long long row_stride, int V,
                       int n_tiles, float* __restrict__ pmax, float* __restrict__ psum,
                       int32_t* __restrict__ pidx) {
  __shared__ float red_v[kEThreads / 32];
  __shared__ int red_i[kEThreads / 32];
  __shared__ float red_s[kEThreads / 32];
  const int vt = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* row = logits + static_cast<size_t>(n) * row_stride;
  const int v0 = vt * kTileE;

  float x[kEPerThread];
  float best = -INFINITY;
  int best_i = INT32_MAX;
#pragma unroll
  for (int e = 0; e < kEPerThread; ++e) {      // ascending vocab order per thread
    const int v = v0 + tid + kEThreads * e;
    x[e] = v < V ? row[v] : -INFINITY;
    if (v < V && x[e] > best) {
      best = x[e];
      best_i = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  best = red_v[0];
  best_i = red_i[0];
  for (int w = 1; w < kEThreads / 32; ++w) {
    if (red_v[w] > best || (red_v[w] == best && red_i[w] < best_i)) {
      best = red_v[w];
      best_i = red_i[w];
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kEPerThread; ++e)
    if (v0 + tid + kEThreads * e < V) sum += expf(x[e] - best);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) red_s[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kEThreads / 32; ++w) total += red_s[w];
    const size_t o = static_cast<size_t>(n) * n_tiles + vt;
    pmax[o] = best;
    psum[o] = total;
    pidx[o] = best_i;
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* w, long long sd, long long sv, int N, int d,
                   int V, float* pmax, float* psum, int32_t* pidx, int32_t* tok, float* lp,
                   cudaStream_t stream) {
  const int n_tiles = (V + kTileV - 1) / kTileV;
  const dim3 grid(n_tiles, (N + kTileN - 1) / kTileN);
  lmhead_partials_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), sd, sv, N, d, V, n_tiles, pmax,
      psum, pidx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kWarpsPerBlock = 4;
  lmhead_fold_kernel<<<(N + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
                       stream>>>(pmax, psum, pidx, N, n_tiles, tok, lp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lmhead_tile_v() { return kTileV; }

// dtype codes: 0 = float32, 1 = bfloat16 (h and w share one).  The caller
// allocates the partials, each (N, ceil(V / lmhead_tile_v())).
extern "C" int lmhead_greedy(int dtype, const void* h, const void* w, long long sd,
                             long long sv, int N, int d, int V, float* pmax, float* psum,
                             int32_t* pidx, int32_t* tok, float* lp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(h, w, sd, sv, N, d, V, pmax, psum, pidx, tok, lp, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(h, w, sd, sv, N, d, V, pmax, psum, pidx, tok, lp, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int greedy_tile_v() { return kTileE; }

// Greedy epilogue over f32 logits (N, V), rows row_stride elements apart.
// The caller allocates the partials, each (N, ceil(V / greedy_tile_v())).
extern "C" int greedy_epilogue(const float* logits, long long row_stride, int N, int V,
                               float* pmax, float* psum, int32_t* pidx, int32_t* tok,
                               float* lp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + kTileE - 1) / kTileE;
  logits_partials_kernel<<<dim3(n_tiles, N), kEThreads, 0, st>>>(logits, row_stride, V,
                                                                 n_tiles, pmax, psum, pidx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kWarpsPerBlock = 4;
  lmhead_fold_kernel<<<(N + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
                       st>>>(pmax, psum, pidx, N, n_tiles, tok, lp);
  return static_cast<int>(cudaGetLastError());
}
