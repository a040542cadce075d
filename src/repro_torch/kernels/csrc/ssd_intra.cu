// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ssd_intra_fwd (_ssd_kernel) in
// src/repro/kernels/ssd/kernel.py.  For each chunk c and head h of
//   xb (bc, q, h, p), acs (bc, q, h), Bh / Ch (bc, q, h, n), all float32,
// it writes y (bc, q, h, p) float32:
//   y[t] = sum_{u <= t} (C_t . B_u) * exp(acs_t - acs_u) * x[u]
// i.e. ((C B^T) .* tril(exp(acs_t - acs_u))) x.  The inputs are read
// through their strides (Bh / Ch may repeat one group over every head with
// a zero head stride); y is contiguous.
//
// What bounds it on the card: at the mamba2-1.3b prefill shape (q 256,
// n 128, p 64, 64 heads) each (chunk, head) reads 2 * 256 * 128 * 4 bytes
// of B and C and 256 * 64 * 4 of x and does ~12.6 MFLOP over the causal
// pairs: ~60 flops per byte.  That is past the f32 CUDA-core ridge (67
// TFLOP/s over 3.35 TB/s = 20 flops per byte), so in f32 on the CUDA cores
// the kernel is bound by operations.  The JAX function is f32 end to end,
// so this first version stays f32 FMA; TF32 tensor cores are a later step
// with its own stated tolerance.
//
// Design: one block of 256 threads per (chunk, head), the TPU grid
// (bc, h).  The q x q score matrix is never materialised: the block walks
// 64-row tiles of query rows t, and for each one the key tiles u up to the
// diagonal only (tiles above it are never computed).  A (t, u) tile of
// scores C_t . B_u is accumulated in registers (a 4 x 4 micro-tile a
// thread) over n in slices of 32 staged in shared memory, so C and B are
// never staged whole (at q 256, n 128 that would be 256 KB, more than a
// block may hold).  The decay is applied by select, never by multiplying a
// mask: above the diagonal exp(acs_t - acs_u) can overflow to inf, and
// inf * 0 is NaN.  The masked tile then goes through shared memory
// (transposed, padded against bank conflicts) and is multiplied by the x
// tile into a 4 x 4 register accumulator per thread, over p in tiles of
// 64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kT = 64;            // query rows t per tile (= key rows u per tile)
constexpr int kK = 32;            // state dim n per staged slice
constexpr int kP = 64;            // head dim p per output tile
constexpr int kPad = kT + 1;      // padded row: conflict-free transposed stores

struct Strides {
  long long x[4];                 // xb  (bc, q, h, p)
  long long a[3];                 // acs (bc, q, h)
  long long b[4];                 // Bh  (bc, q, h, n)
  long long c[4];                 // Ch  (bc, q, h, n)
};

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ xb, const float* __restrict__ acs,
                 const float* __restrict__ Bh, const float* __restrict__ Ch,
                 float* __restrict__ y, Strides st, int q, int h, int p, int n) {
  const int chunk = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  extern __shared__ float smem[];
  float* Cs = smem;                    // (kK, kPad): Cs[k][t]
  float* Bs = Cs + kK * kPad;          // (kK, kPad): Bs[k][u]
  float* Ss = Bs + kK * kPad;          // (kT, kPad): masked scores, Ss[u][t]
  float* Xs = Ss + kT * kPad;          // (kT, kP):   Xs[u][p]
  float* As = Xs + kT * kP;            // (q,):       acs of this chunk and head

  const float* xc = xb + chunk * st.x[0] + head * st.x[2];
  const float* ac = acs + chunk * st.a[0] + head * st.a[2];
  const float* bc = Bh + chunk * st.b[0] + head * st.b[2];
  const float* cc = Ch + chunk * st.c[0] + head * st.c[2];

  for (int i = tid; i < q; i += kThreads) As[i] = ac[i * st.a[1]];
  __syncthreads();

  for (int p0 = 0; p0 < p; p0 += kP) {
    for (int t0 = 0; t0 < q; t0 += kT) {
      float acc[4][4] = {};
      for (int u0 = 0; u0 <= t0; u0 += kT) {        // key tiles up to the diagonal
        float sc[4][4] = {};
        for (int k0 = 0; k0 < n; k0 += kK) {
          __syncthreads();                         // the last slice's readers are done
          for (int i = tid; i < kK * kT; i += kThreads) {
            const int r = i / kK, kk = i % kK;    // consecutive threads: consecutive k
            const int k = k0 + kk, t = t0 + r, u = u0 + r;
            Cs[kk * kPad + r] = (t < q && k < n) ? cc[t * st.c[1] + k * st.c[3]] : 0.f;
            Bs[kk * kPad + r] = (u < q && k < n) ? bc[u * st.b[1] + k * st.b[3]] : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kK; ++kk) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[kk * kPad + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * kPad + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
          }
        }
        __syncthreads();                           // the last PV readers are done
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j, u = u0 + c;
            // select, don't multiply: above the diagonal exp() may be inf
            Ss[c * kPad + r] = (t < q && u <= t) ? sc[i][j] * expf(As[t] - As[u]) : 0.f;
          }
        }
        for (int i = tid; i < kT * kP; i += kThreads) {
          const int r = i / kP, pp = i % kP;      // consecutive threads: consecutive p
          const int u = u0 + r, pc = p0 + pp;
          Xs[r * kP + pp] = (u < q && pc < p) ? xc[u * st.x[1] + pc * st.x[3]] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int uu = 0; uu < kT; ++uu) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = Ss[uu * kPad + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[uu * kP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= q) continue;
        float* yr = y + ((static_cast<size_t>(chunk) * q + t) * h + head) * p;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pc = p0 + tx + 16 * j;
          if (pc < p) yr[pc] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

// strides: 15 element strides, host memory: xb (4), acs (3), Bh (4), Ch (4).
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_intra(const float* xb, const float* acs, const float* Bh, const float* Ch,
                         float* y, const long long* strides, int bc, int q, int h, int p, int n,
                         void* stream) {
  Strides st;
  for (int i = 0; i < 4; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.a[i] = strides[4 + i];
  for (int i = 0; i < 4; ++i) st.b[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.c[i] = strides[11 + i];
  const size_t smem = sizeof(float) * (2 * kK * kPad + kT * kPad + kT * kP + q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_intra_kernel<<<dim3(bc, h), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xb, acs, Bh, Ch, y, st, q, h, p, n);
  return static_cast<int>(cudaGetLastError());
}
