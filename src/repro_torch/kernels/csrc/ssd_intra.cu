// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ssd_intra_fwd (_ssd_kernel) in
// src/repro/kernels/ssd/kernel.py.  For each chunk c and head h of
//   xb (bc, q, h, p), acs (bc, q, h), all float32,
// and the group tensors B / C (bc, q, G, n) float32, head h reading group
// h / (h_count / G), it writes y (bc, q, h, p) float32:
//   y[t] = sum_{u <= t} (C_t . B_u) * exp(acs_t - acs_u) * x[u]
// i.e. ((C B^T) .* tril(exp(acs_t - acs_u))) x.  Inputs are read through
// their strides (rows of n and of p contiguous, 16-byte aligned); y is
// contiguous.
//
// What bounds it on the card: operations.  At mamba2-1.3b's prefill shape
// (q 256, n 128, p 64, 64 heads, one group) a chunk reads x (4.2 MB), acs
// and B and C once for the group (0.26 MB) and writes y (4.2 MB), and its
// work is C.B^T once for the group (8.4 MFLOP over the causal pairs) plus
// P.x once per head (270 MFLOP): ~32 flops per byte, past the f32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20).  The JAX function is
// f32 end to end, so the body stays f32 FMA; TF32 tensor cores are a later
// step with its own stated tolerance.
//
// Design: two passes, the second launched as a programmatic dependent of
// the first (pdl.cuh), so that its blocks start, load acs and prefetch
// their first x tile while the first pass runs.
//
// Pass 1, scores: one block of 256 threads per (chunk, group, causal pair
// of 64-row tiles (t-tile, u-tile)) computes S = C_t . B_u^T over n in f32
// FMA, k ascending (a 4 x 4 register micro-tile a thread), with C and B
// staged in slices of 32 through shared memory by 16-byte cp.async, a ring
// of four slices (all of n = 128 in flight at once).  S goes to an f32
// scratch (bc, G, qp, qp), qp = q rounded up to 64, lower tiles only:
// 256 KB a chunk and group, which stays in L2.  A group shared by every
// head (n_groups = 1: the model passes B and C as views with a zero head
// stride) has its scores computed once, not once per head; materialised
// groups run with a group of one head.
//
// Pass 2, per head: one block of 128 threads per (chunk, head, 64-column
// p tile, 32-row t-tile), t-tiles launched longest-first (the last t-tile
// walks every key up to the diagonal).  The block streams S's row strip
// for its t-tile up to the diagonal and the matching x rows, 32 keys u a
// slice, through double-buffered 16-byte cp.async, turns each S slice into
// P in shared memory, applying exp(acs_t - acs_u) by select, never by
// multiplying a mask (above the diagonal the exponential can overflow to
// inf, and inf * 0 is NaN), and accumulates P x into a 4 x 4 register
// micro-tile a thread, u ascending.  At q 256 that is 8 blocks a (chunk,
// head): 512 at one chunk of 64 heads, where the one-pass kernel ran 64.
// tools/ssd_variants.py times other tile heights and ring depths.
//
// Both sums run in the order of the previous one-pass kernel (k ascending
// for a score, u ascending for an output), so the results keep its bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "pdl.cuh"

namespace {

using repro_mma::cp_async16;
using repro_mma::cp_async_commit;
using repro_mma::cp_async_wait;

constexpr int kT = 64;            // rows of a score tile pair's t and u tiles, a p tile
constexpr int kThreads = 256;     // pass 1: 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kK = 32;            // pass 1: state dim n per staged slice
constexpr int kLdK = kK + 4;      // padded slice row: 16-byte aligned, conflict-free
constexpr int kStages = 4;        // pass 1: ring of n slices (n 128 in flight at once)
constexpr int kTT = 32;           // pass 2: rows of its t-tile
constexpr int kTR = 4;            // pass 2: rows a thread (columns: 4)
constexpr int kRS = kTT / kTR;    // pass 2: row stride between a thread's rows
constexpr int kApplyThreads = kRS * 16;
constexpr int kUS = 32;           // pass 2: keys u a staged slice
constexpr int kLdS = kUS + 4;     // padded S row
constexpr int kLdX = kT + 4;      // padded x row

struct ScoreStrides {
  long long b[3];                 // B (bc, q, G), n contiguous
  long long c[3];                 // C (bc, q, G), n contiguous
};

struct ApplyStrides {
  long long x[3];                 // xb (bc, q, h), p contiguous
  long long a[3];                 // acs (bc, q, h)
};

__host__ __device__ inline int tiles(int q) { return (q + kT - 1) / kT; }

constexpr size_t kScoreSmem = sizeof(float) * kStages * 2 * kT * kLdK;
__host__ __device__ inline size_t apply_smem(int q) {
  return sizeof(float) * (2 * (kTT * kLdS + kUS * kLdX) + tiles(q) * kT);
}

// Pass 1.  Block (pair, group, chunk); pair enumerates the tile pairs
// (ti, ui), ui <= ti.  Thread (tx, ty) owns t = t0 + ty + 16 i and
// u = u0 + tx + 16 j.
__global__ void __launch_bounds__(kThreads)
ssd_intra_scores_kernel(const float* __restrict__ Bg, const float* __restrict__ Cg,
                        float* __restrict__ S, ScoreStrides st, int q, int G, int n) {
  repro_pdl::release_dependents();            // pass 2 may launch and prefetch x
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= static_cast<int>(blockIdx.x)) ++ti;
  const int ui = blockIdx.x - ti * (ti + 1) / 2;
  const int g = blockIdx.y, chunk = blockIdx.z;
  const int t0 = ti * kT, u0 = ui * kT;
  const int qp = tiles(q) * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                           // (kStages, kT, kLdK): Cs[r][k], row t0 + r
  float* Bs = Cs + kStages * kT * kLdK;       // (kStages, kT, kLdK): Bs[r][k], row u0 + r

  const float* cb = Cg + chunk * st.c[0] + g * st.c[2];
  const float* bb = Bg + chunk * st.b[0] + g * st.b[2];
  const int slices = (n + kK - 1) / kK;
  auto stage = [&](int s) {                   // slice s: 64 rows x 32 k of C and of B
    if (s < slices) {
      float* cd = Cs + (s % kStages) * kT * kLdK;
      float* bd = Bs + (s % kStages) * kT * kLdK;
#pragma unroll
      for (int j = 0; j < kT * kK / 4 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (kK / 4), kk = 4 * (i % (kK / 4)), k = s * kK + kk;
        const int t = t0 + r, u = u0 + r;
        cp_async16(cd + r * kLdK + kk, cb + t * st.c[1] + k, t < q && k < n);
        cp_async16(bd + r * kLdK + kk, bb + u * st.b[1] + k, u < q && k < n);
      }
    }
    cp_async_commit();                        // an empty group past the last slice
  };

  float sc[4][4] = {};
  for (int s = 0; s < kStages - 1; ++s) stage(s);   // kStages - 1 slices in flight
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();             // slice s has landed
    __syncthreads();                          // ... for every thread; slice s - 1 is used
    stage(s + kStages - 1);                   // into slice s - 1's buffer
    const float* cs = Cs + (s % kStages) * kT * kLdK;
    const float* bs = Bs + (s % kStages) * kT * kLdK;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[i] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * i) * kLdK + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&bs[(tx + 16 * j) * kLdK + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {       // k ascending: the one-pass kernel's order
          sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
          sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
          sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
          sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
        }
    }
  }
  float* so = S + (static_cast<size_t>(chunk) * G + g) * qp * qp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      so[static_cast<size_t>(t0 + ty + 16 * i) * qp + u0 + tx + 16 * j] = sc[i][j];
}

// Pass 2.  Block (head * p_tiles + p tile, chunk, t-tile counted from the
// last).  Thread (tx, ty) owns rows ty + kRS i and columns 4 tx .. 4 tx + 3.
__global__ void __launch_bounds__(kApplyThreads)
ssd_intra_apply_kernel(const float* __restrict__ xb, const float* __restrict__ acs,
                       const float* __restrict__ S, float* __restrict__ y, ApplyStrides st,
                       int q, int h, int p, int group, int G) {
  const int qp = tiles(q) * kT, nt = (q + kTT - 1) / kTT;
  const int p_tiles = (p + kT - 1) / kT;
  const int head = blockIdx.x / p_tiles, p0 = (blockIdx.x % p_tiles) * kT;
  const int chunk = blockIdx.y;
  const int t0 = (nt - 1 - static_cast<int>(blockIdx.z)) * kTT;   // longest first
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) float smem[];
  float* Ps = smem;                           // (2, kTT, kLdS): S slice, then P
  float* Xs = Ps + 2 * kTT * kLdS;            // (2, kUS, kLdX): x slice
  float* As = Xs + 2 * kUS * kLdX;            // (t0 + kTT,): acs of this chunk and head

  const float* xc = xb + chunk * st.x[0] + head * st.x[2];
  const float* sc = S + (static_cast<size_t>(chunk) * G + head / group) * qp * qp;
  auto stage_x = [&](int ui, int buf) {       // x rows u0 .., columns p0 ..
    for (int i = tid; i < kUS * kT / 4; i += kApplyThreads) {
      const int r = i / (kT / 4), c = 4 * (i % (kT / 4));
      const int u = ui * kUS + r;
      cp_async16(&Xs[(buf * kUS + r) * kLdX + c], xc + u * st.x[1] + p0 + c,
                 u < q && p0 + c < p);
    }
  };
  auto stage_s = [&](int ui, int buf) {       // S rows t0 .., columns u0 ..
    for (int i = tid; i < kTT * kUS / 4; i += kApplyThreads) {
      const int r = i / (kUS / 4), c = 4 * (i % (kUS / 4));
      cp_async16(&Ps[(buf * kTT + r) * kLdS + c],
                 sc + static_cast<size_t>(t0 + r) * qp + ui * kUS + c, true);
    }
  };

  for (int i = tid; i < t0 + kTT; i += kApplyThreads)
    As[i] = i < q ? acs[chunk * st.a[0] + i * st.a[1] + head * st.a[2]] : 0.f;
  stage_x(0, 0);
  repro_pdl::wait_for_primary();              // pass 1's scores are written
  stage_s(0, 0);
  cp_async_commit();

  float acc[kTR][4] = {};
  const int n_slices = (t0 + kTT) / kUS;      // u slices up to the diagonal
  for (int ui = 0; ui < n_slices; ++ui) {
    const int buf = ui & 1;
    if (ui + 1 < n_slices) {
      stage_x(ui + 1, buf ^ 1);               // in flight while slice ui is used
      stage_s(ui + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                          // slice ui (and As) visible
    float* P = Ps + buf * kTT * kLdS;
    const float* X = Xs + buf * kUS * kLdX;
    for (int i = tid; i < kTT * kUS; i += kApplyThreads) {
      const int r = i / kUS, c = i % kUS;
      const int t = t0 + r, u = ui * kUS + c;
      // select, don't multiply: above the diagonal exp() may be inf
      P[r * kLdS + c] = (t < q && u <= t) ? P[r * kLdS + c] * expf(As[t] - As[u]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int uu = 0; uu < kUS; uu += 4) {
      float4 pv[kTR];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&P[(ty + kRS * i) * kLdS + uu]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {           // u ascending: the one-pass kernel's order
        const float4 xv = *reinterpret_cast<const float4*>(&X[(uu + e) * kLdX + 4 * tx]);
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(pe, xv.x, acc[i][0]);
          acc[i][1] = fmaf(pe, xv.y, acc[i][1]);
          acc[i][2] = fmaf(pe, xv.z, acc[i][2]);
          acc[i][3] = fmaf(pe, xv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();                          // buffer buf free for slice ui + 2
  }
  const int pc = p0 + 4 * tx;
  if (pc >= p) return;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int t = t0 + ty + kRS * i;
    if (t < q)
      *reinterpret_cast<float4*>(y + ((static_cast<size_t>(chunk) * q + t) * h + head) * p + pc) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// strides: 12 element strides, host memory: B (3), C (3), xb (3), acs (3),
// each over (bc, q, group or head); B, C and xb have their last dim
// contiguous, and every row and base 16-byte aligned (n and p multiples of
// 4).  scores: f32 scratch of bc * G * qp * qp, qp = q rounded up to 64.
// G groups of h / G heads each.  Returns the first CUDA error of the two
// launches.
extern "C" int ssd_intra(const float* xb, const float* acs, const float* Bg, const float* Cg,
                         float* y, float* scores, const long long* strides, int bc, int q,
                         int h, int p, int n, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScoreStrides ss;
  ApplyStrides as;
  for (int i = 0; i < 3; ++i) {
    ss.b[i] = strides[i];
    ss.c[i] = strides[3 + i];
    as.x[i] = strides[6 + i];
    as.a[i] = strides[9 + i];
  }
  const int nt = tiles(q);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_scores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kScoreSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_intra_scores_kernel<<<dim3(nt * (nt + 1) / 2, G, bc), kThreads, kScoreSmem, st>>>(
      Bg, Cg, scores, ss, q, G, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = apply_smem(q);
  err = cudaFuncSetAttribute(ssd_intra_apply_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h * ((p + kT - 1) / kT), bc, (q + kTT - 1) / kTT);
  return static_cast<int>(repro_pdl::launch_dependent_smem(
      ssd_intra_apply_kernel, grid, dim3(kApplyThreads), smem, st, xb, acs,
      static_cast<const float*>(scores), y, as, q, h, p, h / G, G));
}
