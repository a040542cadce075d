// Fused lm-head + greedy epilogue for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel lmhead_epilogue_fwd (_lmhead_epilogue_kernel) in
// src/repro/kernels/sampling/kernel.py: for hidden rows h (N, d) and the
// head weight w (d, V), return each row's greedy token argmax(h @ w) and its
// log-probability, without materializing the (N, V) logits in device memory.
// Ties resolve to the first maximal index, as torch.argmax / jnp.argmax do.
//
// What bounds it on the card: bytes, narrowly.  The weight (56.6 MB at bf16
// for smollm-135m) is read once per call and the product does 2 * N flops
// per weight element -- 256 flop/byte at N = 128, just under the ~295 where
// a bf16 H100 turns compute-bound -- so the tensor cores are needed to keep
// up with the weight stream at all.
//
// bf16 design (lmhead_tc_kernel): persistent blocks, about one a SM, each
// walking vocab tiles kVT wide (tile j, j + grid, ...) for one row tile of
// up to 128 rows (N 256 takes two row tiles; their blocks share the SMs and
// read each vocab tile at about the same time, so the second read hits L2).
// Eight warps, 4 x 2, each own 32 rows x 64 columns of the tile's logits as
// m16n8k16 bf16 -> f32 mma.sync accumulators (mma_bf16.cuh).  h is the A
// operand, loaded with ldmatrix; a tied head (w = embed.T, embedding rows
// contiguous along d) is the B operand loaded with ldmatrix, as K in flash
// attention's Q K^T; an untied (d, V) head loads with ldmatrix.trans, as V
// in P V.  h's and w's k-tiles, kKT deep, stream together through a
// 5-stage ring by 16-byte cp.async (180 KB of shared memory), the next
// stages in flight while this one multiplies, across vocab tiles too; h's
// re-reads hit L2 (keeping the block's 128 rows of h resident instead, 150
// KB at d = 576, leaves room for a 3-stage ring and timed slower at
// smollm-135m's width).  Shared rows are padded by 16 bytes so every
// ldmatrix phase is free of bank conflicts, and the fragments of the next
// k-step load while this one multiplies.
// When a vocab tile's accumulators are complete each thread folds its
// own columns into a running (max, first argmax, sum exp(x - max)) per row,
// in registers; at the end of the walk the 4 lanes of a row merge by
// shuffles and the two column warps through shared memory, and the block
// writes one partial per row: (N, grid) partials instead of (N, V / 64).
// Partials no longer follow vocab order, so every merge, the fold's
// included, breaks equal maxima by the lower index.
//
// f32 design (lmhead_partials_kernel; exact FMA, so float32 results track
// the CPU closely): one block per (vocab tile of kTileV, row tile of
// kTileN) computes its logits tile from shared-memory tiles of h and w and
// writes each row's (max, sum of exp(x - max), first argmax) partial.
//
// lmhead_fold_kernel: one warp per row folds the row's partials: larger
// value first, then lower index, so the result is the row's first maximal
// index whatever the order of the partials.  It is launched as a
// programmatic dependent of its pass 1 (pdl.cuh), which the tensor-core
// kernel releases at its start.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "pdl.cuh"

namespace {

using repro_mma::kNegInf;
constexpr int kTileN = 128;     // rows per block
constexpr int kTileV = 64;      // vocab columns per block
constexpr int kTileK = 16;      // reduction depth per shared-memory stage
constexpr int kThreads = 256;   // 16 x 16; each thread owns 8 rows x 4 columns
constexpr int kRowsPerThread = kTileN / 16;
constexpr int kColsPerThread = kTileV / 16;

__global__ void __launch_bounds__(kThreads)
lmhead_partials_kernel(const float* __restrict__ h,  // (N, d) contiguous
                       const float* __restrict__ w,  // (d, V) at strides (sd, sv)
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
      hs[kk][r] = (n < N && k < d) ? h[static_cast<size_t>(n) * d + k] : 0.f;
    }
    for (int i = tid; i < kTileK * kTileV; i += kThreads) {
      // walk the tile along whichever axis of w is contiguous
      int kk, c;
      if (sd == 1) { kk = i % kTileK; c = i / kTileK; }
      else { c = i % kTileV; kk = i / kTileV; }
      const int v = v0 + c, k = k0 + kk;
      ws[kk][c] = (v < V && k < d) ? w[k * sd + v * sv] : 0.f;
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
  repro_pdl::wait_for_primary();     // pass 1's partials are written
  float m = kNegInf, l = 0.f, best = kNegInf;
  int best_i = INT32_MAX;
  for (int t = lane; t < n_tiles; t += 32) {
    const size_t o = static_cast<size_t>(n) * n_tiles + t;
    const float tm = pmax[o];
    const int ti = pidx[o];
    if (tm > best || (tm == best && ti < best_i)) {   // equal maxima: the lower index
      best = tm;
      best_i = ti;
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

constexpr int kFoldWarps = 4;

// the fold, launched as a programmatic dependent of pass 1 (pdl.cuh)
cudaError_t launch_fold(const float* pmax, const float* psum, const int32_t* pidx, int N,
                        int n_cols, int32_t* tok, float* lp, cudaStream_t stream) {
  return repro_pdl::launch_dependent(lmhead_fold_kernel, dim3((N + kFoldWarps - 1) / kFoldWarps),
                                     dim3(32 * kFoldWarps), stream, pmax, psum, pidx, N,
                                     n_cols, tok, lp);
}

cudaError_t launch_f32(const void* h, const void* w, long long sd, long long sv, int N, int d,
                       int V, float* pmax, float* psum, int32_t* pidx, int32_t* tok, float* lp,
                       cudaStream_t stream) {
  const int n_tiles = (V + kTileV - 1) / kTileV;
  const dim3 grid(n_tiles, (N + kTileN - 1) / kTileN);
  lmhead_partials_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), sd, sv, N, d, V, n_tiles,
      pmax, psum, pidx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold(pmax, psum, pidx, N, n_tiles, tok, lp, stream);
}

// ---------------------------------------------------------------------------------
// bf16: tensor cores, persistent blocks
// ---------------------------------------------------------------------------------

constexpr int kRows = 128;        // rows of a row tile (one block's M)
constexpr int kVT = 128;          // vocab columns of a tile
constexpr int kKT = 64;           // reduction depth of a stage
constexpr int kTCWarps = 8;       // 4 (rows) x 2 (columns), 32 x 64 each
constexpr int kTCThreads = kTCWarps * 32;
constexpr int kLDK = kKT + 8;     // padded row of a [*][kKT] tile: h stage, tied w stage
constexpr int kLDV = kVT + 8;     // padded row of an untied w stage [kKT][kVT]
constexpr float kLog2e = 1.4426950408889634f;

template <bool TIED>
struct TCLayout {                   // the ring: STAGES x (h k-tile, w k-tile)
  static constexpr int W_STAGE = TIED ? kVT * kLDK : kKT * kLDV;   // bf16 elements
  static constexpr int H_STAGE = kRows * kLDK;
  static constexpr int STAGES = 5;
  static constexpr size_t SMEM = 2 * STAGES * (H_STAGE + W_STAGE);  // bytes
};

// one thread's running (max, first argmax, sum exp(x - max)) of a row,
// merged with another's: equal maxima keep the lower index.  Rescales go
// by differences, so two empty states (max -1e30, sum 0) stay empty.
__device__ __forceinline__ void merge_best(float& m, int& i, float& l, float om, int oi,
                                           float ol) {
  const float mn = fmaxf(m, om);
  l = l * repro_mma::fast_exp2((m - mn) * kLog2e) + ol * repro_mma::fast_exp2((om - mn) * kLog2e);
  if (om > m || (om == m && oi < i)) i = oi;
  m = mn;
}

template <bool TIED>
__global__ void __launch_bounds__(kTCThreads, 1)
lmhead_tc_kernel(const __nv_bfloat16* __restrict__ h,   // (N, d) contiguous
                 const __nv_bfloat16* __restrict__ w,   // (d, V) at strides (sd, sv)
                 long long sd, long long sv, int N, int d, int V, int n_vtiles,
                 float* __restrict__ pmax,              // (N, gridDim.x)
                 float* __restrict__ psum, int32_t* __restrict__ pidx) {
  using L = TCLayout<TIED>;
  constexpr int S = L::STAGES;
  constexpr int KS = kKT / 16;                     // k-steps of a stage
  using repro_mma::cp_async16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [S][kRows][kLDK]
  __nv_bfloat16* ws = hs + S * L::H_STAGE;                          // [S][W_STAGE]

  const int n0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int nk = (d + kKT - 1) / kKT;
  const int my_tiles = (n_vtiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * nk;                 // (vocab tile, k tile) stages of the walk
  const bool warp_live = n0 + wm * 32 < N;         // a warp whose rows are all past N idles
  repro_pdl::release_dependents();                 // the fold may launch and wait

  // stage t of the walk into ring slot t % S: cp.async 16 bytes a thread at
  // a time, zero-filled past V, d and N
  auto load_stage = [&](int t) {
    const int slot = t % S;
    const int v0 = (blockIdx.x + (t / nk) * gridDim.x) * kVT;
    const int k0 = (t % nk) * kKT;
    __nv_bfloat16* wst = ws + slot * L::W_STAGE;
    if constexpr (TIED) {                          // [v][k]: w[k, v] at v * sv + k
      for (int i = tid; i < kVT * (kKT / 8); i += kTCThreads) {
        const int r = i / (kKT / 8), c = (i % (kKT / 8)) * 8;
        const bool in = v0 + r < V && k0 + c < d;
        cp_async16(wst + r * kLDK + c, in ? w + (v0 + r) * sv + k0 + c : w, in);
      }
    } else {                                       // [k][v]: w[k, v] at k * sd + v
      for (int i = tid; i < kKT * (kVT / 8); i += kTCThreads) {
        const int r = i / (kVT / 8), c = (i % (kVT / 8)) * 8;
        const bool in = k0 + r < d && v0 + c < V;
        cp_async16(wst + r * kLDV + c, in ? w + (k0 + r) * sd + v0 + c : w, in);
      }
    }
    __nv_bfloat16* hst = hs + slot * L::H_STAGE;
    for (int i = tid; i < kRows * (kKT / 8); i += kTCThreads) {
      const int r = i / (kKT / 8), c = (i % (kKT / 8)) * 8;
      const bool in = n0 + r < N && k0 + c < d;
      cp_async16(hst + r * kLDK + c, in ? h + static_cast<size_t>(n0 + r) * d + k0 + c : h, in);
    }
  };

  // the A (h) and B (w) fragments of k-step kk of stage t
  const int krow = (lane % 8) + (lane / 16) * 8, kcol = ((lane / 8) % 2) * 8;   // ldmatrix
  const int vrow = (lane % 8) + ((lane / 8) % 2) * 8, vcol = (lane / 16) * 8;   // .trans
  auto load_frags = [&](int t, int kk, uint32_t (&a)[2][4], uint32_t (&b)[4][4]) {
    const __nv_bfloat16* wst = ws + (t % S) * L::W_STAGE;
    const __nv_bfloat16* hst = hs + (t % S) * L::H_STAGE;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      repro_mma::ldmatrix_x4(
          a[mi], hst + (wm * 32 + mi * 16 + lane % 16) * kLDK + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {               // n8 tiles 2 jp, 2 jp + 1
      if constexpr (TIED)
        repro_mma::ldmatrix_x4(b[jp], wst + (wn * 64 + jp * 16 + krow) * kLDK + kk * 16 + kcol);
      else
        repro_mma::ldmatrix_x4_trans(b[jp],
                                     wst + (kk * 16 + vrow) * kLDV + wn * 64 + jp * 16 + vcol);
    }
  };

#pragma unroll
  for (int s = 0; s < S; ++s) {                    // stages 0 .. S - 1 in flight
    if (s < total) load_stage(s);
    repro_mma::cp_async_commit();
  }
  repro_mma::cp_async_wait<S - 1>();               // stage 0 has landed
  __syncthreads();

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  // this thread's rows: wm * 32 + mi * 16 + hh * 8 + lane / 4, r = 2 mi + hh
  float best[4], bsum[4];
  int bidx[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r] = kNegInf;
    bsum[r] = 0.f;
    bidx[r] = INT32_MAX;
  }

  // Fragments are double-buffered by k-step: those of the next k-step (at
  // a stage's last, the next stage's first) load while this one multiplies.
  uint32_t fa[2][2][4], fb[2][4][4];
  if (warp_live && total > 0) load_frags(0, 0, fa[0], fb[0]);
  for (int t = 0; t < total; ++t) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int cur = kk % 2, nxt = (kk + 1) % 2;
      if (kk == KS - 1) {
        // every warp has its fragments of stage t: its slot takes stage t + S
        repro_mma::cp_async_wait<S - 2>();         // stage t + 1 has landed
        __syncthreads();
        if (t + S < total) load_stage(t + S);
        repro_mma::cp_async_commit();
        if (warp_live && t + 1 < total) load_frags(t + 1, 0, fa[nxt], fb[nxt]);
      } else if (warp_live) {
        load_frags(t, kk + 1, fa[nxt], fb[nxt]);
      }
      if (warp_live) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            repro_mma::mma_bf16(acc[mi][2 * jp], fa[cur][mi], fb[cur][jp][0], fb[cur][jp][1]);
            repro_mma::mma_bf16(acc[mi][2 * jp + 1], fa[cur][mi], fb[cur][jp][2],
                                fb[cur][jp][3]);
          }
      }
    }
    if (t % nk == nk - 1 && warp_live) {           // the tile's logits are complete
      const int vbase = (blockIdx.x + (t / nk) * gridDim.x) * kVT + wn * 64 + 2 * (lane % 4);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 2 * mi + hh;
          float tmax = kNegInf;
          int targ = INT32_MAX;
#pragma unroll
          for (int j = 0; j < 8; ++j)              // ascending columns: > keeps the first
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = acc[mi][j][2 * hh + e];
              if (vbase + j * 8 + e < V && x > tmax) {
                tmax = x;
                targ = vbase + j * 8 + e;
              }
            }
          const float mn = fmaxf(best[r], tmax);
          const float neg = -mn * kLog2e;
          float sum = bsum[r] * repro_mma::fast_exp2((best[r] - mn) * kLog2e);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (vbase + j * 8 + e < V)           // a real column: mn is finite
                sum += repro_mma::fast_exp2(fmaf(acc[mi][j][2 * hh + e], kLog2e, neg));
          if (tmax > best[r]) bidx[r] = targ;      // tiles ascend: equal keeps the lower
          best[r] = mn;
          bsum[r] = sum;
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
  }
  repro_mma::cp_async_wait<0>();

  // the 4 lanes of a row, then the two column warps, then one partial a row
  __shared__ float red_m[2][kRows], red_l[2][kRows];
  __shared__ int red_i[2][kRows];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      const float ol = __shfl_xor_sync(0xffffffffu, bsum[r], off);
      merge_best(best[r], bidx[r], bsum[r], om, oi, ol);
    }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wm * 32 + (r / 2) * 16 + (r % 2) * 8 + lane / 4;
      red_m[wn][row] = best[r];
      red_l[wn][row] = bsum[r];
      red_i[wn][row] = bidx[r];
    }
  }
  __syncthreads();
  if (tid < kRows && n0 + tid < N) {
    float m = red_m[0][tid], l = red_l[0][tid];
    int i = red_i[0][tid];
    merge_best(m, i, l, red_m[1][tid], red_i[1][tid], red_l[1][tid]);
    const size_t o = static_cast<size_t>(n0 + tid) * gridDim.x + blockIdx.x;
    pmax[o] = m;
    psum[o] = l;
    pidx[o] = i;
  }
}

int tc_row_tiles(int N) { return (N + kRows - 1) / kRows; }

int tc_blocks(int N, int V, int sm_count) {        // persistent: about one a SM
  const int n_vtiles = (V + kVT - 1) / kVT;
  return max(1, min(n_vtiles, sm_count / tc_row_tiles(N)));
}

template <bool TIED>
cudaError_t launch_tc(const void* h, const void* w, long long sd, long long sv, int N, int d,
                      int V, int n_cols, float* pmax, float* psum, int32_t* pidx,
                      cudaStream_t stream) {
  constexpr size_t smem = TCLayout<TIED>::SMEM;
  auto kernel = lmhead_tc_kernel<TIED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_cols, tc_row_tiles(N)), kTCThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w), sd, sv, N, d,
      V, (V + kVT - 1) / kVT, pmax, psum, pidx);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* h, const void* w, long long sd, long long sv, int N, int d,
                        int V, int n_cols, float* pmax, float* psum, int32_t* pidx,
                        int32_t* tok, float* lp, cudaStream_t stream) {
  auto f = sd == 1 ? launch_tc<true> : launch_tc<false>;     // tied: embed.T
  cudaError_t err = f(h, w, sd, sv, N, d, V, n_cols, pmax, psum, pidx, stream);
  if (err != cudaSuccess) return err;
  return launch_fold(pmax, psum, pidx, N, n_cols, tok, lp, stream);
}

}  // namespace

// Columns of the (N, cols) partials lmhead_greedy writes: one per vocab tile
// of 64 for float32, one per persistent block for bfloat16.
extern "C" int lmhead_partial_cols(int dtype, int N, int V, int sm_count) {
  if (dtype == 1) return tc_blocks(N, V, sm_count);
  return (V + kTileV - 1) / kTileV;
}

// dtype codes: 0 = float32, 1 = bfloat16 (h and w share one).  The caller
// allocates the partials, each (N, n_cols) with n_cols from
// lmhead_partial_cols.  The bf16 kernel takes d % 16 == 0, 16-byte aligned
// h and w, and w either tied (sd == 1, sv % 8 == 0) or untied (sv == 1,
// sd % 8 == 0, V % 8 == 0); the f32 kernel any strides.
extern "C" int lmhead_greedy(int dtype, const void* h, const void* w, long long sd,
                             long long sv, int N, int d, int V, int n_cols, float* pmax,
                             float* psum, int32_t* pidx, int32_t* tok, float* lp,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch_f32(h, w, sd, sv, N, d, V, pmax, psum, pidx, tok, lp, st));
  if (dtype == 1 && d % 16 == 0 && ((sd == 1 && sv % 8 == 0) || (sv == 1 && sd % 8 == 0)))
    return static_cast<int>(
        launch_bf16(h, w, sd, sv, N, d, V, n_cols, pmax, psum, pidx, tok, lp, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
