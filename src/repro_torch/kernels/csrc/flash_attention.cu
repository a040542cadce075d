// Flash attention, causal or not, with a runtime sliding window for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel flash_attention_fwd (_fa_kernel) in
// src/repro/kernels/flash_attention/kernel.py: blockwise online-softmax
// attention over q (B, S, Hq, D) and k/v (B, S, Hkv, D), query head h reading
// kv head h / group (GQA), key j visible to query i iff j <= i (when causal)
// and, when window > 0, j > i - window.  The window stays one-sided in both
// modes, as in the TPU kernel, so with causal == 0 a row sees every later
// key and no row is empty.  One build serves gemma3's local and global
// layers and both modes: the window and causal are runtime ints.  The
// prefill path calls it causal once per layer with S a power-of-two bucket
// (16 .. 1024); zamba2's shared attention calls it with D = 80;
// attention.mha_prefill calls it in either mode (whisper-small's encoder
// length, S = 1500, is not a multiple of the tile: its last tile is ragged).
//
// What bounds it on the card: at the prefill shape of smollm-135m (B = 8,
// S = 512, 9/3 heads of 64, bf16) the causal half is ~2.4 GFLOP against
// ~12.6 MB of q, k, v and out, so the least time is set by the bytes
// (~3.8 us at 3.35 TB/s) with the tensor-core flops (~2.4 us at 989
// TFLOP/s) close behind.  In practice the mma.sync rate sets it: with the
// loads and the softmax both removed, the bare ldmatrix + MMA loop of this
// design still took most of the kernel's time on an H100, and neither two
// m16 tiles a warp, 32-key tiles nor issuing the next tile's Q K^T before
// this tile's softmax made it faster.  cuDNN's wgmma kernel, the yardstick,
// stays ahead as the work per block grows; wgmma fed by TMA is the next step.
//
// bf16 design (FA2-style, mma.sync on the tensor cores; mma_bf16.cuh): one
// block of 4 warps per (query tile of 64 rows, q head, b), each warp owning
// 16 rows.  Causal query tiles launch in reverse order, so the longest
// walks start first.  The block walks key tiles of 64 from the first one its
// window reaches to the diagonal (causal) or to the last tile (not causal);
// tiles above the diagonal or wholly outside the window are never read.
// Q, K and V stay bf16 in shared memory (rows padded to D + 8 for
// conflict-free ldmatrix); K and V tiles arrive by
// 16-byte cp.async, double-buffered so tile j + 1 is in flight while tile j
// is computed.  S = Q K^T and O += P V are m16n8k16 MMAs with f32
// accumulators; the online softmax runs on the accumulators (one FFMA and
// one ex2.approx a score) and P goes to the PV product from registers.  Only
// the diagonal tile, the window-edge tile and the ragged last tile test each
// (query, key) pair.  Q fragments stay in registers up to D 128 and are
// re-read from shared memory at D 256.  Rows past S are computed on
// zero-filled queries and not stored.
//
// f32 design (exact FMA, so float32 results track the CPU closely): one
// block of 256 threads per (query tile of 64 rows, q head, b) walks the same
// key tiles, staged in shared memory as f32 (K transposed, for
// conflict-free reads).  Every thread owns a 4 x 4 tile of the 64 x 64
// score block and a 4 x D/16 tile of the output, both in registers, and the
// row max / row sum of the online softmax reduce over the 16 lanes that
// share a row.  (m, l, acc) stay in f32; masked lanes get p = 0 explicitly,
// so a row whose every key in a tile is masked adds nothing (the TPU kernel
// relies on alpha = 0 to wash such garbage out later).
//
// Both read q, k and v through their batch, sequence and head strides, so
// (B, S, H, D) needs no transposed copy; the bf16 copies need 16-byte
// aligned rows (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using repro_mma::kNegInf;
using repro_mma::ld_bf16;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kPad = kBQ + 1;     // padded row of the transposed tiles

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       int S, int Hq, int Hkv, int window, int causal, float sm_scale) {
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    qsT[d * kPad + r] = s < S ? qb[s * qss + d] * sm_scale : 0.f;
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

  // key tiles from the first one the window reaches to the diagonal (causal)
  // or the last one
  const int kt_hi = causal ? min((S - 1) / kBK, (q0 + kBQ - 1) / kBK) : (S - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                         // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int s = k0 + j;
      const bool in = s < S;
      ksT[d * kPad + j] = in ? kb[s * kss + d] : 0.f;
      vs[j * D + d] = in ? vb[s * vss + d] : 0.f;
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
        const bool valid = k_pos < S && (!causal || k_pos <= q_pos) &&
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
    float* o = out + ((static_cast<size_t>(b) * S + s) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[tx + 16 * c] = acc[i][c] * inv;
  }
}

// ---------------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------------

constexpr int kWarpsBf16 = 4;                 // 16 query rows each: kBQ rows a block

template <int D>
constexpr size_t smem_bf16() {                // Q tile + double-buffered K and V tiles
  return sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * ld_bf16<D>();
}

template <int D>
__global__ void __launch_bounds__(kWarpsBf16 * 32)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            int S, int Hq, int Hkv, int window, int causal,
                            float scale_log2) {
  using repro_mma::cp_async16;
  constexpr int LD = ld_bf16<D>();
  constexpr int CH = D / 8;                   // 16-byte chunks per row
  constexpr int NTHR = kWarpsBf16 * 32;
  using Warp = repro_mma::WarpAttention<D, kBK, LD, (D <= 128)>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBQ][LD]
  __nv_bfloat16* ks = qs + kBQ * LD;                                 // [2][kBK][LD]
  __nv_bfloat16* vs = ks + 2 * kBK * LD;                             // [2][kBK][LD]

  // causal: the longest walks first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * CH; i += NTHR) {
    const int r = i / CH, c = (i % CH) * 8;
    const int s = q0 + r;
    cp_async16(qs + r * LD + c, qb + (s < S ? s : 0) * qss + c, s < S);
  }
  auto stage = [&](int kt, int buf) {         // key tile kt -> buffer buf, rows past S zeroed
    for (int i = tid; i < kBK * CH; i += NTHR) {
      const int j = i / CH, c = (i % CH) * 8;
      const int s = kt * kBK + j;
      const int sc = s < S ? s : 0;
      cp_async16(ks + (buf * kBK + j) * LD + c, kb + sc * kss + c, s < S);
      cp_async16(vs + (buf * kBK + j) * LD + c, vb + sc * vss + c, s < S);
    }
  };

  // key tiles from the first one the window reaches to the diagonal (causal)
  // or the last one
  const int kt_hi = causal ? min((S - 1) / kBK, (q0 + kBQ - 1) / kBK) : (S - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  stage(kt_lo, 0);
  repro_mma::cp_async_commit();               // group: Q and the first tile

  Warp wa;
  wa.init();
  const int row0 = q0 + warp * 16 + lane / 4; // this thread's rows: row0, row0 + 8
  const __nv_bfloat16* qw = qs + warp * 16 * LD;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) stage(kt + 1, buf ^ 1);
    repro_mma::cp_async_commit();
    repro_mma::cp_async_wait<1>();            // tile kt has landed, kt + 1 in flight
    __syncthreads();
    if (kt == kt_lo) wa.load_q(qw, lane);

    float s[Warp::NT][4];
    wa.scores(s, qw, ks + buf * kBK * LD, lane);
    const int k0 = kt * kBK;
    // no pair of this tile needs a test: all keys exist, precede every row
    // (causal), and lie inside every row's window
    const bool full = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kBQ - 1 - window);
    if (full) {
      wa.template softmax<false>(s, scale_log2, [](int, int, int) { return true; });
    } else {
      const int kc = k0 + 2 * (lane % 4);
      wa.template softmax<true>(s, scale_log2, [&](int hh, int j, int e) {
        const int qp = row0 + 8 * hh, kp = kc + j * 8 + e;
        return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
      });
    }
    wa.pv(s, vs + buf * kBK * LD, lane);
    __syncthreads();                          // buffer buf is free for tile kt + 2
  }
  wa.finish();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = row0 + 8 * hh;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(wa.l[hh], 1e-30f);
    __nv_bfloat16* o = out + ((static_cast<size_t>(b) * S + s) * Hq + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < Warp::ND; ++t)
      *reinterpret_cast<__nv_bfloat162*>(o + t * 8) =
          __floats2bfloat162_rn(wa.o[t][2 * hh] * inv, wa.o[t][2 * hh + 1] * inv);
  }
}

// ---------------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       const long long* st, int B, int S, int Hq, int Hkv, int window,
                       int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * kPad + kBK * D + kBQ * kPad);
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], S, Hq, Hkv, window, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        const long long* st, int B, int S, int Hq, int Hkv, int window,
                        int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bf16<D>();
  auto kernel = flash_attention_bf16_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kWarpsBf16 * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], S, Hq, Hkv, window, causal,
      sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <bool BF16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const long long* st, int B, int S, int Hq, int Hkv, int window,
                   int causal, float sm_scale, cudaStream_t stream) {
  if constexpr (BF16)
    return launch_bf16<D>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
  else
    return launch_f32<D>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
}

template <bool BF16>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                       const long long* st, int B, int S, int Hq, int Hkv, int window,
                       int causal, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<BF16, 16>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
    case 32:
      return launch<BF16, 32>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
    case 64:
      return launch<BF16, 64>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
    case 80:
      return launch<BF16, 80>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
    case 128:
      return launch<BF16, 128>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
    case 256:
      return launch<BF16, 256>(q, k, v, out, st, B, S, Hq, Hkv, window, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share one).
// strides: 9 element strides, (batch, sequence, head) of q, then k, then v;
// the head dim is contiguous.  out is a contiguous (B, S, Hq, D).  D must be
// 16, 32, 64, 80, 128 or 256; bf16 rows must be 16-byte aligned (pointers
// and strides multiples of 8 elements).  Returns cudaGetLastError() after
// the launch.  causal: 1 = key j <= query i only, 0 = every key (the
// window, if any, still applies).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B, int S, int Hq,
                               int Hkv, int D, int window, int causal, float sm_scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_d<false>(D, q, k, v, out, strides, B, S, Hq, Hkv,
                                              window, causal, sm_scale, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<true>(D, q, k, v, out, strides, B, S, Hq, Hkv,
                                             window, causal, sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
