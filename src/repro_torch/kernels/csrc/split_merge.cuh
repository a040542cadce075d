// Pass 2 of the split-K attention kernels (sm_90a): the log-sum-exp merge of
// per-split partials, shared by the bf16 instances of
// paged_mixed_attention.cu, paged_decode_attention.cu and
// dense_decode_attention.cu (a dense cache is a paged one whose table is
// the identity).  Each .cu builds into its own library, so each includes
// this header once.
//
// Pass 1 of each kernel runs one block per (row b, kv head, split), a
// split being pages_per_split consecutive table entries of the row, and
// writes f32 partials per query row r = t * group + g (T queries of the
// kv head's group; T = 1 for decode):
//   part_ml  (B, Hkv, n_splits, T * group, 2): m, the split's max raw score
//            (-1e30 when the row sees no key there), and l = sum p;
//   part_acc (B, Hkv, n_splits, T * group, D): sum p * v, unnormalised;
// with p = exp2(s * scale_log2 - m * scale_log2), s the raw dot product and
// scale_log2 = sm_scale * log2(e).  Only the row's live splits are written;
// the merge reads exactly those, found from starts[b] as pass 1 found them
// (from start_bias alone when starts is null: every row at one position).
// It is launched as a programmatic dependent of pass 1 (pdl.cuh): its
// blocks start while pass 1 runs, find their row's live splits, and wait
// for pass 1 to complete before they read a partial.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdl.cuh"

namespace repro_split {

constexpr int kMergeThreads = 256;

// Pages [lo, hi) of a row that any of its T queries (positions start ..
// start + T - 1) can see: the liveness test of kernel.py (k_start < start +
// T and, with a window, k_start + ps - 1 >= start + 1 - window), capped at
// the table's n entries.
__host__ __device__ __forceinline__ void live_pages(int start, int T, int ps, int n, int window,
                                                    int& lo, int& hi) {
  const int last = (start + T - 1) / ps + 1, first = start + 1 - window;
  hi = last < n ? last : n;
  lo = window > 0 ? (first > 0 ? first : 0) / ps : 0;
}

// out[b, t, h, d] from the row's live splits, log-sum-exp merged.  The
// row's first query sits at starts[b] + start_bias (the paged decode kernel
// passes its lengths with bias -1), or at start_bias when starts is null
// (the dense decode kernel: pos - 1 for every row).
__global__ void __launch_bounds__(kMergeThreads)
paged_split_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         const int32_t* __restrict__ starts, int start_bias,
                         __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int D,
                         int ps, int n, int window, int pps, int n_splits, float scale_log2) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = T * group;
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= rows * D) return;
  const int rr = i / D, d = i % D;
  const int start = (starts != nullptr ? starts[b] : 0) + start_bias;
  int plo, phi;
  live_pages(start, T, ps, n, window, plo, phi);
  float M = -INFINITY, L = 0.f, A = 0.f;
  repro_pdl::wait_for_primary();               // pass 1's partials are written
  if (phi > plo) {
    const size_t base = static_cast<size_t>(b * Hkv + kvh) * n_splits;
    const int s_lo = plo / pps, s_hi = (phi - 1) / pps;
    for (int s = s_lo; s <= s_hi; ++s) M = fmaxf(M, part_ml[2 * ((base + s) * rows + rr)]);
    for (int s = s_lo; s <= s_hi; ++s) {
      const size_t r = (base + s) * rows + rr;
      // m is the split's max raw score; l = 0 for a split the row cannot see
      const float w = exp2f((part_ml[2 * r] - M) * scale_log2);
      L += part_ml[2 * r + 1] * w;
      A += part_acc[r * D + d] * w;
    }
  }
  const int t = rr / group, h = kvh * group + rr % group;
  out[((static_cast<size_t>(b) * T + t) * Hq + h) * D + d] =
      __float2bfloat16(A / fmaxf(L, 1e-30f));
}

inline cudaError_t launch_split_merge(const float* part_ml, const float* part_acc,
                                      const int32_t* starts, int start_bias, void* out, int B,
                                      int T, int Hq, int Hkv, int D, int ps, int n, int window,
                                      int pps, int n_splits, float scale_log2,
                                      cudaStream_t stream) {
  const int rows = T * (Hq / Hkv);
  const dim3 grid((rows * D + kMergeThreads - 1) / kMergeThreads, Hkv, B);
  return repro_pdl::launch_dependent(paged_split_merge_kernel, grid, dim3(kMergeThreads),
                                     stream, part_ml, part_acc, starts, start_bias,
                                     static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, D, ps, n,
                                     window, pps, n_splits, scale_log2);
}

}  // namespace repro_split
