// Warp-level bf16 tensor-core attention for Hopper (sm_90a): the pieces the
// bf16 instances of flash_attention.cu and paged_mixed_attention.cu share.
//
// One warp owns 16 query rows.  Scores S = Q K^T for a tile of KT keys are
// m16n8k16 bf16 MMAs with f32 accumulators; the online softmax runs on the
// accumulators in registers (each thread holds two rows, lane / 4 and
// lane / 4 + 8, and the row max and sum reduce over the 4 lanes that share a
// row); P is packed to bf16 in registers and is the A operand of O += P V
// with no shared-memory round trip.  Operands come from shared memory through
// ldmatrix (ldmatrix.trans for V).  Shared tiles are bf16 rows of D elements
// padded to LD = D + 8: the 16-byte pad shifts consecutive rows by four banks,
// so the eight row addresses of every ldmatrix phase hit distinct banks for
// each D here (16, 32, 64, 80, 128, 256).
//
// The running max m is kept in raw-score units and p = exp2(s * c - m * c)
// with c = sm_scale * log2(e), one FFMA and one ex2.approx a score.  Masked
// lanes get p = 0 explicitly, the running max starts at a finite -1e30 (so a
// row with no visible key yet never forms inf - inf), and the caller clamps
// l at 1e-30.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_mma {

constexpr float kNegInf = -1e30f;

// a padded shared row of D bf16: the 16-byte pad makes ldmatrix conflict-free
template <int D>
__host__ __device__ constexpr int ld_bf16() { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false the destination is
// zero-filled and the source is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4-byte global -> shared copy, zero-filled when pred is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {   // ex2.approx: exp2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's 16 query rows against key tiles of KT keys, head dim D; shared
// tiles have row stride LD.  QREG keeps the Q fragments in registers (loaded
// once); otherwise (D 256) they are read from shared memory each k-step.
template <int D, int KT, int LD, bool QREG>
struct WarpAttention {
  static_assert(D % 16 == 0 && KT % 16 == 0, "MMA tiles");
  static constexpr int NT = KT / 8;   // n8 tiles of scores
  static constexpr int ND = D / 8;    // n8 tiles of the output
  static constexpr int NK = D / 16;   // k-steps of Q K^T

  float o[ND][4];
  float m[2], l[2];                   // rows lane/4 and lane/4 + 8; m: max raw score
  uint32_t qf[QREG ? NK : 1][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < ND; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[t][i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // q: the warp's first row of Q in shared memory
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, int lane) {
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldmatrix_x4(qf[kk], q + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
  }

  // s = Q K^T (raw dot products) over the KT keys of the tile k
  __device__ __forceinline__ void scores(float (&s)[NT][4], const __nv_bfloat16* q,
                                         const __nv_bfloat16* k, int lane) const {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    const int krow = (lane % 8) + (lane / 16) * 8;
    const int kcol = ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, q + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, k + (jp * 16 + krow) * LD + kk * 16 + kcol);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }

  // Online-softmax update.  On return s holds p and o, l are rescaled;
  // p = exp2(s * scale_log2 - m * scale_log2), one FFMA and one ex2 a
  // score.  visible(h, j, e): whether key j * 8 + 2 * (lane % 4) + e of the
  // tile is visible to row lane / 4 + 8 h; tested only if MASKED, and a
  // masked lane gets p = 0 explicitly.
  template <bool MASKED, class Visible>
  __device__ __forceinline__ void softmax(float (&s)[NT][4], float scale_log2,
                                          const Visible& visible) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (MASKED && !visible(h, j, e)) s[j][2 * h + e] = -INFINITY;
          mx[h] = fmaxf(mx[h], s[j][2 * h + e]);
        }
    float neg_ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);                // finite: starts at -1e30
      const float alpha = fast_exp2((m[h] - m_new) * scale_log2);
      m[h] = m_new;
      neg_ms[h] = -m_new * scale_log2;
      l[h] *= alpha;
#pragma unroll
      for (int t = 0; t < ND; ++t) {
        o[t][2 * h] *= alpha;
        o[t][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = fast_exp2(fmaf(s[j][2 * h + e], scale_log2, neg_ms[h]));
          if (MASKED && !visible(h, j, e)) p = 0.f;          // explicit p = 0
          s[j][2 * h + e] = p;
          l[h] += p;          // this lane's share; the 4 lanes of a row sum in finish()
        }
  }

  // o += P V, P the probabilities left in s, v the tile's values
  __device__ __forceinline__ void pv(const float (&s)[NT][4], const __nv_bfloat16* v,
                                     int lane) {
    const int vrow = (lane % 8) + ((lane / 8) % 2) * 8;
    const int vcol = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v + (kk * 16 + vrow) * LD + dp * 16 + vcol);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // sums l over the 4 lanes of each row
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

}  // namespace repro_mma
