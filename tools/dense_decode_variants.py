"""Where the bf16 dense decode-attention kernel's time goes: time patched
copies of ``csrc/dense_decode_attention.cu`` and plain read kernels of the
same bytes on one card.

    python3 tools/dense_decode_variants.py

Variants of the production source, built with ``nvcc`` into
``build/dense_decode_variants/`` and called through its C entry point:

* ``base``: the production kernel, at the split the wrapper picks and at
  1, 2, 4 and 8 pages of 64 keys a split;
* ``no_merge``: pass 1 alone, without the merge pass.

Plain read kernels of the visible K and V (no attention), at 6 to 48
splits a row: ``strided`` gives each block one (row, kv head, split), a
key's D over the next power of two of D / 8 lanes, 16-byte loads, as the
kernel reads; ``contiguous`` gives each block a run of whole key rows (all
kv heads), every lane busy.

Times are ``chip_smoke.timed_ms`` (device time, L2 flushed before each
call) at zamba2-2.7b's shared attention (B 8, S 4096, 32 / 32 heads of 80,
pos 3000) and gemma3-4b's local layers (8 / 4 heads of 256, window 1024),
with the bytes read over the time.  Only ``base`` is checked (against the
plain version, ``chip_smoke.bf16_tol``).  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import variant_build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (timing helpers; puts src/ on the path)

PATCHES = {"no_merge": (
    "  // pass 2, the paged kernels' merge: every row's query at pos - 1\n  return repro_split",
    "  return cudaSuccess;\n  return repro_split")}
SHAPES = (("zamba2-2.7b", 8, 4096, 32, 32, 80, 3000, -1),
          ("gemma3-4b local", 8, 4096, 8, 4, 256, 3000, 1024))
READS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }
// one block per (row, kv head, split): the kernel's mapping
template <int D>
__global__ void strided(const uint4* k, const uint4* v, unsigned* sink, int S, int H, int lo,
                        int hi, int keys) {
  constexpr int CH = D / 8, LPK = pow2_ceil(CH), KPW = 32 / LPK, KPB = 4 * KPW;
  const int b = blockIdx.x, h = blockIdx.y, k0 = lo + blockIdx.z * keys;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, c = lane % LPK;
  const int k1 = min(k0 + keys, hi);
  unsigned acc = 0;
  if (c < CH)
    for (int kb = k0; kb < k1; kb += 4 * KPB) {
      uint4 r[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = kb + u * KPB + warp * KPW + lane / LPK;
        const size_t off = ((size_t)(b * S + key) * H + h) * CH + c;
        r[2 * u] = key < k1 ? __ldg(k + off) : make_uint4(0, 0, 0, 0);
        r[2 * u + 1] = key < k1 ? __ldg(v + off) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc ^= r[u].x ^ r[u].y ^ r[u].z ^ r[u].w;
    }
  if (acc == 0x9e3779b9u) sink[0] = acc;
}
// one block per (row, run of keys): whole key rows, every lane busy
__global__ void contiguous(const uint4* k, const uint4* v, unsigned* sink, int S, int row,
                           int lo, int hi, int keys) {
  const int b = blockIdx.x, k0 = lo + blockIdx.y * keys, k1 = min(k0 + keys, hi);
  if (k1 <= k0) return;
  const size_t base = ((size_t)b * S + k0) * row, n = (size_t)(k1 - k0) * row;
  unsigned acc = 0;
  for (size_t i = threadIdx.x; i < n; i += 4 * blockDim.x) {
    uint4 r[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t j = i + u * blockDim.x;
      r[2 * u] = j < n ? __ldg(k + base + j) : make_uint4(0, 0, 0, 0);
      r[2 * u + 1] = j < n ? __ldg(v + base + j) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc ^= r[u].x ^ r[u].y ^ r[u].z ^ r[u].w;
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;
}
extern "C" int read_kv(int contig, const void* k, const void* v, unsigned* sink, int B, int S,
                       int H, int D, int lo, int hi, int splits, void* stream) {
  const int keys = (hi - lo + splits - 1) / splits;
  cudaStream_t st = (cudaStream_t)stream;
  const uint4* kk = (const uint4*)k;
  const uint4* vv = (const uint4*)v;
  if (contig) contiguous<<<dim3(B, splits), 256, 0, st>>>(kk, vv, sink, S, H * D / 8, lo, hi, keys);
  else if (D == 80) strided<80><<<dim3(B, H, splits), 128, 0, st>>>(kk, vv, sink, S, H, lo, hi, keys);
  else if (D == 256) strided<256><<<dim3(B, H, splits), 128, 0, st>>>(kk, vv, sink, S, H, lo, hi, keys);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""


def build() -> dict:
    """nvcc of every variant and of the read kernels at once; name -> library."""
    sources = {"base": variant_build.patched("dense_decode_attention", (), "base")}
    for name, patch in PATCHES.items():
        sources[name] = variant_build.patched("dense_decode_attention", (patch,), name)
    sources["reads"] = READS
    return variant_build.build("dense_decode_variants", sources)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dense_decode_variants: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention.ops import (
        _dense_span, _sm_count, choose_dense_pages_per_split, decode_attention_plain)

    log = chip_smoke.log
    log(f"[variants] {chip_smoke.card_line()}; torch {torch.__version__}")
    libs = build()
    for lib in libs.values():
        if hasattr(lib, "dense_decode_attention"):
            f = lib.dense_decode_attention
            f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            f.restype = ctypes.c_int
    reads = libs["reads"].read_kv
    reads.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    reads.restype = ctypes.c_int
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    timed = chip_smoke.timed_ms

    for i, (shape, B, S, Hq, Hkv, D, pos, window) in enumerate(SHAPES):
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 90 + i)
        q, k, v = (torch.randn((B, s, h, D), generator=g, device=dev).bfloat16()
                   for s, h in ((1, Hq), (S, Hkv), (S, Hkv)))
        lo, hi = _dense_span(S, pos, window)
        mb = 2 * B * (hi - lo) * Hkv * D * 2 / 1e6
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        chosen = choose_dense_pages_per_split(B, Hkv, S, pos, window, _sm_count(0))
        ref = decode_attention_plain(q, k, v, pos, window=window)
        n_pages = -(-S // 64)
        for pps in sorted({chosen, 1, 2, 4, 8}):
            n_splits = -(-n_pages // pps)
            part_ml = torch.empty((B, Hkv, n_splits, Hq // Hkv, 2), device=dev)
            part_acc = torch.empty((B, Hkv, n_splits, Hq // Hkv, D), device=dev)
            for name in ("base", "no_merge"):
                fn = libs[name].dense_decode_attention

                def call():
                    # replint-torch: disable=KRN201 -- harness: its own inputs, no autograd
                    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             part_ml.data_ptr(), part_acc.data_ptr(), B, S, Hq, Hkv, D, pos,
                             window, D ** -0.5, pps, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                call()
                if name == "base":
                    err = (out.float() - ref.float()).abs().max().item()
                    if not err <= chip_smoke.bf16_tol(ref):
                        raise AssertionError(f"{shape} pps {pps}: max |kernel - plain| {err}")
                ms = timed(call, flush=flush)
                log(f"[variants] dense {shape} {name:8s} pages a split {pps}"
                    f"{' (the plan)' if pps == chosen else ''}: {ms:.4f} ms, "
                    f"{mb / ms / 1e3:.2f} TB/s over {mb:.2f} MB")
        for contig, splits in ((0, 6), (0, 12), (0, 24), (0, 48), (1, 48), (1, 96), (1, 192)):
            # replint-torch: disable=KRN201 -- harness: its own inputs, no autograd
            ms = timed(lambda: reads(contig, k.data_ptr(), v.data_ptr(), sink.data_ptr(), B, S,
                                     Hkv, D, lo, hi, splits, stream), flush=flush)
            log(f"[variants] read {shape} {'contiguous' if contig else 'strided'} "
                f"{splits} splits a row: {ms:.4f} ms, {mb / ms / 1e3:.2f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
