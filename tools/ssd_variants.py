"""Tile heights and ring depths of the SSD intra-chunk kernel: time patched
copies of ``csrc/ssd_intra.cu`` beside the production source on one card.

    python3 tools/ssd_variants.py

Each variant is the production source with its tile constants replaced by
a text patch, built with ``nvcc`` into ``build/ssd_variants/`` and called
through its C entry point:

* ``base``: the production kernel (pass 2: 32-row t-tiles, 32-key u
  slices; pass 1: a ring of four n slices);
* ``t64_u64``: pass 2 on 64-row t-tiles and 64-key u slices (256-thread
  blocks, the first version of this design);
* ``t64_u32``: 64-row t-tiles, 32-key u slices;
* ``ring2``: pass 1 with two n slices in flight instead of four.

Every variant computes the same sums in the same order, so each is held
to its output bit for bit against ``base`` and to the plain version at
1e-5 of the output's largest magnitude.  Times are ``chip_smoke.timed_ms``
(device time, L2 flushed before each call) at the shapes of
``chip_smoke.py`` phase 3 (nc 1, 2 and 8 of mamba2-1.3b, one group;
zamba2-2.7b's b 4, nc 2, 80 heads, state 64), in the order base, variants,
variants reversed, base.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import variant_build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (timing helpers; puts src/ on the path)

T64 = ("constexpr int kTT = 32;", "constexpr int kTT = 64;")
U64 = ("constexpr int kUS = 32;", "constexpr int kUS = 64;")
VARIANTS = {"base": (), "t64_u64": (T64, U64), "t64_u32": (T64,),
            "ring2": (("constexpr int kStages = 4;", "constexpr int kStages = 2;"),)}
SHAPES = (("nc 1", 1, 1, 256, 64, 64, 128), ("nc 2", 1, 2, 256, 64, 64, 128),
          ("nc 8", 1, 8, 256, 64, 64, 128), ("zamba2-2.7b", 4, 2, 256, 80, 64, 64))


def build() -> dict:
    """nvcc of every variant at once; name -> its ssd_intra entry."""
    libs = variant_build.build("ssd_variants", {
        name: variant_build.patched("ssd_intra", patches, name)
        for name, patches in VARIANTS.items()})
    fns = {}
    for name, lib in libs.items():
        fn = lib.ssd_intra
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd.ops import ssd_intra_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    log = chip_smoke.log
    log(f"[variants] {chip_smoke.card_line()}; torch {torch.__version__}")
    fns = build()
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    order = list(fns) + list(fns)[::-1]
    for i, (shape, b, nc, q, h, p, n) in enumerate(SHAPES):
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 100 + i)
        bc = b * nc
        xb = torch.randn((bc, q, h, p), generator=g, device=dev)
        dt = torch.nn.functional.softplus(torch.randn((bc, q, h), generator=g, device=dev))
        acs = torch.cumsum(-torch.exp(0.3 * torch.randn((h,), generator=g, device=dev)) * dt, 1)
        Bg = torch.randn((bc, q, 1, n), generator=g, device=dev)
        Cg = torch.randn((bc, q, 1, n), generator=g, device=dev)
        ref = ssd_intra_plain(*(t[None] for t in (xb, acs)), Bg[None].expand(1, bc, q, h, n),
                              Cg[None].expand(1, bc, q, h, n))[0]
        y = torch.empty_like(xb)
        scores = torch.empty((bc, 1, q, q), device=dev)
        strides = (ctypes.c_longlong * 12)(*Bg.stride()[:3], *Cg.stride()[:3],
                                           *xb.stride()[:3], *acs.stride())
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            # replint-torch: disable=KRN201 -- harness: its own inputs, no autograd
            err = fn(xb.data_ptr(), acs.data_ptr(), Bg.data_ptr(), Cg.data_ptr(), y.data_ptr(),
                     scores.data_ptr(), ctypes.addressof(strides), bc, q, h, p, n, 1, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        base = None
        times = {}
        for name in order:
            call(fns[name])
            torch.cuda.synchronize()
            if base is None:
                base = y.clone()
                err = (y - ref).abs().max().item()
                if not err <= 1e-5 * ref.abs().max().item():
                    raise AssertionError(f"ssd_intra {shape}: max |kernel - plain| {err}")
            elif not torch.equal(y, base):
                raise AssertionError(f"ssd_intra {shape} {name}: not bit-equal to base")
            times.setdefault(name, []).append(
                chip_smoke.timed_ms(lambda: call(fns[name]), flush=flush))
        log(f"[variants] ssd_intra {shape} (bc {bc}, q {q}, {h} heads of {p}, n {n}): "
            + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
