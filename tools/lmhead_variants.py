"""Where the bf16 lm-head kernel's time goes: time patched copies of
``csrc/lmhead_greedy.cu`` beside the production source on one card.

    python3 tools/lmhead_variants.py

Each variant is the production source with one part of the persistent
walk switched off by a text patch, built with ``nvcc`` into
``build/lmhead_variants/`` and called through its C entry point:

* ``base``: the production kernel;
* ``loads_only``: no MMA and no per-tile epilogue (the compiler then drops
  the fragment loads too): the cp.async stream of w (and h) alone;
* ``compute_only``: no stage after the prologue is loaded; the MMAs and
  the epilogue run on whatever the ring holds.

Times are ``chip_smoke.timed_ms`` (device time, L2 flushed before each
call) at smollm-135m's tied head (128 x 576 x 49152) and qwen2.5-3b's
untied one (128 and 256 x 2048 x 151936), beside ``torch.matmul`` alone
and one read of the weight.  The variants compute wrong results by
design; only ``base`` is checked (tokens against the plain version).
Other variants (a ring depth, a tile shape) are one more entry in
``PATCHES`` and ``VARIANTS``.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import variant_build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (timing and input helpers; puts src/ on the path)

PATCHES = {
    "no_mma": ("      if (warp_live) {\n#pragma unroll\n        for (int jp = 0; jp < 4; ++jp)",
               "      if (warp_live && lane > 99) {\n#pragma unroll\n        for (int jp = 0; jp < 4; ++jp)"),
    "no_epi": ("if (t % nk == nk - 1 && warp_live) {",
               "if (t % nk == nk - 1 && warp_live && lane > 99) {"),
    "no_load": ("if (t + S < total) load_stage(t + S);",
                "if (t + S < total && tid > 9999) load_stage(t + S);"),
}
VARIANTS = {"base": (), "loads_only": ("no_mma", "no_epi"), "compute_only": ("no_load",)}
SHAPES = (("smollm-135m tied", 128, 576, 49152, True),
          ("qwen2.5-3b untied N 128", 128, 2048, 151936, False),
          ("qwen2.5-3b untied N 256", 256, 2048, 151936, False))


def build() -> dict:
    """nvcc of every variant at once; name -> the lmhead_greedy entry and
    lmhead_partial_cols of its library."""
    libs = variant_build.build("lmhead_variants", {
        name: variant_build.patched("lmhead_greedy", [PATCHES[p] for p in patches], name)
        for name, patches in VARIANTS.items()})
    out = {}
    for name, lib in libs.items():
        fn = lib.lmhead_greedy
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        lib.lmhead_partial_cols.argtypes = [ctypes.c_int] * 4
        lib.lmhead_partial_cols.restype = ctypes.c_int
        out[name] = (fn, lib.lmhead_partial_cols)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lmhead_variants: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.sampling.ops import lmhead_greedy_plain
    libs = build()
    log = chip_smoke.log
    log(f"[variants] {chip_smoke.card_line()}; torch {torch.__version__}")
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (shape, N, d, V, tied) in enumerate(SHAPES):
        h, w = chip_smoke.lmhead_case(dev, N, d, V, tied=tied, seed=chip_smoke.SEED + 70 + i)
        stream = torch.cuda.current_stream().cuda_stream
        for name, (fn, partial_cols) in libs.items():
            cols = partial_cols(1, N, V, sm)
            f32 = dict(dtype=torch.float32, device=dev)
            pm, ps = torch.empty((N, cols), **f32), torch.empty((N, cols), **f32)
            pi = torch.empty((N, cols), dtype=torch.int32, device=dev)
            tok = torch.empty(N, dtype=torch.int32, device=dev)
            lp = torch.empty(N, **f32)

            def call():
                # replint-torch: disable=KRN201 -- harness: its own inputs, no autograd
                err = fn(1, h.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1), N, d, V, cols,
                         pm.data_ptr(), ps.data_ptr(), pi.data_ptr(), tok.data_ptr(),
                         lp.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            if name == "base":
                tok_p, _ = lmhead_greedy_plain(h, w)
                if (tok != tok_p).float().mean() > 0.1:
                    raise AssertionError(f"base {shape}: tokens differ from the plain version")
            ms = chip_smoke.timed_ms(call, flush=flush)
            log(f"[variants] {shape} {name}: {ms:.4f} ms ({2 * N * d * V / ms / 1e9:.0f} TFLOP/s, "
                f"{V * d * 2 / ms / 1e9:.2f} TB/s of w)")
        mm = chip_smoke.timed_ms(lambda: torch.matmul(h, w), flush=flush)
        rd = chip_smoke.timed_ms(lambda: w.sum(dtype=torch.float32), flush=flush)
        log(f"[variants] {shape}: torch.matmul alone {mm:.4f} ms; one read of w (sum) "
            f"{rd:.4f} ms ({V * d * 2 / rd / 1e9:.2f} TB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
