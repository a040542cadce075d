"""Time one checkout's bf16 attention and lm-head kernels against PyTorch's
own call on the same inputs, at the shapes the serving paths give them:
flash attention, paged mixed attention, paged decode attention and the
fused lm-head.

    python3 tools/attention_ab.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout of this repository (default: the one
this script lives in).  Its ``src/repro_torch`` is imported and its kernels
are built into its own ``build/``, so two commits compare on one card by
running the script once per tree on one machine, in the order A, B, B, A.
Every time is ``chip_smoke.timed_ms`` of this script's checkout (device
time, the L2 flushed before each call); each kernel is also held against
its plain version (bf16 attention: 2e-2; the lm-head: tokens equal on rows
with a clear top-1, logprob 1e-3).  A head dim or layout that the tree's
wrapper refuses is printed as such.  One line per shape, then, as the last
line, one JSON object of every time.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this checkout's timing and input helpers)

# (shape, B, S, Hq, Hkv, D): the bucketed prefill of each configuration
# whose prefill runs the flash kernel; full causal
FLASH_SHAPES = (("smollm-135m S512", 8, 512, 9, 3, 64),
                ("smollm-135m S1024", 8, 1024, 9, 3, 64),
                ("zamba2-2.7b", 4, 512, 32, 32, 80),
                ("qwen2.5-3b", 4, 512, 16, 2, 128),
                ("gemma3-4b", 2, 1024, 8, 4, 256))
# (shape, B, T, Hq, Hkv, D, ps, n, starts, window, pages): chunked-path
# verify / prefill spans over a paged pool
MIXED_SHAPES = (
    ("smollm-135m", 8, 16, 9, 3, 64, 16, 64, [0, 17, 130, 255, 511, 640, 893, 1000], -1,
     "bfloat16"),
    ("smollm-135m int8", 8, 16, 9, 3, 64, 16, 64, [0, 17, 130, 255, 511, 640, 893, 1000], -1,
     "int8"),
    ("qwen2.5-3b", 8, 16, 16, 2, 128, 16, 64, [0, 17, 130, 255, 511, 640, 893, 1000], -1,
     "bfloat16"),
    ("qwen2.5-3b chunk 32", 8, 32, 16, 2, 128, 16, 64, [0, 17, 130, 255, 511, 640, 893, 992],
     -1, "bfloat16"),
    ("gemma3-4b local", 8, 16, 8, 4, 256, 16, 128, [0, 17, 130, 255, 1100, 1500, 1893, 2000],
     1024, "bfloat16"))


# (shape, B, Hq, Hkv, D, ps, n, lengths, window, pages): the bucketed
# path's decode step over a paged pool, one query a row
DECODE_SHAPES = (
    ("smollm-135m", 8, 9, 3, 64, 16, 64, chip_smoke.DECODE_LENGTHS, -1, "bfloat16"),
    ("smollm-135m int8", 8, 9, 3, 64, 16, 64, chip_smoke.DECODE_LENGTHS, -1, "int8"),
    ("qwen2.5-3b", 8, 16, 2, 128, 16, 64, chip_smoke.DECODE_LENGTHS, -1, "bfloat16"),
    ("gemma3-4b local", 8, 8, 4, 256, 16, 128, [64, 300, 1024, 1025, 1500, 1893, 2000, 2048],
     1024, "bfloat16"))
# (shape, N, d, V, tied): the chunked path's verify step (N = 8 rows x 16
# span positions; 256 = 8 x 32-token chunks) through each config's head
LMHEAD_SHAPES = (("smollm-135m tied N 128", 128, 576, 49152, True),
                 ("qwen2.5-3b untied N 128", 128, 2048, 151936, False),
                 ("qwen2.5-3b untied N 256", 256, 2048, 151936, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE / "src"]
    sys.path.insert(0, str(tree / "src"))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    if tree not in Path(repro_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_mixed, decode_attention_paged, paged_decode_attention_plain,
        paged_mixed_attention_plain)
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, lmhead_greedy_plain
    from repro_torch.serving.kvcache import _span_mask, _vector_mask, paged_gather

    log = chip_smoke.log
    card = chip_smoke.card_line()
    label = args.label or tree.name
    log(f"[ab] {label}: {tree}; {card}; torch {torch.__version__}")
    build.build_all(("flash_attention", "paged_mixed_attention", "paged_decode_attention",
                     "lmhead_greedy"))
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    timed = chip_smoke.timed_ms
    result = {"label": label, "card": card, "flash_attention": {}, "paged_mixed_attention": {},
              "paged_decode_attention": {}, "lmhead_greedy": {}}

    for i, (shape, B, S, Hq, Hkv, D) in enumerate(FLASH_SHAPES):
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 30 + i)
        q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).bfloat16()
                   for h in (Hq, Hkv, Hkv))
        try:
            out = flash_attention_dyn(q, k, v, -1)
        except ValueError as exc:
            log(f"[ab] flash_attention {shape}: refused ({exc})")
            result["flash_attention"][shape] = None
            continue
        err = (out.float() - flash_attention_plain(q, k, v, -1).float()).abs().max().item()
        if not err <= 2e-2:
            raise AssertionError(f"flash_attention {shape}: max |kernel - plain| {err}")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = timed(lambda: flash_attention_dyn(q, k, v, -1), flush=flush)
        lib_ms = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush)
        log(f"[ab] flash_attention {shape} (B {B}, S {S}, {Hq}/{Hkv} x {D}): kernel "
            f"{ms:.4f} ms, sdpa {lib_ms:.4f} ms, kernel/library {ms / lib_ms:.3f} "
            f"(max |kernel - plain| {err:.2e})")
        result["flash_attention"][shape] = {"ms": ms, "library_ms": lib_ms}

    def gathered(kp, vp, tbl, sc):             # sdpa reads the dequantized pages
        if sc:
            kd = (paged_gather(kp, tbl).float() * paged_gather(sc["k_scale"], tbl)).bfloat16()
            vd = (paged_gather(vp, tbl).float() * paged_gather(sc["v_scale"], tbl)).bfloat16()
        else:
            kd, vd = paged_gather(kp, tbl), paged_gather(vp, tbl)
        return kd.transpose(1, 2), vd.transpose(1, 2)          # (B, Hkv, S, D)

    for i, (shape, B, T, Hq, Hkv, D, ps, n, starts, window, kind) in enumerate(MIXED_SHAPES):
        variants, tbl, st, _ = chip_smoke.paged_inputs(dev, B, T, Hq, Hkv, D, ps, n, starts,
                                                       chip_smoke.SEED + 40 + i)
        q, kp, vp, sc = variants[kind]
        call = (q, kp, vp, tbl, st)
        out = decode_attention_mixed(*call, window=window, **sc)
        ref = paged_mixed_attention_plain(*call, window=window, **sc)
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= 2e-2:
            raise AssertionError(f"paged_mixed_attention {shape}: max |kernel - plain| {err}")
        kd, vd = gathered(kp, vp, tbl, sc)
        mask = _span_mask(n * ps, st, T, window)[:, None]          # (B, 1, T, S)
        qt = q.transpose(1, 2)
        ms = timed(lambda: decode_attention_mixed(*call, window=window, **sc), flush=flush)
        lib_ms = timed(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, enable_gqa=True), flush=flush)
        log(f"[ab] paged_mixed_attention {shape} (B {B}, T {T}, {Hq}/{Hkv} x {D}, {kind} "
            f"pages, window {window}): kernel {ms:.4f} ms, sdpa over gathered pages "
            f"{lib_ms:.4f} ms, kernel/library {ms / lib_ms:.3f} (max |kernel - plain| "
            f"{err:.2e})")
        result["paged_mixed_attention"][shape] = {"ms": ms, "library_ms": lib_ms}

    for i, (shape, B, Hq, Hkv, D, ps, n, lengths, window, kind) in enumerate(DECODE_SHAPES):
        variants, tbl, lens, _ = chip_smoke.decode_inputs(dev, B, Hq, Hkv, D, ps, n, lengths,
                                                          chip_smoke.SEED + 50 + i)
        q, kp, vp, sc = variants[kind]
        call = (q, kp, vp, tbl, lens)
        out = decode_attention_paged(*call, window=window, **sc)
        err = (out.float() - paged_decode_attention_plain(*call, window=window, **sc).float()
               ).abs().max().item()
        if not err <= 2e-2:
            raise AssertionError(f"paged_decode_attention {shape}: max |kernel - plain| {err}")
        kd, vd = gathered(kp, vp, tbl, sc)
        mask = _vector_mask(n * ps, lens - 1, window)[:, None]  # (B, 1, 1, S)
        qt = q.transpose(1, 2)
        ms = timed(lambda: decode_attention_paged(*call, window=window, **sc), flush=flush)
        lib_ms = timed(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, enable_gqa=True), flush=flush)
        log(f"[ab] paged_decode_attention {shape} (B {B}, {Hq}/{Hkv} x {D}, {kind} pages, "
            f"window {window}): kernel {ms:.4f} ms, sdpa over gathered pages {lib_ms:.4f} ms, "
            f"kernel/library {ms / lib_ms:.3f} (max |kernel - plain| {err:.2e})")
        result["paged_decode_attention"][shape] = {"ms": ms, "library_ms": lib_ms}

    for i, (shape, N, d, V, tied) in enumerate(LMHEAD_SHAPES):
        h, w = chip_smoke.lmhead_case(dev, N, d, V, tied=tied, seed=chip_smoke.SEED + 60 + i)
        try:
            tok, lp = fused_lmhead_greedy(h, w)
        except ValueError as exc:
            log(f"[ab] lmhead_greedy {shape}: refused ({exc})")
            result["lmhead_greedy"][shape] = None
            continue
        tok_p, lp_p = lmhead_greedy_plain(h, w)
        top2 = (h.float() @ w.float()).topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4
        lp_err = (lp - lp_p).abs().max().item()
        if not (torch.equal(tok[clear], tok_p[clear]) and lp_err <= 1e-3):
            raise AssertionError(f"lmhead_greedy {shape}: tokens differ or |lp - plain| {lp_err}")

        def lib():
            x = torch.matmul(h, w)
            return x.max(dim=-1), torch.logsumexp(x.float(), dim=-1)

        ms = timed(lambda: fused_lmhead_greedy(h, w), flush=flush)
        lib_ms = timed(lib, flush=flush)
        b_ms, _ = chip_smoke.bound_ms(V * d * 2 + N * d * 2 + N * 8, 2.0 * N * d * V)
        log(f"[ab] lmhead_greedy {shape} (N {N}, d {d}, V {V}, "
            f"{'tied' if tied else 'untied'}): kernel {ms:.4f} ms, matmul+max+logsumexp "
            f"{lib_ms:.4f} ms, kernel/library {ms / lib_ms:.3f}, bound {b_ms:.4f} ms, "
            f"kernel/bound {ms / b_ms:.2f} (max |lp - plain| {lp_err:.2e})")
        result["lmhead_greedy"][shape] = {"ms": ms, "library_ms": lib_ms, "bound_ms": b_ms}

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
