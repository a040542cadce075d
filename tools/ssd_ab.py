"""Time one checkout's kernels of the ssm path against PyTorch's own calls on
the same inputs: the SSD intra-chunk kernel (f32) at the shapes phase 5c and
5e of ``chip_smoke.py`` give it and at a 2048-token prompt, and the bf16
dense decode-attention kernel at zamba2-2.7b's shared attention and
gemma3-4b's local layers.

    python3 tools/ssd_ab.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout of this repository (default: the one
this script lives in).  Its ``src/repro_torch`` is imported and its kernels
are built into its own ``build/``, so two commits compare on one card by
running the script once per tree on one machine, in the order A, B, B, A.
Every time is ``chip_smoke.timed_ms`` of this script's checkout (device
time, the L2 flushed before each call).  Each kernel is also held against
its plain version (SSD: 1e-5 of the output's largest magnitude; attention:
``chip_smoke.bf16_tol``).  The SSD kernel is timed beside two library
calls: scores per head from the expanded views (the JAX layout's work) and
scores once from the group tensors, broadcast over heads.  One line per
shape, then, as the last line, one JSON object of every time.  Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this checkout's timing helpers)

# (shape, b, nc, q, h, p, n): one group, Bh/Ch expand views over heads
SSD_SHAPES = (("nc 1", 1, 1, 256, 64, 64, 128), ("nc 2", 1, 2, 256, 64, 64, 128),
              ("nc 8", 1, 8, 256, 64, 64, 128), ("zamba2-2.7b", 4, 2, 256, 80, 64, 64))
# (shape, B, S, Hq, Hkv, D, pos, window)
DENSE_SHAPES = (("zamba2-2.7b", 8, 4096, 32, 32, 80, 3000, None),
                ("gemma3-4b local", 8, 4096, 8, 4, 256, 3000, 1024))


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
        print("ssd_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    if tree not in Path(repro_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_plain
    from repro_torch.kernels.ssd.ops import ssd_intra, ssd_intra_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    log = chip_smoke.log
    card = chip_smoke.card_line()
    label = args.label or tree.name
    log(f"[ab] {label}: {tree}; {card}; torch {torch.__version__}")
    build.build_all(("ssd_intra", "dense_decode_attention"))
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    timed = chip_smoke.timed_ms
    result = {"label": label, "card": card, "ssd_intra": {}, "dense_decode_attention": {}}

    for i, (shape, b, nc, q, h, p, n) in enumerate(SSD_SHAPES):
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 70 + i)
        xb = torch.randn((b, nc, q, h, p), generator=g, device=dev)
        dt = F.softplus(torch.randn((b, nc, q, h), generator=g, device=dev))
        acs = torch.cumsum(-torch.exp(0.3 * torch.randn((h,), generator=g, device=dev)) * dt, 2)
        Bq = torch.randn((b, nc, q, 1, n), generator=g, device=dev)
        Cq = torch.randn((b, nc, q, 1, n), generator=g, device=dev)
        Bh, Ch = Bq.expand(b, nc, q, h, n), Cq.expand(b, nc, q, h, n)
        ref = ssd_intra_plain(xb, acs, Bh, Ch)
        err = (ssd_intra(xb, acs, Bh, Ch) - ref).abs().max().item()
        if not err <= 1e-5 * ref.abs().max().item():
            raise AssertionError(f"ssd_intra {shape}: max |kernel - plain| {err}")
        tri = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
        a = acs.permute(0, 1, 3, 2)
        xt = xb.permute(0, 1, 3, 2, 4)

        def library(Bt, Ct):
            scores = torch.matmul(Ct.permute(0, 1, 3, 2, 4), Bt.permute(0, 1, 3, 4, 2))
            L = torch.where(tri, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
            return torch.matmul(scores * L, xt)

        ms = timed(lambda: ssd_intra(xb, acs, Bh, Ch), flush=flush)
        heads_ms = timed(lambda: library(Bh, Ch), flush=flush)
        group_ms = timed(lambda: library(Bq, Cq), flush=flush)
        log(f"[ab] ssd_intra {shape} (b {b}, nc {nc}, q {q}, {h} heads of {p}, n {n}, one "
            f"group): kernel {ms:.4f} ms, library per head {heads_ms:.4f} ms, per group "
            f"{group_ms:.4f} ms, kernel/library {ms / heads_ms:.3f} / {ms / group_ms:.3f} "
            f"(max |kernel - plain| {err:.2e})")
        result["ssd_intra"][shape] = {"ms": ms, "library_ms": group_ms,
                                      "library_per_head_ms": heads_ms}

    for i, (shape, B, S, Hq, Hkv, D, pos, window) in enumerate(DENSE_SHAPES):
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 80 + i)
        q, k, v = (torch.randn((B, s, hh, D), generator=g, device=dev).bfloat16()
                   for s, hh in ((1, Hq), (S, Hkv), (S, Hkv)))
        ref = decode_attention_plain(q, k, v, pos, window=window or -1)
        err = (decode_attention(q, k, v, pos, window=window).float() - ref.float()
               ).abs().max().item()
        if not err <= chip_smoke.bf16_tol(ref):
            raise AssertionError(f"dense_decode_attention {shape}: max |kernel - plain| {err}")
        lo = max(pos - window, 0) if window else 0
        qt, kt, vt = q.transpose(1, 2), k[:, lo:pos].transpose(1, 2), v[:, lo:pos].transpose(1, 2)
        ms = timed(lambda: decode_attention(q, k, v, pos, window=window), flush=flush)
        lib_ms = timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=Hq != Hkv),
                       flush=flush)
        log(f"[ab] dense_decode_attention {shape} (B {B}, S {S}, {Hq}/{Hkv} x {D}, pos {pos}, "
            f"window {window}): kernel {ms:.4f} ms, sdpa over the visible span {lib_ms:.4f} ms, "
            f"kernel/library {ms / lib_ms:.3f} (max |kernel - plain| {err:.2e})")
        result["dense_decode_attention"][shape] = {"ms": ms, "library_ms": lib_ms}

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
