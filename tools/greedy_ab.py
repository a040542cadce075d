"""Time one checkout's greedy-epilogue kernel at every ported config's
vocabulary, and its lm-head kernel at smollm-135m's shape, on one card.

    python3 tools/greedy_ab.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout of this repository (default: the one
this script lives in).  Its ``src/repro_torch`` is imported and its kernels
are built into its own ``build/``, so two commits compare on one card by
running the script once per tree on one machine, in the order A, B, B, A.
Timing helpers are this script's checkout's ``chip_smoke``: ``timed_ms``
with the L2 flushed before each call, and ``timed_after_ms`` warm, right
after the ``torch.matmul`` that writes the logits (the serving order).

For each vocabulary (smollm-135m 49152, mamba2-1.3b 50280, zamba2-2.7b
32000, qwen2.5-3b 151936, gemma3-4b 262144) at B 8 and 1: the kernel
against its plain version (tokens equal, logprob within 1e-4), flushed and
warm times, and each kernel's span in the profiler's trace with the gap
between consecutive kernels of one call (``chip_smoke.device_us``: a
two-pass epilogue shows both passes).  f32 always, bf16 where the tree's
wrapper takes it.  The fused lm-head (bf16, 128 x 576 x 49152 tied) is
timed flushed, five times over.  One line per case, then, as the last
line, one JSON object of every time.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this checkout's timing helpers)

LMHEAD_SHAPE = (128, 576, 49152)       # smollm-135m's verify step, tied head
LMHEAD_REPEATS = 5                     # means of 20 calls each, one after another


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE / "src"]
    sys.path.insert(0, str(tree / "src"))

    import torch
    if not torch.cuda.is_available():
        print("greedy_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    if tree not in Path(repro_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.kernels import build
    from repro_torch.kernels.sampling import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    log = chip_smoke.log
    card = chip_smoke.card_line()
    label = args.label or tree.name
    log(f"[ab] {label}: {tree}; {card}; torch {torch.__version__}")
    build.build_all(tuple(n for n in build.SOURCES if n in ("lmhead_greedy", "greedy_epilogue")))
    dev = torch.device("cuda")
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    timed = chip_smoke.timed_ms
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 90)
    result = {"label": label, "card": card, "greedy_epilogue": {}}

    dtypes = [torch.float32]
    try:
        ops.greedy_epilogue(torch.zeros((1, 64), dtype=torch.bfloat16, device=dev))
        dtypes.append(torch.bfloat16)
    except TypeError:
        log(f"[ab] {label}: greedy_epilogue refuses bf16 logits; f32 only")

    for name, V, d in chip_smoke.GREEDY_VOCABS:
        for dt in dtypes:
            w = (torch.randn((d, V), generator=g, device=dev) * d ** -0.5).to(dt)
            for B in (8, 1):
                x = (torch.randn((B, V), generator=g, device=dev) * 3.0).to(dt)
                tok, lp = ops.greedy_epilogue(x)
                tok_p, lp_p = ops.greedy_epilogue_plain(x)
                err = (lp - lp_p).abs().max().item()
                if not (torch.equal(tok, tok_p) and err <= 1e-4):
                    raise AssertionError(f"greedy_epilogue {name} B {B} {dt}: max |lp - plain| "
                                         f"{err}")
                h = torch.randn((B, d), generator=g, device=dev).to(dt)
                ms = timed(lambda: ops.greedy_epilogue(x), flush=flush)
                warm = chip_smoke.timed_after_ms(lambda: torch.matmul(h, w, out=x),
                                                 lambda: ops.greedy_epilogue(x))
                spans = chip_smoke.device_us(lambda: ops.greedy_epilogue(x), flush=flush)
                bound, _ = chip_smoke.bound_ms(x.numel() * x.element_size() + B * 8, 0.0)
                key = f"{name} ({B}, {V}) {str(dt).split('.')[-1]}"
                log(f"[ab] greedy_epilogue {key}: flushed {ms:.4f} ms, warm after the matmul "
                    f"{warm:.4f} ms, bound {bound:.5f} ms (flushed/bound {ms / bound:.1f}); "
                    f"spans: {spans}")
                result["greedy_epilogue"][key] = {"ms": ms, "warm_ms": warm, "bound_ms": bound,
                                                  "spans": spans}
            del w

    N, dm, V = LMHEAD_SHAPE
    h, w = chip_smoke.lmhead_case(dev, N, dm, V)
    lm_ms = [timed(lambda: ops.fused_lmhead_greedy(h, w), flush=flush)
             for _ in range(LMHEAD_REPEATS)]
    log(f"[ab] lmhead_greedy bf16 {N} x {dm} x {V} tied: "
        + ", ".join(f"{t:.4f}" for t in lm_ms) + " ms")
    result["lmhead_greedy"] = lm_ms

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
