"""Run ``chip_smoke.py``'s phases 10 and 11 alone: training on the card.

    python3 tools/train_phase.py [--parts a,b,c,d,11]

10a: the smoke configs of smollm-135m, mamba2-1.3b and whisper-small at
float32, card against CPU (one step's loss and gradients, a 5-step curve);
10b: smollm-135m ``CONFIG`` trained 30 steps at B 8 x S 512 with a
train-state checkpoint after step 15, resumed from it in the same process;
10c: qwen2.5-3b ``CONFIG`` 3 steps, mamba2-1.3b ``CONFIG`` 2 steps; 10d:
whisper-small ``CONFIG`` prefill, 16 decode steps and one train step;
11: the sharded train step on a one-rank NCCL mesh (qwen2.5-3b at full
width, 4 of 36 layers), ``restore_resharded``, compression, a
provisioning delay, and the parameters restored onto a (2, 4) mesh as one
rank under the fake backend.  Each part prints what ``chip_smoke.py`` prints for it and fails as it
fails: no kernel may launch during a train step.  The card's name and
power limit come first.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this checkout's phase 10 and helpers)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="a,b,c,d,11")
    parts = set(ap.parse_args().parts.split(","))
    import torch
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_mixed, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, greedy_epilogue
    from repro_torch.kernels.ssd.ops import ssd_intra
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda")
    counters = (flash_attention_dyn, decode_attention_mixed, decode_attention_paged,
                decode_attention, greedy_epilogue, fused_lmhead_greedy, ssd_intra)
    t0 = time.perf_counter()
    if "a" in parts:
        chip_smoke.train_references(dev, counters)
    if "b" in parts:
        with tempfile.TemporaryDirectory(prefix="train-") as tmp:
            chip_smoke.train_full(dev, counters, tmp)
    if "c" in parts:
        chip_smoke.train_wide(dev, counters)
    if "d" in parts:
        chip_smoke.whisper_full(dev, counters)
    if "11" in parts:
        with tempfile.TemporaryDirectory(prefix="sharded-") as tmp:
            chip_smoke.sharded_train(dev, counters, tmp)
    chip_smoke.log(f"[train] parts {sorted(parts)} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
