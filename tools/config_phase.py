"""Run ``chip_smoke.py``'s phase 15 alone: the configurations the card had
not served.

    python3 tools/config_phase.py [--parts kernels,a,b,c,d,e]

``kernels`` is phase 3's check and timing of the kernels at gemma3-4b's
shapes (``chip_smoke.check_gemma_kernels``); ``a`` .. ``e`` are 15a-15e as
``chip_smoke.configs_phase`` runs them, which prints and fails as the whole
run does.  The card's name and power limit come first.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (this checkout's phase 15 and helpers)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="kernels," + ",".join(chip_smoke.PHASE15_PARTS))
    parts = ap.parse_args().parts.split(",")
    import torch
    if not torch.cuda.is_available():
        print("config_phase: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all()                      # one nvcc a source, all at once
    chip_smoke.log(f"[build] {len(build.SOURCES)} libraries in {time.perf_counter() - t0:.1f} s")
    if "kernels" in parts:
        scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        for rec in chip_smoke.check_gemma_kernels(dev, scratch.zero_):
            chip_smoke.log(f"[record] {rec}")
        del scratch
    chip_smoke.configs_phase(dev, parts=[p for p in chip_smoke.PHASE15_PARTS if p in parts])
    return 0


if __name__ == "__main__":
    sys.exit(main())
