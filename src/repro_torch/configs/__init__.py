"""Architecture registry of the port: the dense, moe and vlm archs the
paged paths serve and the ssm/hybrid archs of the dense-cache path.

``get_config(arch_id)`` -> full ModelConfig (exact published sizes)
``get_smoke_config(arch_id)`` -> reduced same-family config for CPU tests
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = ["smollm-135m", "smollm-360m", "gemma3-4b", "qwen2.5-3b", "olmoe-1b-7b",
         "mixtral-8x22b", "pixtral-12b", "mamba2-1.3b", "zamba2-2.7b"]


def _mod(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported yet; ported: "
                         f"{', '.join(ARCHS)} (see ROADMAP.md Queue 1)")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


__all__ = ["ARCHS", "get_config", "get_smoke_config"]
