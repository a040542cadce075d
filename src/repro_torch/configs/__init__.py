"""Architecture registry of the port: every arch of the JAX package -- the
dense, moe and vlm archs the paged paths serve, the ssm/hybrid archs of the
dense-cache path, and whisper-small (audio), which runs at model level.

``get_config(arch_id)`` -> full ModelConfig (exact published sizes)
``get_smoke_config(arch_id)`` -> reduced same-family config for CPU tests
``SHAPES`` -> the four assigned input-shape sets
``input_specs(cfg, shape)`` -> meta-tensor stand-ins for every model input
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig

# the JAX package's order, so that ``launch.dryrun --all`` walks the cells alike
ARCHS = [
    "zamba2-2.7b", "smollm-360m", "smollm-135m", "gemma3-4b", "qwen2.5-3b",
    "olmoe-1b-7b", "mixtral-8x22b", "whisper-small", "mamba2-1.3b", "pixtral-12b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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


def shape_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Is (arch x shape) a valid dry-run cell? (see DESIGN.md SSArch-applicability)"""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    if sp.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is out of the assigned set"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str, *, per_host: bool = False) -> dict:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every input of
    the step function implied by ``shape`` (train_step for train shapes,
    serve prefill/decode otherwise): the JAX package's ``ShapeDtypeStruct``s.
    ``shape``: a name in :data:`SHAPES`, or a :class:`ShapeSpec` of one's
    own (a small cell for tests).  ``per_host`` is accepted and not read, as
    in the JAX package."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sp.global_batch, sp.seq_len
    i32 = torch.int32
    d = cfg.d_model

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family in ("audio", "encdec"):
        enc = sds((B, cfg.enc_len, d), torch.float32)
        if sp.kind == "train":
            return {"enc_embeds": enc, "tokens": sds((B, S), i32),
                    "targets": sds((B, S), i32)}
        if sp.kind == "prefill":
            return {"enc_embeds": enc, "tokens": sds((B, S), i32)}
        return {"token": sds((B, 1), i32)}           # decode
    if cfg.input_mode == "embeddings":
        if sp.kind == "train":
            return {"embeds": sds((B, S, d), torch.float32),
                    "targets": sds((B, S), i32)}
        if sp.kind == "prefill":
            return {"embeds": sds((B, S, d), torch.float32)}
        return {"token": sds((B, 1), i32)}
    if sp.kind == "train":
        return {"tokens": sds((B, S), i32), "targets": sds((B, S), i32)}
    if sp.kind == "prefill":
        return {"tokens": sds((B, S), i32)}
    return {"token": sds((B, 1), i32)}


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "get_smoke_config",
           "shape_supported", "input_specs"]
