"""Model bundle: the functional interface the serving engine runs on.

Counterpart of ``repro.models.registry``.  ``build_model`` binds a config to
a device: ``cuda`` unless the caller passes ``device="cpu"``.  Without a GPU
and without an explicit CPU request it raises rather than carry on on the
CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from repro_torch.models.common import ModelConfig


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                               "device='cpu' to run its plain versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


@dataclass(frozen=True)
class Model:
    """Functions bound to one config and one device."""

    cfg: ModelConfig
    device: torch.device
    init_params: Callable          # seed -> params on ``device``
    forward: Callable              # (params, batch) -> (logits, aux)
    # (params, batch, max_len, ...) -> (logits (B,1,V), cache)
    prefill: Callable
    # (params, cache, token (B,1), pos, ...) -> (logits, cache)
    decode_step: Callable
    init_cache: Callable           # (batch, max_len) -> cache on ``device``
    # (params, cache, tokens (B,T), pos (B,), block_table=) ->
    # (tok (B,T), lp (B,T), cache): span scoring through the fused lm-head;
    # None for families without the paged mixed path
    verify_step: Callable | None = None
    supports_paged: bool = True    # decode_step takes block_table= (paged KV)


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    """dense/moe/vlm bind :mod:`repro_torch.models.lm` (paged, with the
    mixed step); ssm/hybrid bind :mod:`repro_torch.models.mamba_lm`, which
    the engine serves through its dense-cache fallback."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import lm as mod
        paged = True
    elif cfg.family in ("ssm", "hybrid"):
        from repro_torch.models import mamba_lm as mod
        paged = False
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue 1: "
            "other families)")
    dev = resolve_device(device)
    return Model(
        cfg=cfg,
        device=dev,
        init_params=partial(mod.init_params, cfg=cfg, device=dev),
        forward=partial(mod.forward, cfg=cfg),
        prefill=partial(mod.prefill, cfg=cfg),
        decode_step=partial(mod.decode_step, cfg=cfg),
        init_cache=partial(mod.init_cache, cfg, device=dev),
        verify_step=partial(mod.verify_step, cfg=cfg) if paged else None,
        supports_paged=paged,
    )


__all__ = ["Model", "build_model", "resolve_device"]
