"""Shared model configuration + primitive layers (PyTorch).

Counterpart of ``repro.models.common``: one :class:`ModelConfig` describes
every architecture; the primitives below are plain functions on tensors,
with the JAX package's layouts, so the parity tests compare like with like.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    n_groups: int = 1
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0              # 0 => attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 0             # 0 => d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sliding-window / local-global interleave
    window: int | None = None             # SWA width for windowed layers
    global_every: int | None = None       # gemma3: 1 global layer every N (rest local)
    # MoE / SSM
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # zamba2-style shared attention block applied every N ssm layers
    shared_attn_every: int | None = None
    # encoder-decoder (whisper): encoder length & layers
    n_enc_layers: int = 0
    enc_len: int = 0
    # modality frontend stub: model consumes precomputed embeddings
    input_mode: str = "tokens"            # tokens | embeddings
    dtype: Any = torch.bfloat16
    # remat policy for training: none | block | dots
    remat: str = "block"
    # KV cache storage: "native" (= dtype) or "int8" (per-token/head
    # symmetric quantization)
    kv_cache_dtype: str = "native"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)


# ---------------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding: (..., head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward; weights (d, f), (d, f), (f, d)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_dense(gen: torch.Generator, shape: tuple[int, ...], dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal init with std ``scale`` or fan_in ** -0.5 (the JAX rule), drawn
    in float32 from ``gen`` on the generator's device, then cast."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig",
    "rms_norm", "rope_tables", "apply_rope", "gated_mlp", "init_dense",
]
