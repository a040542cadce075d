"""Multi-head attention (GQA / causal / sliding-window) in plain PyTorch.

Counterpart of ``repro.models.attention``; ``sdpa`` is also the plain
version the paged mixed-attention kernel is held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(q_len: int, kv_len: int, *, causal: bool, window: int | None,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attend.

    ``q_offset``: absolute position of query row 0.
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None) -> torch.Tensor:
    """Scaled dot-product attention with GQA head-group broadcasting, in f32.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); mask: (Sq, Sk), (B, Sq, Sk) or
    None.  Returns (B, Sq, Hq, D) in q's dtype.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qf = q.float() * (D ** -0.5)
    qf = qf.reshape(B, Sq, Hkv, group, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if mask is not None:
        m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


__all__ = ["attention_mask", "sdpa", "NEG_INF"]
