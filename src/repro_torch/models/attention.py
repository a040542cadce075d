"""Multi-head attention (GQA / causal / sliding-window) in plain PyTorch.

Counterpart of ``repro.models.attention``; ``sdpa`` is also the plain
version the attention kernels are held against.  :func:`mha_prefill` and
:func:`mha_decode` with ``use_kernel=True`` run the flash and the dense
decode-attention kernels on the card.
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


def mha_prefill(q, k, v, *, causal: bool = True, window: int | None = None,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence attention.  q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D).

    ``use_kernel`` routes through
    :func:`~repro_torch.kernels.flash_attention.ops.flash_attention` (the
    CUDA kernel for CUDA tensors, its plain version for CPU ones), which
    takes one sequence length: Sk must equal Sq there.  The plain route
    takes any Sk, its mask anchored at key 0 as in the JAX package."""
    if use_kernel:
        if k.shape[1] != q.shape[1]:
            raise ValueError(f"mha_prefill(use_kernel=True): Sk {k.shape[1]} != Sq "
                             f"{q.shape[1]}; the flash kernel takes one sequence length")
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window)
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                          device=q.device)
    return sdpa(q, k, v, mask)


def mha_decode(q1, k_cache, v_cache, pos, *, window: int | None = None,
               use_kernel: bool = False) -> torch.Tensor:
    """One-token decode: q1 (B, 1, Hq, D) against caches (B, S_max, Hkv, D);
    ``pos`` = number of valid entries (the new token's KV must already be
    written at index pos - 1).  ``use_kernel`` routes through
    :func:`~repro_torch.kernels.decode_attention.ops.decode_attention` (the
    CUDA kernel for CUDA tensors, its plain version for CPU ones)."""
    if use_kernel:
        from repro_torch.kernels.decode_attention.ops import decode_attention
        return decode_attention(q1, k_cache, v_cache, pos, window=window)
    k_pos = torch.arange(k_cache.shape[1], device=q1.device)
    valid = k_pos < pos
    if window is not None:
        valid &= k_pos >= pos - window
    return sdpa(q1, k_cache, v_cache, valid[None, :])        # (Sq=1, Sk)


__all__ = ["attention_mask", "sdpa", "mha_prefill", "mha_decode", "NEG_INF"]
