"""Decoder-only LM, dense / GQA / SWA / local-global path (PyTorch).

Counterpart of ``repro.models.lm``.  Parameters are a plain dictionary
with the JAX tree's names: ``embed`` (V, d), ``ln_f``, optional ``lm_head``
(d, V), and ``blocks``, a list with one dictionary of weights per layer
(``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``/``bk``/
``bv``, ``mlp``: ``w_gate``, ``w_up``, ``w_down``).  The JAX ``lax.scan``
over stacked layers becomes a Python loop over that list.

:func:`verify_step` is the serving path: on a CUDA device each layer's
attention runs the paged mixed-attention kernel and the lm head runs the
fused lm-head kernel; on the CPU both wrappers run their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention_mixed
from repro_torch.kernels.sampling.ops import fused_lmhead_greedy
from repro_torch.models.attention import attention_mask, sdpa
from repro_torch.models.common import (
    ModelConfig, apply_rope, gated_mlp, init_dense, rms_norm, rope_tables,
)
from repro_torch.serving import kvcache


# ---------------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------------

def init_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One transformer block's weights, on the generator's device."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    dev, dt = gen.device, cfg.dtype
    if cfg.moe:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP.md Queue 1: other families)")
    p = {
        "ln1": torch.ones((d,), dtype=dt, device=dev),
        "ln2": torch.ones((d,), dtype=dt, device=dev),
        "wq": init_dense(gen, (d, Hq * hd), dt),
        "wk": init_dense(gen, (d, Hkv * hd), dt),
        "wv": init_dense(gen, (d, Hkv * hd), dt),
        "wo": init_dense(gen, (Hq * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dt, device=dev)
    p["mlp"] = {
        "w_gate": init_dense(gen, (d, cfg.d_ff), dt),
        "w_up": init_dense(gen, (d, cfg.d_ff), dt),
        "w_down": init_dense(gen, (cfg.d_ff, d), dt, scale=cfg.d_ff ** -0.5),
    }
    return p


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``
    with the JAX package's std rule (its draws differ: hold the two packages
    against each other with :func:`repro_torch.checkpoint.params_from_jax`)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = {
        "embed": init_dense(gen, (cfg.vocab, cfg.d_model), cfg.dtype, scale=0.02),
        "blocks": [init_block_params(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    return params


def layer_windows(cfg: ModelConfig) -> tuple[int, ...]:
    """Per layer: -1 = full/global attention, else the SWA width."""
    L = cfg.n_layers
    if cfg.global_every:
        w = cfg.window or 1024
        return tuple(-1 if (i % cfg.global_every == cfg.global_every - 1) else w
                     for i in range(L))
    return (cfg.window if cfg.window else -1,) * L


# ---------------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------------

def _project_qkv(x, bp, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ bp["wq"]
    k = x @ bp["wk"]
    v = x @ bp["wv"]
    if cfg.qkv_bias:
        q = q + bp["bq"]
        k = k + bp["bk"]
        v = v + bp["bv"]
    return (q.reshape(B, S, cfg.n_heads, hd), k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _ffn(h, bp, cfg: ModelConfig):
    if cfg.moe:
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP.md Queue 1: other families)")
    return gated_mlp(h, bp["mlp"]["w_gate"], bp["mlp"]["w_up"], bp["mlp"]["w_down"])


def _kv_quantize(x):
    """x: (..., hd) -> (int8 values, f32 scale over the last dim)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _prefill_attention(q, k, v, window: int):
    S = q.shape[1]
    mask = attention_mask(S, S, causal=True, window=window if window > 0 else None,
                          device=q.device)
    return sdpa(q, k, v, mask)


def block_forward(x, bp, window: int, cos, sin, cfg: ModelConfig):
    """Full-sequence block: x (B, S, d)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, bp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = _prefill_attention(q, k, v, window)
    x = x + o.reshape(*x.shape[:2], -1) @ bp["wo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + _ffn(h, bp, cfg)


def block_verify(x, bp, window: int, cache_k, cache_v, pos, cos, sin,
                 cfg: ModelConfig, cache_ks=None, cache_vs=None, *, block_table):
    """Span decode: x (B, T, d), each row's T tokens at consecutive logical
    positions starting at ``pos[b]``.

    The span's KV is written into the paged pool first (in place), so query
    t attends its own key; then per-query causal attention runs over the
    row's pages through :func:`decode_attention_mixed` (the CUDA kernel on
    the card, gather + span mask + sdpa on the CPU)."""
    int8_kv = cache_ks is not None
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, bp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ops = kvcache.PagedOps(block_table)
    if int8_kv:
        k_store, k_sc = _kv_quantize(k)
        v_store, v_sc = _kv_quantize(v)
        ops.write_span(cache_ks, k_sc, pos)
        ops.write_span(cache_vs, v_sc, pos)
    else:
        k_store, v_store = k, v
    ops.write_span(cache_k, k_store, pos)
    ops.write_span(cache_v, v_store, pos)
    o = decode_attention_mixed(q, cache_k, cache_v, block_table, pos,
                               window=window, k_scale=cache_ks, v_scale=cache_vs)
    x = x + o.reshape(*x.shape[:2], -1) @ bp["wo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + _ffn(h, bp, cfg)


# ---------------------------------------------------------------------------------
# model-level functions
# ---------------------------------------------------------------------------------

def _lm_head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> (logits (B, S, V) f32, aux 0.0).

    The greedy oracle of the tests.  Its attention is the plain version of
    the flash-attention kernel, which is not ported yet, so it refuses to
    run on a CUDA device rather than stand in for that kernel there."""
    tokens = batch["tokens"]
    if tokens.is_cuda:
        raise NotImplementedError(
            "forward needs the flash-attention kernel on CUDA, which is not "
            "ported yet (ROADMAP.md Queue 2)")
    x = params["embed"][tokens.long()]
    S = x.shape[1]
    cos, sin = rope_tables(torch.arange(S, device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    for bp, w in zip(params["blocks"], layer_windows(cfg)):
        x = block_forward(x, bp, w, cos, sin, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (x @ _lm_head_weight(params, cfg)).float(), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def verify_step(params, cache, tokens, pos, cfg: ModelConfig, *, block_table):
    """Score a T-token span per row in one forward: tokens (B, T) at logical
    positions ``pos[b] + t`` over a paged cache (leaves (L, P, ps, ...)).

    Returns ``(tok (B, T) int32, lp (B, T) f32, cache)``: the greedy next
    token and its logprob after each span position, through the fused
    lm-head epilogue.  The cache's pages are written in place and the same
    dictionary is returned.  One function serves every mixed-step role
    (decode row, speculative verify block, prefill chunk), as in the JAX
    package.
    """
    x = params["embed"][tokens.long()]
    T = tokens.shape[1]
    span = torch.arange(T, device=pos.device)
    cos, sin = rope_tables(pos.long()[:, None] + span[None, :],
                           cfg.resolved_head_dim, cfg.rope_theta)
    int8_kv = cfg.kv_cache_dtype == "int8"
    for layer, (bp, w) in enumerate(zip(params["blocks"], layer_windows(cfg))):
        x = block_verify(x, bp, w, cache["k"][layer], cache["v"][layer], pos,
                         cos, sin, cfg,
                         cache_ks=cache["k_scale"][layer] if int8_kv else None,
                         cache_vs=cache["v_scale"][layer] if int8_kv else None,
                         block_table=block_table)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    tok, lp = fused_lmhead_greedy(x, _lm_head_weight(params, cfg))
    return tok, lp, cache


__all__ = ["init_params", "init_cache", "forward", "verify_step",
           "layer_windows", "block_forward", "block_verify"]
