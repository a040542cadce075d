"""Decoder-only LM, dense / GQA / SWA / local-global path (PyTorch).

Counterpart of ``repro.models.lm``.  Parameters are a plain dictionary
with the JAX tree's names: ``embed`` (V, d), ``ln_f``, optional ``lm_head``
(d, V), and ``blocks``, a list with one dictionary of weights per layer
(``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``/``bk``/
``bv``, ``mlp``: ``w_gate``, ``w_up``, ``w_down``).  The JAX ``lax.scan``
over stacked layers becomes a Python loop over that list.

:func:`verify_step` is the chunked serving path: on a CUDA device each
layer's attention runs the paged mixed-attention kernel and the lm head runs
the fused lm-head kernel.  :func:`prefill` and :func:`decode_step` are the
bucketed path: prefill attention runs the flash-attention kernel, decode
attention the paged decode kernel, and the full-vocab head product stays a
plain matmul (the JAX package leaves it to XLA).  Over the dense cache of
``ServeConfig(paged=False)`` (``block_table=None``) decode attention is the
masked sdpa, as in the JAX package.  On the CPU every wrapper runs its
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention_mixed, decode_attention_paged,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
from repro_torch.kernels.sampling.ops import fused_lmhead_greedy
from repro_torch.models.attention import NEG_INF, sdpa
from repro_torch.models.common import (
    ModelConfig, apply_rope, gated_mlp, init_dense, rms_norm, rope_tables,
)
from repro_torch.serving import kvcache

STREAM_THRESHOLD = 4096
STREAM_CHUNK = 512


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


def _stream_attention(q, k, v, window: int):
    """Blockwise causal attention over query chunks of ``STREAM_CHUNK``,
    O(S * chunk) memory: q (B, S, Hq, D) with S a multiple of the chunk;
    ``window``: -1 = unlimited."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    kf = k.float()
    vf = v.float()
    k_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for i in range(S // STREAM_CHUNK):
        qi = q[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]
        qf = (qi.float() * (D ** -0.5)).reshape(B, STREAM_CHUNK, Hkv, group, D)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
        q_pos = i * STREAM_CHUNK + torch.arange(STREAM_CHUNK, device=q.device)
        m = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            m &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.where(m[None, None, None], logits, torch.full_like(logits, NEG_INF))
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", w, vf)
        outs.append(out.reshape(B, STREAM_CHUNK, Hq, D).to(qi.dtype))
    return torch.cat(outs, dim=1)


def _prefill_attention(q, k, v, window: int):
    """Causal (+ window) attention over a full sequence: the flash kernel on
    the card; on the CPU its plain version, or the streaming route above
    ``STREAM_THRESHOLD`` as in the JAX package."""
    S = q.shape[1]
    if not q.is_cuda and S > STREAM_THRESHOLD and S % STREAM_CHUNK == 0:
        return _stream_attention(q, k, v, window)
    return flash_attention_dyn(q, k, v, window)


def block_forward(x, bp, window: int, cos, sin, cfg: ModelConfig):
    """Full-sequence block: x (B, S, d) -> (x, (k, v)), k/v after RoPE."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, bp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = _prefill_attention(q, k, v, window)
    x = x + o.reshape(*x.shape[:2], -1) @ bp["wo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + _ffn(h, bp, cfg), (k, v)


def block_decode(x, bp, window: int, cache_k, cache_v, pos, cos, sin,
                 cfg: ModelConfig, cache_ks=None, cache_vs=None, *, block_table=None):
    """One-token decode: x (B, 1, d).  ``cache_ks/vs``: int8 scale caches.

    With ``block_table`` (B, n) the caches are paged pools (P, ps, Hkv, hd):
    row b's token at logical position ``pos[b]`` is written into its page
    first (in place), then the query attends keys ``[0, pos]`` of its row
    through :func:`decode_attention_paged` (the CUDA kernel on the card,
    gather + vector mask + sdpa on the CPU).

    Without one they are dense (B, S_max, Hkv, hd) caches, ``pos`` a scalar
    (every row) or a (B,) vector (per row): the token is written in place
    (:class:`~repro_torch.serving.kvcache.DenseScalarOps` /
    ``DenseVectorOps``) and the masked sdpa attends, as the JAX
    ``block_decode`` does for a dense cache."""
    int8_kv = cache_ks is not None
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, bp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if block_table is not None:
        ops = kvcache.PagedOps(block_table)
    elif torch.is_tensor(pos) and pos.dim() == 1:
        ops = kvcache.DenseVectorOps()
    else:
        ops = kvcache.DenseScalarOps(x.device)
    if int8_kv:
        k_store, k_sc = _kv_quantize(k)
        v_store, v_sc = _kv_quantize(v)
        ops.write(cache_ks, k_sc, pos)
        ops.write(cache_vs, v_sc, pos)
    else:
        k_store, v_store = k, v
    ops.write(cache_k, k_store, pos)
    ops.write(cache_v, v_store, pos)
    if block_table is not None:
        o = decode_attention_paged(q, cache_k, cache_v, block_table, pos + 1,
                                   window=window, k_scale=cache_ks, v_scale=cache_vs)
    else:
        k_eff, v_eff = cache_k, cache_v
        if int8_kv:
            k_eff = _kv_dequantize(k_eff, cache_ks, cfg.dtype)
            v_eff = _kv_dequantize(v_eff, cache_vs, cfg.dtype)
        o = sdpa(q, k_eff, v_eff, ops.mask(k_eff.shape[1], pos, window))
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


def _lm_head(params, h, cfg: ModelConfig):
    """Full-vocab logits in f32 (a plain matmul, as XLA runs it in JAX)."""
    return (h @ _lm_head_weight(params, cfg)).float()


def _run_blocks(params, tokens, cfg: ModelConfig):
    """Embed and run every block over full sequences -> (x after ln_f,
    per-layer [(k, v)])."""
    x = params["embed"][tokens.long()]
    S = x.shape[1]
    cos, sin = rope_tables(torch.arange(S, device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    kvs = []
    for bp, w in zip(params["blocks"], layer_windows(cfg)):
        x, kv = block_forward(x, bp, w, cos, sin, cfg)
        kvs.append(kv)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kvs


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> (logits (B, S, V) f32, aux 0.0).  The greedy
    oracle of the tests; on the card its attention is the flash kernel."""
    x, _ = _run_blocks(params, batch["tokens"], cfg)
    return _lm_head(params, x, cfg), 0.0


def prefill(params, batch, cfg: ModelConfig, max_len: int | None = None, *,
            last_idx=None):
    """Run the prompt -> (last-position logits (B, 1, V) f32, cache dict of
    (L, B, max_len, Hkv, hd) leaves).

    ``last_idx``: position of each row's true last prompt token, an int or
    a 0-d tensor (one for all rows) or a (B,) tensor (batched bucketed
    prefill: rows padded to one power-of-two length, each selecting its own
    last position; the causal mask keeps positions <= last_idx independent
    of the padding).  None takes the last position.  The cache is padded to
    ``max_len``; an int8 cache is quantized after attention, which runs on
    the unquantized K/V."""
    tokens = batch["tokens"]
    x, kvs = _run_blocks(params, tokens, cfg)
    B, S = tokens.shape
    max_len = max_len or S
    if last_idx is None:
        x_last = x[:, -1:]
    elif not torch.is_tensor(last_idx) or last_idx.dim() == 0:
        i = int(last_idx)
        x_last = x[:, i:i + 1]
    else:
        x_last = x[torch.arange(B, device=x.device), last_idx.long()][:, None]
    logits = _lm_head(params, x_last, cfg)
    ks = torch.stack([k for k, _ in kvs])                    # (L, B, S, Hkv, hd)
    vs = torch.stack([v for _, v in kvs])
    if max_len > S:
        pad = (0, 0, 0, 0, 0, max_len - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    if cfg.kv_cache_dtype == "int8":
        kq, ksc = _kv_quantize(ks)
        vq, vsc = _kv_quantize(vs)
        return logits, {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    return logits, {"k": ks.to(cfg.dtype), "v": vs.to(cfg.dtype)}


def decode_step(params, cache, token, pos, cfg: ModelConfig, *, block_table=None):
    """One token per row: token (B, 1).  With ``block_table`` (B, n) the
    cache leaves are paged pools (L, P, ps, ...) and ``pos`` (B,) holds each
    row's logical position; without, they are the dense (L, B, S_max, ...)
    cache of :func:`init_cache` and ``pos`` is a scalar (every row) or a
    (B,) vector.  Returns ``(logits (B, 1, V) f32, cache)``; the token's KV
    is written in place and the same dictionary is returned."""
    x = params["embed"][token.long()]
    if torch.is_tensor(pos) and pos.dim() == 1:
        cos, sin = rope_tables(pos.long()[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    else:
        cos, sin = rope_tables(torch.tensor([int(pos)], device=x.device),
                               cfg.resolved_head_dim, cfg.rope_theta)
    int8_kv = cfg.kv_cache_dtype == "int8"
    for layer, (bp, w) in enumerate(zip(params["blocks"], layer_windows(cfg))):
        x = block_decode(x, bp, w, cache["k"][layer], cache["v"][layer], pos,
                         cos, sin, cfg,
                         cache_ks=cache["k_scale"][layer] if int8_kv else None,
                         cache_vs=cache["v_scale"][layer] if int8_kv else None,
                         block_table=block_table)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x, cfg), cache


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


__all__ = ["init_params", "init_cache", "forward", "prefill", "decode_step",
           "verify_step", "layer_windows", "block_forward", "block_decode",
           "block_verify"]
