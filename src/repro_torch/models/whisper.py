"""Whisper-style encoder-decoder backbone (audio frontend stubbed), in
PyTorch.

Counterpart of ``repro.models.whisper``.  The conv frontend is a stub, as
there: the model takes precomputed frame embeddings ``batch["enc_embeds"]``
(B, enc_len, d).  The encoder is a bidirectional transformer; each decoder
block adds causal self-attention and cross-attention over the encoder's
output.  Parameters are a plain dictionary with the JAX tree's names:
``embed`` (V, d), ``enc_blocks`` and ``dec_blocks`` (lists of per-layer
dictionaries; a decoder block is an :func:`repro_torch.models.lm.init_block_params`
block plus ``ln_x``, ``xq``, ``xk``, ``xv``, ``xo``), ``ln_enc``, ``ln_f``
and ``lm_head`` (d, V).

The JAX module has no Pallas kernel, so this one has no CUDA kernel: every
attention is the plain masked sdpa, on the card too.  The JAX serving
engine cannot serve this family (its dense prefill passes no
``enc_embeds``), nor can the port's; the model runs at model level:
:func:`prefill` then :func:`decode_step` with one scalar position.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import sdpa
from repro_torch.models.common import (
    ModelConfig, apply_rope, gated_mlp, generator, init_dense, lm_loss, rms_norm,
    rope_tables,
)
from repro_torch.models.lm import _lm_head, _project_qkv, _remat, init_block_params
from repro_torch.serving import kvcache


def _init_dec_block(gen, cfg: ModelConfig) -> dict:
    p = init_block_params(gen, cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p["ln_x"] = torch.ones((d,), dtype=cfg.dtype, device=gen.device)
    p["xq"] = init_dense(gen, (d, cfg.n_heads * hd), cfg.dtype)
    p["xk"] = init_dense(gen, (d, cfg.n_kv_heads * hd), cfg.dtype)
    p["xv"] = init_dense(gen, (d, cfg.n_kv_heads * hd), cfg.dtype)
    p["xo"] = init_dense(gen, (cfg.n_heads * hd, d), cfg.dtype)
    return p


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``
    with the JAX package's std rule (its draws differ: hold the two packages
    against each other with :func:`repro_torch.checkpoint.params_from_jax`).
    On the meta device: shapes and dtypes only (``Model.abstract_params``)."""
    gen = generator(seed, device)
    d = cfg.d_model
    return {
        "embed": init_dense(gen, (cfg.vocab, d), cfg.dtype, scale=0.02),
        "enc_blocks": [init_block_params(gen, cfg) for _ in range(cfg.n_enc_layers)],
        "dec_blocks": [_init_dec_block(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_enc": torch.ones((d,), dtype=cfg.dtype, device=gen.device),
        "ln_f": torch.ones((d,), dtype=cfg.dtype, device=gen.device),
        "lm_head": init_dense(gen, (d, cfg.vocab), cfg.dtype),
    }


def _self_attend(x, bp, cos, sin, mask, cfg: ModelConfig):
    """x + the block's self-attention over x itself -> (x, (k, v))."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, bp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return x + sdpa(q, k, v, mask).reshape(*x.shape[:2], -1) @ bp["wo"], (k, v)


def _mlp(x, bp, cfg: ModelConfig):
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + gated_mlp(h, bp["mlp"]["w_gate"], bp["mlp"]["w_up"], bp["mlp"]["w_down"])


# replint-torch: traced -- the encoder of prefill and the train step
def encode(params, enc_embeds, cfg: ModelConfig):
    """enc_embeds: (B, T_enc, d) precomputed frame embeddings (frontend
    stub) -> the encoder's output (B, T_enc, d) after ``ln_enc``."""
    x = enc_embeds.to(cfg.dtype)
    cos, sin = rope_tables(torch.arange(x.shape[1], device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)

    def body(x, bp):
        x, _ = _self_attend(x, bp, cos, sin, None, cfg)            # bidirectional
        return _mlp(x, bp, cfg)

    body = _remat(body, cfg)
    for bp in params["enc_blocks"]:
        x = body(x, bp)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _cross_attend(x, bp, xk, xv, cfg: ModelConfig):
    B, S, _ = x.shape
    h = rms_norm(x, bp["ln_x"], cfg.norm_eps)
    q = (h @ bp["xq"]).reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    return x + sdpa(q, xk, xv, None).reshape(B, S, -1) @ bp["xo"]


def _dec_cross_kv(bp, enc_out, cfg: ModelConfig):
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    xk = (enc_out @ bp["xk"]).reshape(B, T, cfg.n_kv_heads, hd)
    xv = (enc_out @ bp["xv"]).reshape(B, T, cfg.n_kv_heads, hd)
    return xk, xv


def _decode_prompt(params, batch, cfg: ModelConfig, *, remat: bool):
    """The teacher-forced decoder over ``batch["tokens"]`` (B, S) against the
    encoded ``batch["enc_embeds"]`` -> (x after ln_f, per-layer
    [(k, v, xk, xv)])."""
    enc_out = encode(params, batch["enc_embeds"], cfg)
    x = params["embed"][batch["tokens"].long()]
    S = x.shape[1]
    cos, sin = rope_tables(torch.arange(S, device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))

    def body(x, bp):
        x, (k, v) = _self_attend(x, bp, cos, sin, causal, cfg)
        xk, xv = _dec_cross_kv(bp, enc_out, cfg)
        x = _cross_attend(x, bp, xk, xv, cfg)
        return _mlp(x, bp, cfg), (k, v, xk, xv)

    if remat:
        body = _remat(body, cfg)
    kvs = []
    for bp in params["dec_blocks"]:
        x, kv = body(x, bp)
        kvs.append(kv)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kvs


# replint-torch: traced -- the train step's forward
def forward(params, batch, cfg: ModelConfig):
    """Teacher-forced training forward: batch = {enc_embeds, tokens} ->
    (logits (B, S, V) f32, 0.0).  Encoder and decoder blocks run under
    ``lm._remat``."""
    x, _ = _decode_prompt(params, batch, cfg, remat=True)
    return _lm_head(params, x, cfg), 0.0


def loss_fn(params, batch, cfg: ModelConfig):
    """``(loss, {"ce": loss})``: the JAX ``loss_fn``'s next-token
    cross-entropy (:func:`~repro_torch.models.common.lm_loss`)."""
    logits, _ = forward(params, batch, cfg)
    loss = lm_loss(logits, batch["targets"])
    return loss, {"ce": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    hd = cfg.resolved_head_dim
    kw = dict(dtype=cfg.dtype, device=device)
    return {
        "k": torch.zeros((cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd), **kw),
        "v": torch.zeros((cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd), **kw),
        "xk": torch.zeros((cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads, hd), **kw),
        "xv": torch.zeros((cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads, hd), **kw),
    }


# replint-torch: traced -- called from the serving step
def prefill(params, batch, cfg: ModelConfig, max_len: int | None = None):
    """Encode the audio and run the decoder prompt -> (last-position logits
    (B, 1, V) f32, cache): self-attention ``k``/``v`` (L, B, max_len, Hkv,
    hd) padded to ``max_len``, cross-attention ``xk``/``xv`` (L, B, T_enc,
    Hkv, hd)."""
    x, kvs = _decode_prompt(params, batch, cfg, remat=False)
    S = x.shape[1]
    max_len = max_len or S
    logits = _lm_head(params, x[:, -1:], cfg)
    ks, vs, xks, xvs = (torch.stack(t) for t in zip(*kvs))
    if max_len > S:
        pad = (0, 0, 0, 0, 0, max_len - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    return logits, {"k": ks.to(cfg.dtype), "v": vs.to(cfg.dtype),
                    "xk": xks.to(cfg.dtype), "xv": xvs.to(cfg.dtype)}


# replint-torch: traced -- called from the serving decode loop
def decode_step(params, cache, token, pos, cfg: ModelConfig):
    """One token per row: token (B, 1) at one position ``pos`` for every row
    (an int or a 0-d tensor, as the JAX ``decode_step`` takes it).  Its
    self-attention K/V are written at ``pos`` of the cache in place and the
    query attends keys ``[0, pos]``.  Returns ``(logits (B, 1, V) f32,
    cache)``, the same dictionary."""
    if torch.is_tensor(pos) and pos.dim() > 0:
        raise ValueError("whisper's decode_step takes one position for all rows "
                         "(as repro.models.whisper.decode_step does), not a vector")
    # one host position, as the JAX decode_step; no engine path serves whisper
    # replint-torch: disable=TRC101 -- whisper: not an engine path
    pos = int(pos)
    x = params["embed"][token.long()]
    cos, sin = rope_tables(torch.tensor([pos], device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    ops = kvcache.DenseScalarOps(x.device)
    for layer, bp in enumerate(params["dec_blocks"]):
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(h, bp, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ck = ops.write(cache["k"][layer], k, pos)
        cv = ops.write(cache["v"][layer], v, pos)
        x = x + sdpa(q, ck, cv, ops.mask(ck.shape[1], pos, -1)).reshape(
            *x.shape[:2], -1) @ bp["wo"]
        x = _cross_attend(x, bp, cache["xk"][layer], cache["xv"][layer], cfg)
        x = _mlp(x, bp, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x, cfg), cache


__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step",
           "init_cache", "encode"]
