"""Pure Mamba-2 LM (mamba2-1.3b) and the Zamba2-style hybrid (an SSM stack
with one shared attention(+MLP) block applied every N layers), in PyTorch.

Counterpart of ``repro.models.mamba_lm``.  Parameters are a plain
dictionary with the JAX tree's names: ``embed`` (V, d), ``ln_f``, optional
``lm_head`` (d, V), ``blocks`` (one dictionary of Mamba-2 weights per
layer, see :func:`init_mamba_layer`) and, for the hybrid, ``shared_attn``
(one transformer block's weights, :func:`repro_torch.models.lm.init_block_params`).
The JAX ``lax.scan`` over stacked layers becomes a Python loop.

Prefill runs each layer's SSD intra-chunk term through
:func:`repro_torch.kernels.ssd.ops.ssd_intra` and the hybrid's shared
attention through the flash-attention wrapper: the CUDA kernels on the
card, their plain versions on the CPU.  Decode is the plain recurrence, and
the hybrid's decode attention the plain masked sdpa over its dense cache,
as in the JAX package.  :func:`loss_fn` trains through
``forward(..., use_kernel=False)``: the plain SSD and attention on either
device, each Mamba-2 layer under ``lm._remat``.  The hybrid's shared block
is ``lm.block_forward`` / ``lm.block_decode``.

Under tensor parallelism each Mamba-2 mixer runs on the rank's SSM heads
(``ssm.mamba2_block`` with its model group) where they divide ``model``,
and the shared block and the vocabulary as in :mod:`repro_torch.models.lm`.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import model_dim
from repro_torch.models.common import ModelConfig, generator, init_dense, rms_norm, rope_tables
from repro_torch.models.lm import (
    _cross_entropy, _embed_tokens, _lm_head, _remat, block_decode, block_forward, cut_cache,
    init_block_params,
)
from repro_torch.models.ssm import mamba2_block


# ---------------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------------

def init_mamba_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One Mamba-2 layer's weights on the generator's device.  ``A_log``,
    ``D`` and ``dt_bias`` stay float32 whatever ``cfg.dtype`` is."""
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    h = d_in // s.head_dim
    g, n, w = s.n_groups, s.d_state, s.conv_width
    dev, dt = gen.device, cfg.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "w_z": init_dense(gen, (d, d_in), dt),
        "w_x": init_dense(gen, (d, d_in), dt),
        "w_bc": init_dense(gen, (d, 2 * g * n), dt),
        "w_dt": init_dense(gen, (d, h), dt),
        "conv_x": init_dense(gen, (w, d_in), dt, scale=w ** -0.5),
        "conv_bc": init_dense(gen, (w, 2 * g * n), dt, scale=w ** -0.5),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": torch.ones((d_in,), dtype=dt, device=dev),
        "out_proj": init_dense(gen, (d_in, d), dt),
    }


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``
    with the JAX package's std rule (its draws differ: hold the two packages
    against each other with :func:`repro_torch.checkpoint.params_from_jax`).
    On the meta device: shapes and dtypes only (``Model.abstract_params``)."""
    gen = generator(seed, device)
    params = {
        "embed": init_dense(gen, (cfg.vocab, cfg.d_model), cfg.dtype, scale=0.02),
        "blocks": [init_mamba_layer(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    if cfg.shared_attn_every:
        params["shared_attn"] = init_block_params(gen, cfg)      # attn + mlp block
    return params


def _attn_after(cfg: ModelConfig, layer: int) -> bool:
    """Whether the shared attention block runs after ``layer`` (the end of
    each group of ``shared_attn_every`` layers; never after the rest)."""
    every = cfg.shared_attn_every
    return bool(every) and layer % every == every - 1


def _n_attn_calls(cfg: ModelConfig) -> int:
    return sum(_attn_after(cfg, i) for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------------

def _mamba(x, bp, cfg: ModelConfig, **kw):
    """``mamba2_block`` of the layer: split over ``model`` under tensor
    parallelism where its SSM heads divide it
    (:func:`tensor_parallel.mamba_split`), else on its leaves whole (a
    block gathered)."""
    g = tp.model_group()
    if g is not None and tp.mamba_split(cfg, g.mp):
        return mamba2_block(x, bp, cfg.ssm, g=g, **kw)
    if g is not None:
        heads, d_in = tp.ssm_heads(cfg), cfg.ssm.expand * cfg.d_model

        def full(k: str) -> int:
            return heads if k in ("w_dt", "A_log", "D", "dt_bias") else d_in

        bp = {k: v if model_dim(k) is None else tp.whole(v, model_dim(k), full(k), g)
              for k, v in bp.items()}
    return mamba2_block(x, bp, cfg.ssm, **kw)


def _whole_window(cv, cfg: ModelConfig):
    """A layer's conv window (B, w, channels) whole: where the mixer ran
    split, the rank's x channels gathered over ``model`` (B and C each rank
    holds whole)."""
    g = tp.model_group()
    if g is None or not tp.mamba_split(cfg, g.mp):
        return cv
    bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return torch.cat([tp.gather_over_model(cv[..., :-bc], 2, g, partial=False),
                      cv[..., -bc:]], dim=-1)


# replint-torch: traced -- the prefill and train steps' forward
def forward(params, batch, cfg: ModelConfig, *, use_kernel: bool = True,
            collect_cache: bool = False):
    """Full-sequence forward -> (logits (B, S, V) f32, 0.0), or with
    ``collect_cache`` (logits, cache): ``ssm`` (L, B, h, p, n) f32 final
    states, ``conv`` (L, B, w, C) last pre-conv inputs and, for the hybrid,
    ``attn_k``/``attn_v`` (calls, B, S, Hkv, hd) after RoPE.  Each Mamba-2
    layer runs under ``lm._remat``.  ``use_kernel`` (the default, serving)
    takes the SSD and flash kernels on the card; :func:`loss_fn` passes
    False, the plain SSD (``ssd_chunked(use_kernel=False)``) and the JAX
    non-kernel attention.  The hybrid's shared block is ``lm.block_forward``.

    Under tensor parallelism each region runs on the rank's blocks
    (:func:`_mamba`, ``lm.block_forward``): the logits are the rank's
    vocabulary block where the vocabulary is split, ``ssm`` the rank's
    heads, ``attn_k`` / ``attn_v`` the kv heads the rank holds, ``conv``
    whole."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    S = x.shape[1]
    cos = sin = None
    if cfg.shared_attn_every:
        cos, sin = rope_tables(torch.arange(S, device=x.device),
                               cfg.resolved_head_dim, cfg.rope_theta)

    def mamba_body(x, bp):
        y, st, cv = _mamba(rms_norm(x, bp["ln"], cfg.norm_eps), bp, cfg,
                           use_kernel=use_kernel)
        return x + y, st, cv

    mamba_body = _remat(mamba_body, cfg)
    sts, cvs, attn_kv = [], [], []
    for layer, bp in enumerate(params["blocks"]):
        x, st, cv = mamba_body(x, bp)
        sts.append(st)
        cvs.append(cv)
        if _attn_after(cfg, layer):
            x, kv, _ = block_forward(x, params["shared_attn"], -1, cos, sin, cfg,
                                     use_kernel=use_kernel)
            attn_kv.append(kv)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _lm_head(params, x, cfg)
    if not collect_cache:
        return logits, 0.0
    cache = {"ssm": torch.stack(sts), "conv": torch.stack([_whole_window(c, cfg) for c in cvs])}
    if cfg.shared_attn_every:
        cache["attn_k"] = torch.stack([k for k, _ in attn_kv])
        cache["attn_v"] = torch.stack([v for _, v in attn_kv])
    return logits, cache


def loss_fn(params, batch, cfg: ModelConfig):
    """``(loss, {"ce": loss})``: the JAX ``loss_fn``'s next-token
    cross-entropy (:func:`~repro_torch.models.common.lm_loss`) through
    :func:`forward` without the kernels."""
    logits, _ = forward(params, batch, cfg, use_kernel=False)
    loss = _cross_entropy(logits, batch["targets"], cfg)
    return loss, {"ce": loss}


# ---------------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    cache = {
        "ssm": torch.zeros((cfg.n_layers, batch, h, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, s.conv_width, conv_ch),
                            dtype=cfg.dtype, device=device),
    }
    if cfg.shared_attn_every:
        shape = (_n_attn_calls(cfg), batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return cache


# replint-torch: traced -- called from the serving engine's step
def prefill(params, batch, cfg: ModelConfig, max_len: int | None = None, *,
            cache_split=None):
    """Run the prompt -> (last-position logits (B, 1, V) f32, cache); the
    hybrid's attention caches are padded to ``max_len``.  Under tensor
    parallelism the logits are the rank's vocabulary block where the
    vocabulary is split (:func:`forward`), and ``cache_split`` cuts the
    attention caches as ``lm.prefill`` does."""
    logits, cache = forward(params, batch, cfg, collect_cache=True)
    S = batch["tokens"].shape[1]
    max_len = max_len or S
    if cfg.shared_attn_every and max_len > S:
        pad = (0, 0, 0, 0, 0, max_len - S)
        cache["attn_k"] = torch.nn.functional.pad(cache["attn_k"], pad)
        cache["attn_v"] = torch.nn.functional.pad(cache["attn_v"], pad)
    if cfg.shared_attn_every and cache_split is not None:
        for name in ("attn_k", "attn_v"):
            cache[name] = cut_cache(cache[name], cache_split)
    return logits[:, -1:], cache


# replint-torch: traced -- called from the serving engine's decode loop
def decode_step(params, cache, token, pos, cfg: ModelConfig, *, cache_split=None):
    """One token per row: token (B, 1).  Returns ``(logits (B, 1, V) f32,
    cache)``; the cache is updated in place and the same dictionary is
    returned.

    The pure SSM stack ignores ``pos``.  The hybrid's shared attention
    (``lm.block_decode``) takes one position for every row (an int or a
    0-d tensor), as the JAX ``decode_step`` does: its K/V are written at
    ``pos`` of the call's dense cache and the query attends keys
    ``[0, pos]``; ``cache_split`` as in ``lm.decode_step``.  Under tensor
    parallelism the logits are the rank's vocabulary block where the
    vocabulary is split."""
    x = _embed_tokens(params, token, cfg)
    every = cfg.shared_attn_every
    cos = sin = None
    if every:
        if torch.is_tensor(pos) and pos.dim() > 0:
            raise ValueError("the hybrid's decode_step takes one position for all rows "
                             "(as repro.models.mamba_lm.decode_step does), not a vector")
        # one host position, as the JAX decode_step; the engine refuses the hybrid
        # replint-torch: disable=TRC101 -- hybrid: not an engine path
        pos = int(pos)
        cos, sin = rope_tables(torch.tensor([pos], device=x.device),
                               cfg.resolved_head_dim, cfg.rope_theta)
    call = 0
    for layer, bp in enumerate(params["blocks"]):
        h = rms_norm(x, bp["ln"], cfg.norm_eps)
        y, st, cv = _mamba(h, bp, cfg, state=cache["ssm"][layer],
                           conv_state=cache["conv"][layer], decode=True)
        x = x + y
        cache["ssm"][layer] = st
        cache["conv"][layer] = _whole_window(cv, cfg)
        if _attn_after(cfg, layer):
            x = block_decode(x, params["shared_attn"], -1, cache["attn_k"][call],
                             cache["attn_v"][call], pos, cos, sin, cfg, split=cache_split)
            call += 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x, cfg), cache


__all__ = ["init_params", "init_mamba_layer", "forward", "loss_fn", "prefill", "decode_step",
           "init_cache"]
