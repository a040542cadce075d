"""Decoder-only LM, dense / GQA / SWA / local-global / MoE path (PyTorch).

Counterpart of ``repro.models.lm``.  Parameters are a plain dictionary
with the JAX tree's names: ``embed`` (V, d), ``ln_f``, optional ``lm_head``
(d, V), and ``blocks``, a list with one dictionary of weights per layer
(``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``/``bk``/
``bv``, and either ``mlp``: ``w_gate``, ``w_up``, ``w_down`` or, for the
moe family, ``moe``: ``router`` (kept in float32), ``w_gate``, ``w_up``,
``w_down``).  The JAX ``lax.scan`` over stacked layers becomes a Python
loop over that list.  With ``cfg.input_mode == "embeddings"`` (the vlm
family) :func:`forward` and :func:`prefill` take ``batch["embeds"]`` and
:func:`decode_step` a (B, 1, d) float tensor in the place of the token;
:func:`verify_step` always embeds tokens, as in the JAX package.

:func:`verify_step` is the chunked serving path: on a CUDA device each
layer's attention runs the paged mixed-attention kernel and the lm head runs
the fused lm-head kernel.  :func:`prefill` and :func:`decode_step` are the
bucketed path: prefill attention runs the flash-attention kernel, decode
attention the paged decode kernel, and the full-vocab head product stays a
plain matmul (the JAX package leaves it to XLA).  Over the dense cache of
``ServeConfig(paged=False)`` (``block_table=None``) decode attention is the
masked sdpa, as in the JAX package.  On the CPU every wrapper runs its
plain version.

:func:`loss_fn` is the training path: :func:`forward` with
``use_kernel=False`` (the JAX package trains with its kernels off too),
each block under :func:`_remat`, on the card and on the CPU alike.

Under tensor parallelism (``distributed.tensor_parallel.set_tp_mesh``) the
same functions run on the rank's blocks of the parameters in the Megatron
layout: attention on the rank's query heads (its kv heads where they
divide ``model``, else every kv head from ``wk`` / ``wv`` gathered, each
rank reading the ones its query heads read) with a row-parallel ``wo``;
the gated MLP column- / row-parallel; the embedding, logits and
cross-entropy on the rank's vocabulary block.  Head counts come from the
local weights' widths; a region whose dims do not divide ``model`` runs on
its leaves gathered whole (``tensor_parallel.layout``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import moe_ep
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import model_dim
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_mixed, decode_attention_paged,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
from repro_torch.kernels.sampling.ops import fused_lmhead_greedy
from repro_torch.models.attention import NEG_INF, attention_mask, sdpa
from repro_torch.models.common import (
    ModelConfig, apply_rope, gated_mlp, generator, init_dense, lm_loss, rms_norm,
    rope_tables,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.pytree import tree_leaves
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
    if cfg.moe:
        m = cfg.moe
        p["moe"] = {       # the router stays float32 whatever cfg.dtype is
            "router": init_dense(gen, (d, m.n_experts), torch.float32),
            "w_gate": init_dense(gen, (m.n_experts, d, m.d_expert), dt),
            "w_up": init_dense(gen, (m.n_experts, d, m.d_expert), dt),
            "w_down": init_dense(gen, (m.n_experts, m.d_expert, d), dt,
                                 scale=m.d_expert ** -0.5),
        }
    else:
        p["mlp"] = {
            "w_gate": init_dense(gen, (d, cfg.d_ff), dt),
            "w_up": init_dense(gen, (d, cfg.d_ff), dt),
            "w_down": init_dense(gen, (cfg.d_ff, d), dt, scale=cfg.d_ff ** -0.5),
        }
    return p


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``
    with the JAX package's std rule (its draws differ: hold the two packages
    against each other with :func:`repro_torch.checkpoint.params_from_jax`).
    On the meta device: shapes and dtypes only (``Model.abstract_params``)."""
    gen = generator(seed, device)
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

def _attn_split(cfg: ModelConfig, g) -> bool:
    return g is not None and tp.attention_split(cfg, g.mp)


def _project_qkv(x, bp, cfg: ModelConfig, g=None):
    """q, k, v (B, S, heads, hd) of x.

    With no model group ``g`` (one device): every head from whole leaves.
    Under tensor parallelism (``g``, :mod:`~repro_torch.distributed.tensor_parallel`)
    the heads come from the local weights' widths: split attention (query
    heads divide ``model``; x has entered through ``copy_to_model``) gives
    q on the rank's heads and k / v on its kv heads where those divide,
    else on every kv head from ``wk`` / ``wv`` (and ``bk`` / ``bv``)
    gathered over ``model`` (:func:`_kv_heads` then picks the ones the
    rank's query heads read); whole attention gives every head, any block
    leaf gathered."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    split = _attn_split(cfg, g)
    kv_cut = split and cfg.n_kv_heads % g.mp == 0

    def proj(w_name: str, b_name: str, heads: int, cut: bool):
        w = bp[w_name]
        b = bp[b_name] if cfg.qkv_bias else None
        if cut:
            tp.expect_block(w, model_dim(w_name), heads * hd, g)
        elif g is not None:
            w = tp.whole(w, model_dim(w_name), heads * hd, g, in_split=split)
            b = tp.whole(b, model_dim(b_name), heads * hd, g, in_split=split)
        y = x @ w
        if b is not None:
            y = y + b
        return y.reshape(B, S, -1, hd)

    return (proj("wq", "bq", cfg.n_heads, split), proj("wk", "bk", cfg.n_kv_heads, kv_cut),
            proj("wv", "bv", cfg.n_kv_heads, kv_cut))


def _kv_heads(cfg: ModelConfig, g):
    """Where attention is split and its kv heads are not: the kv heads the
    rank's query heads read (a slice, or one index per query head where
    the two counts do not nest); None otherwise."""
    if not _attn_split(cfg, g) or cfg.n_kv_heads % g.mp == 0:
        return None
    n = cfg.n_heads // g.mp
    group = cfg.n_heads // cfg.n_kv_heads
    first = g.rank * n
    if group % n == 0:
        return slice(first // group, first // group + 1)
    if n % group == 0:
        return slice(first // group, (first + n) // group)
    return torch.arange(first, first + n) // group


def _take_heads(t, sel):
    """t (B, S, H, hd) on the kv heads ``sel`` (:func:`_kv_heads`)."""
    if sel is None:
        return t
    if isinstance(sel, slice):
        return t[:, :, sel]
    return t.index_select(2, sel.to(t.device))


def _attn_out(o, bp, cfg: ModelConfig, g):
    """The output projection of o (B, S, heads, hd): row-parallel over the
    rank's heads and summed over ``model`` where attention is split, else
    through ``wo`` whole."""
    o = o.reshape(*o.shape[:2], -1)
    full = cfg.n_heads * cfg.resolved_head_dim
    if _attn_split(cfg, g):
        tp.expect_block(bp["wo"], model_dim("wo"), full, g)
        return tp.sum_over_model(o @ bp["wo"], g)
    return o @ (bp["wo"] if g is None else tp.whole(bp["wo"], model_dim("wo"), full, g))


def _attn_in(x, bp, cfg: ModelConfig, g):
    """``ln1`` of x, entered into the attention region (``copy_to_model``
    where it runs split)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    return tp.copy_to_model(h, g) if _attn_split(cfg, g) else h


def _ffn(h, bp, cfg: ModelConfig, *, aux: bool = False):
    """The block's feed-forward on h (B, S, d) -> (out, aux loss), the gated
    MLP or the MoE layer.  The MoE layer takes the JAX package's branch:
    with an expert-parallel mesh (``moe_ep.set_ep_mesh``, a ``model`` axis,
    ``REPRO_MOE_EP`` unset or ``1``) :func:`moe_ep.moe_ffn_ep`, which routes
    and fills capacity over the rank's tokens (its data shard) with the
    experts on their ranks; else :func:`moe_ffn` over all B * S tokens at
    once (idle rows included): the whole batch on one device, the rank's
    data shard in the sharded step, which gathers the experts whole.  The
    load-balance loss is computed only with ``aux`` (only :func:`forward`
    returns it), else it is 0.0.  The gated MLP runs column- / row-parallel
    under tensor parallelism where ``d_ff`` divides ``model``
    (:func:`tensor_parallel.layout`), else on its leaves gathered whole."""
    if cfg.moe:
        mesh = moe_ep.active_ep_mesh()
        if mesh is not None:
            out, loss = moe_ep.moe_ffn_ep(h, bp["moe"], cfg.moe, mesh, aux=aux)
            return out, loss if aux else 0.0
        B, S, d = h.shape
        out, loss = moe_ffn(h.reshape(B * S, d), bp["moe"], cfg.moe, aux=aux)
        return out.reshape(B, S, d), loss if aux else 0.0
    mlp = bp["mlp"]
    g = tp.model_group()
    if g is None:
        return gated_mlp(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"]), 0.0
    names = ("w_gate", "w_up", "w_down")
    if tp.mlp_split(cfg, g.mp):                 # column w_gate / w_up, row w_down
        for name in names:
            tp.expect_block(mlp[name], model_dim(name), cfg.d_ff, g)
        out = gated_mlp(tp.copy_to_model(h, g), mlp["w_gate"], mlp["w_up"], mlp["w_down"])
        return tp.sum_over_model(out, g), 0.0
    return gated_mlp(h, *(tp.whole(mlp[n], model_dim(n), cfg.d_ff, g) for n in names)), 0.0


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


def _prefill_attention(q, k, v, window: int, use_kernel: bool = True):
    """Causal (+ window) attention over a full sequence.

    ``use_kernel`` (serving, the greedy oracles): the flash kernel on the
    card; on the CPU its plain version, or the streaming route above
    ``STREAM_THRESHOLD`` as in the JAX package.  Without it (training): the
    JAX ``use_kernel=False`` branch on either device, the masked sdpa up to
    ``STREAM_THRESHOLD`` and the streaming route above it; autograd runs
    through both."""
    S = q.shape[1]
    stream = S > STREAM_THRESHOLD and S % STREAM_CHUNK == 0
    if use_kernel and (q.is_cuda or not stream):
        return flash_attention_dyn(q, k, v, window)
    if stream:
        return _stream_attention(q, k, v, window)
    mask = attention_mask(S, S, causal=True, window=window if window > 0 else None,
                          device=q.device)
    return sdpa(q, k, v, mask)


def block_forward(x, bp, window: int, cos, sin, cfg: ModelConfig, *, aux: bool = False,
                  use_kernel: bool = True):
    """Full-sequence block: x (B, S, d) -> (x, (k, v), aux), k/v after RoPE
    on the heads the rank holds (:func:`_project_qkv`); the MoE
    load-balance loss only with ``aux`` (else 0.0); ``use_kernel`` as in
    :func:`_prefill_attention`."""
    g = tp.model_group()
    h = _attn_in(x, bp, cfg, g)
    q, k, v = _project_qkv(h, bp, cfg, g)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    sel = _kv_heads(cfg, g)
    o = _prefill_attention(q, _take_heads(k, sel), _take_heads(v, sel), window, use_kernel)
    x = x + _attn_out(o, bp, cfg, g)
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    f, loss = _ffn(h, bp, cfg, aux=aux)
    return x + f, (k, v), loss


def block_decode(x, bp, window: int, cache_k, cache_v, pos, cos, sin,
                 cfg: ModelConfig, cache_ks=None, cache_vs=None, *, paged=None, split=None):
    """One-token decode: x (B, 1, d).  ``cache_ks/vs``: int8 scale caches.

    With ``paged``, the step's :class:`~repro_torch.serving.kvcache.PagedOps`
    over its block table (B, n) -- one instance shared by every layer, so
    the write slots are computed once a step -- the caches are paged pools
    (P, ps, Hkv, hd): row b's token at logical position ``pos[b]`` is
    written into its page first (in place), then the query attends keys
    ``[0, pos]`` of its row through :func:`decode_attention_paged` (the
    CUDA kernel on the card, gather + vector mask + sdpa on the CPU).

    Without one they are dense (B, S_max, Hkv, hd) caches, ``pos`` a scalar
    (every row) or a (B,) vector (per row): the token is written in place
    (:class:`~repro_torch.serving.kvcache.DenseScalarOps` /
    ``DenseVectorOps``) and the masked sdpa attends, as the JAX
    ``block_decode`` does for a dense cache.

    Under tensor parallelism the caches hold the heads the rank holds
    (:func:`_project_qkv`); ``split``, a
    :class:`~repro_torch.distributed.tensor_parallel.CacheSplit`, says
    where the rules cut them further (:func:`_split_cache_attention`)."""
    int8_kv = cache_ks is not None
    g = tp.model_group()
    h = _attn_in(x, bp, cfg, g)
    q, k, v = _project_qkv(h, bp, cfg, g)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if split is not None:
        if int8_kv or paged is not None:
            raise ValueError("a cache cut on its sequence or head dim is a dense "
                             "native-dtype cache")
        o = _split_cache_attention(q, k, v, cache_k, cache_v, pos, window, cfg, g, split)
        x = x + _attn_out(o, bp, cfg, g)
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + _ffn(h, bp, cfg)[0]
    sel = _kv_heads(cfg, g)
    if paged is not None:
        if sel is not None:
            raise ValueError("a paged pool takes the kv heads the rank holds whole")
        ops = paged
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
    if paged is not None:
        o = decode_attention_paged(q, cache_k, cache_v, paged.block_table, pos + 1,
                                   window=window, k_scale=cache_ks, v_scale=cache_vs)
    else:
        k_eff, v_eff = cache_k, cache_v
        if int8_kv:
            k_eff = _kv_dequantize(k_eff, cache_ks, cfg.dtype)
            v_eff = _kv_dequantize(v_eff, cache_vs, cfg.dtype)
        o = sdpa(q, _take_heads(k_eff, sel), _take_heads(v_eff, sel),
                 ops.mask(k_eff.shape[1], pos, window))
    x = x + _attn_out(o, bp, cfg, g)
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + _ffn(h, bp, cfg)[0]


def _split_cache_attention(q, k, v, cache_k, cache_v, pos, window: int, cfg: ModelConfig,
                           g, split):
    """One token's attention over a dense cache block (B, S_loc, Hc, D_loc)
    that the rules cut on its sequence (``split.seq``: the rank holds one
    span) and / or its head dim (``split.dim``: one D block of every
    head), at one position ``pos`` for every row.

    The token's k / v is written only by the rank whose span holds ``pos``
    (its D block where the head dim is cut).  The queries are the heads the
    cache holds: the rank's own where the cache holds its kv heads, else
    every query head (gathered over ``model`` where attention is split).
    Each rank scores its span (on its D block, the scores then summed over
    ``model``), keeps its partial softmax -- the max, the sum of ``exp``
    and the unnormalised ``p v`` -- and
    :func:`~repro_torch.distributed.tensor_parallel.merge_softmax` merges
    the partials over the span's axes; a cut head dim's output is gathered
    over ``model``.  Returns o (B, 1, heads, hd) on the rank's query heads."""
    if torch.is_tensor(pos) and pos.dim() > 0:
        raise ValueError("a cache cut on its sequence takes one position for every row")
    # the rank's span is picked on the host; a device-side position is
    # ROADMAP item 2
    # replint-torch: disable=TRC101 -- host position, ROADMAP item 2
    p = int(pos)
    B, s_loc, h_cache = cache_k.shape[:3]
    start = split.span(s_loc)
    d = split.dim

    def cut(t):
        return t if d is None else t.chunk(d.mp, -1)[d.rank]

    if start <= p < start + s_loc:
        cache_k[:, p - start] = cut(k)[:, 0].to(cache_k.dtype)
        cache_v[:, p - start] = cut(v)[:, 0].to(cache_v.dtype)
    gathered = _attn_split(cfg, g) and h_cache == cfg.n_kv_heads and g.mp > 1 \
        and cfg.n_kv_heads % g.mp != 0
    qa = tp.gather_over_model(q, 2, g, partial=False) if gathered else q
    qd = cut(qa)
    hq = qd.shape[2]
    group = hq // h_cache
    qf = qd.float().reshape(B, h_cache, group, -1) * (cfg.resolved_head_dim ** -0.5)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, cache_k.float())
    if d is not None:
        scores = tp.sum_over_model(scores, d)
    k_pos = start + torch.arange(s_loc, device=q.device)
    valid = k_pos <= p
    if window > 0:
        valid &= k_pos > p - window
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    e = torch.where(valid, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    l_sum = e.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", e, cache_v.float())
    for axis in split.seq:
        m, l_sum, acc = tp.merge_softmax(m, l_sum, acc, axis)
    o = (acc / l_sum[..., None]).reshape(B, 1, hq, -1).to(q.dtype)
    if d is not None:
        o = tp.gather_over_model(o, 3, d, partial=False)
    return o.chunk(g.mp, 2)[g.rank] if gathered else o


def block_verify(x, bp, window: int, cache_k, cache_v, pos, cos, sin,
                 cfg: ModelConfig, cache_ks=None, cache_vs=None, *, paged):
    """Span decode: x (B, T, d), each row's T tokens at consecutive logical
    positions starting at ``pos[b]``.

    The span's KV is written into the paged pool first (in place), so query
    t attends its own key; then per-query causal attention runs over the
    row's pages through :func:`decode_attention_mixed` (the CUDA kernel on
    the card, gather + span mask + sdpa on the CPU).  ``paged``: the step's
    ``PagedOps``, as in :func:`block_decode`."""
    int8_kv = cache_ks is not None
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, bp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if int8_kv:
        k_store, k_sc = _kv_quantize(k)
        v_store, v_sc = _kv_quantize(v)
        paged.write_span(cache_ks, k_sc, pos)
        paged.write_span(cache_vs, v_sc, pos)
    else:
        k_store, v_store = k, v
    paged.write_span(cache_k, k_store, pos)
    paged.write_span(cache_v, v_store, pos)
    o = decode_attention_mixed(q, cache_k, cache_v, paged.block_table, pos,
                               window=window, k_scale=cache_ks, v_scale=cache_vs)
    x = x + o.reshape(*x.shape[:2], -1) @ bp["wo"]
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + _ffn(h, bp, cfg)[0]


# ---------------------------------------------------------------------------------
# model-level functions
# ---------------------------------------------------------------------------------

def _lm_head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _lm_head(params, h, cfg: ModelConfig):
    """Logits in f32 (a plain matmul, as XLA runs it in JAX): every column,
    or under tensor parallelism with the vocabulary split
    (:func:`tensor_parallel.vocab_split`) the rank's block of V / mp
    columns (``lm_head`` ``P(None, "model")``, or the tied ``embed.T``)."""
    g = tp.model_group()
    if g is None:
        return (h @ _lm_head_weight(params, cfg)).float()
    name = "embed" if cfg.tie_embeddings else "lm_head"
    if tp.vocab_split(cfg, g.mp):
        tp.expect_block(params[name], model_dim(name), cfg.vocab, g)
        return tp.vocab_logits(h, _lm_head_weight(params, cfg), g)
    w = tp.whole(params[name], model_dim(name), cfg.vocab, g)
    return (h @ (w.T if cfg.tie_embeddings else w)).float()


def _embed_tokens(params, tokens, cfg: ModelConfig):
    """Rows ``tokens`` of ``embed``: under tensor parallelism with the
    vocabulary split, from the rank's rows (:func:`tensor_parallel.vocab_embed`)."""
    g = tp.model_group()
    if g is None:
        return params["embed"][tokens.long()]
    if tp.vocab_split(cfg, g.mp):
        tp.expect_block(params["embed"], model_dim("embed"), cfg.vocab, g)
        return tp.vocab_embed(params["embed"], tokens, g)
    return tp.whole(params["embed"], model_dim("embed"), cfg.vocab, g)[tokens.long()]


def _cross_entropy(logits, targets, cfg: ModelConfig):
    """:func:`~repro_torch.models.common.lm_loss` of the logits
    :func:`_lm_head` gives: over the rank's vocabulary block with the
    vocabulary split (:func:`tensor_parallel.vocab_cross_entropy`)."""
    g = tp.model_group()
    if g is not None and tp.vocab_split(cfg, g.mp):
        return tp.vocab_cross_entropy(logits, targets, g)
    return lm_loss(logits, targets)


def _embed_in(params, batch, cfg: ModelConfig):
    """The model's input (B, S, d): ``batch["embeds"]`` cast to ``cfg.dtype``
    for the embeddings input mode, else the embedded ``batch["tokens"]``."""
    if cfg.input_mode == "embeddings":
        return batch["embeds"].to(cfg.dtype)
    return _embed_tokens(params, batch["tokens"], cfg)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``, the JAX ``_remat``: ``"none"`` keeps every
    activation for the backward; ``"block"`` keeps only ``fn``'s inputs and
    recomputes the rest in the backward (``jax.checkpoint``); ``"dots"``
    keeps the matmul outputs and recomputes the rest (the JAX policy
    ``checkpoint_dots_with_no_batch_dims``).  Only where autograd records
    (grad mode on and an argument's tensor requires grad): serving and the
    oracles run ``fn`` as it is."""
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args):
        if not (torch.is_grad_enabled()
                and any(torch.is_tensor(t) and t.requires_grad for t in tree_leaves(args))):
            return fn(*args)
        if cfg.remat == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=_save_matmuls_context)
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


# the products with no batch dim (``x @ w`` reaches aten as ``mm``), the ones
# ``checkpoint_dots_with_no_batch_dims`` saves; the batched attention and
# expert products (``bmm``) are recomputed, as there
_MATMULS = frozenset({"mm", "addmm"})


def _save_matmuls_context():
    """Selective checkpointing's contexts for ``remat="dots"``: the outputs
    of :data:`_MATMULS` are saved for the backward, every other op is
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        if getattr(op, "_opname", None) in _MATMULS:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _run_blocks(params, x, cfg: ModelConfig, *, aux: bool = False, use_kernel: bool = True,
                remat: bool = False):
    """Run every block over the embedded input x (B, S, d) -> (x after ln_f,
    per-layer [(k, v)], summed aux loss: 0.0 unless ``aux``); each block
    under :func:`_remat` with ``remat``."""
    S = x.shape[1]
    cos, sin = rope_tables(torch.arange(S, device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)

    def body(x, bp, w):
        return block_forward(x, bp, w, cos, sin, cfg, aux=aux, use_kernel=use_kernel)

    if remat:
        body = _remat(body, cfg)
    kvs = []
    total = 0.0
    for bp, w in zip(params["blocks"], layer_windows(cfg)):
        x, kv, a = body(x, bp, w)
        kvs.append(kv)
        total = total + a
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kvs, total


# replint-torch: traced -- the prefill and train steps' forward
def forward(params, batch, cfg: ModelConfig, *, use_kernel: bool = True):
    """Full-sequence forward -> (logits (B, S, V) f32, aux): the MoE layers'
    summed load-balance loss (0.0 without MoE).  Each block runs under
    :func:`_remat`.  ``use_kernel`` (the default: the greedy oracle of the
    tests and the serving checks) takes the flash kernel on the card;
    :func:`loss_fn` passes False (:func:`_prefill_attention`)."""
    x, _, aux = _run_blocks(params, _embed_in(params, batch, cfg), cfg, aux=True,
                            use_kernel=use_kernel, remat=True)
    return _lm_head(params, x, cfg), aux


# replint-torch: traced -- the train step
def loss_fn(params, batch, cfg: ModelConfig):
    """``(loss, metrics)`` of the JAX ``loss_fn``: the next-token
    cross-entropy of :func:`~repro_torch.models.common.lm_loss` over
    ``batch["targets"]`` plus 0.01 times the MoE load-balance loss, through
    :func:`forward` without the kernels (autograd runs through it on either
    device).  metrics: ``{"ce", "aux"}``.  Under tensor parallelism the
    cross-entropy runs over the rank's vocabulary block
    (:func:`_cross_entropy`)."""
    logits, aux = forward(params, batch, cfg, use_kernel=False)
    ce = _cross_entropy(logits, batch["targets"], cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# replint-torch: traced -- called from the serving engine's step
def prefill(params, batch, cfg: ModelConfig, max_len: int | None = None, *,
            last_idx=None, cache_split=None):
    """Run the prompt -> (last-position logits (B, 1, V) f32, cache dict of
    (L, B, max_len, Hkv, hd) leaves).

    ``last_idx``: position of each row's true last prompt token, an int or
    a 0-d tensor (one for all rows) or a (B,) tensor (batched bucketed
    prefill: rows padded to one power-of-two length, each selecting its own
    last position; the causal mask keeps positions <= last_idx independent
    of the padding).  None takes the last position.  The cache is padded to
    ``max_len``; an int8 cache is quantized after attention, which runs on
    the unquantized K/V.

    Under tensor parallelism (``tensor_parallel.set_tp_mesh``, the rank's
    blocks of the parameters) the logits are **the rank's vocabulary
    block**, (B, 1, V / mp), where the vocabulary is split; the cache holds
    the kv heads the rank holds (its own where they divide ``model``, else
    all of them), cut further by ``cache_split``
    (:func:`tensor_parallel.cache_split` of the rules' placement) on its
    sequence and head dim."""
    x, kvs, _ = _run_blocks(params, _embed_in(params, batch, cfg), cfg)
    B, S = x.shape[:2]
    max_len = max_len or S
    if last_idx is None:
        x_last = x[:, -1:]
    elif not torch.is_tensor(last_idx) or last_idx.dim() == 0:
        # model-level callers only: the engine passes a (B,) tensor (below)
        # replint-torch: disable=TRC101 -- scalar last_idx, not the engine
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
        cache = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    else:
        cache = {"k": ks.to(cfg.dtype), "v": vs.to(cfg.dtype)}
    if cache_split is not None:
        cache = {name: cut_cache(t, cache_split, head_dim=not name.endswith("_scale"))
                 for name, t in cache.items()}
    return logits, cache


def cut_cache(t, split, *, head_dim: bool = True):
    """The rank's block of a whole-sequence cache leaf (L, B, S, H, D)
    under a :class:`~repro_torch.distributed.tensor_parallel.CacheSplit`:
    its span of S and (``head_dim``) its block of D."""
    if split.seq:
        n = 1
        for a in split.seq:
            n *= a.mp
        s_loc = t.shape[2] // n
        start = split.span(s_loc)
        t = t[:, :, start:start + s_loc]
    if head_dim and split.dim is not None:
        t = t.chunk(split.dim.mp, -1)[split.dim.rank]
    return t.contiguous()


# replint-torch: traced -- called from the serving engine's decode loop
def decode_step(params, cache, token, pos, cfg: ModelConfig, *, block_table=None,
                cache_split=None):
    """One token per row: token (B, 1), or (B, 1, d) embeddings for the
    embeddings input mode.  With ``block_table`` (B, n) the
    cache leaves are paged pools (L, P, ps, ...) and ``pos`` (B,) holds each
    row's logical position; without, they are the dense (L, B, S_max, ...)
    cache of :func:`init_cache` and ``pos`` is a scalar (every row) or a
    (B,) vector.  Returns ``(logits (B, 1, V) f32, cache)``; the token's KV
    is written in place and the same dictionary is returned.

    Under tensor parallelism the logits are the rank's vocabulary block
    where the vocabulary is split, and the cache is the rank's block under
    the rules: ``cache_split`` (:func:`tensor_parallel.cache_split`) where
    they cut its sequence or head dim (:func:`block_decode`)."""
    if cfg.input_mode == "embeddings" and token.dim() == 3:
        x = token.to(cfg.dtype)
    else:
        x = _embed_tokens(params, token, cfg)
    if torch.is_tensor(pos) and pos.dim() == 1:
        cos, sin = rope_tables(pos.long()[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    else:
        # model-level callers only: the engine's loops pass a (B,) vector (above)
        # replint-torch: disable=TRC101 -- scalar pos, not the engine
        cos, sin = rope_tables(torch.tensor([int(pos)], device=x.device),
                               cfg.resolved_head_dim, cfg.rope_theta)
    int8_kv = cfg.kv_cache_dtype == "int8"
    paged = kvcache.PagedOps(block_table) if block_table is not None else None
    for layer, (bp, w) in enumerate(zip(params["blocks"], layer_windows(cfg))):
        x = block_decode(x, bp, w, cache["k"][layer], cache["v"][layer], pos,
                         cos, sin, cfg,
                         cache_ks=cache["k_scale"][layer] if int8_kv else None,
                         cache_vs=cache["v_scale"][layer] if int8_kv else None,
                         paged=paged, split=cache_split)
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


# replint-torch: traced -- called from the serving engine's mixed step
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
    x = _embed_tokens(params, tokens, cfg)
    T = tokens.shape[1]
    span = torch.arange(T, device=pos.device)
    cos, sin = rope_tables(pos.long()[:, None] + span[None, :],
                           cfg.resolved_head_dim, cfg.rope_theta)
    int8_kv = cfg.kv_cache_dtype == "int8"
    paged = kvcache.PagedOps(block_table)
    for layer, (bp, w) in enumerate(zip(params["blocks"], layer_windows(cfg))):
        x = block_verify(x, bp, w, cache["k"][layer], cache["v"][layer], pos,
                         cos, sin, cfg,
                         cache_ks=cache["k_scale"][layer] if int8_kv else None,
                         cache_vs=cache["v_scale"][layer] if int8_kv else None,
                         paged=paged)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    tok, lp = fused_lmhead_greedy(x, _lm_head_weight(params, cfg))
    return tok, lp, cache


__all__ = ["init_params", "init_cache", "forward", "loss_fn", "prefill", "decode_step",
           "verify_step", "layer_windows", "block_forward", "block_decode",
           "block_verify", "cut_cache"]
