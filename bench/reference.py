"""The plain reference: the decoder's forward pass over whole sequences in
float32 with TF32 off, in plain PyTorch.

It reads the configuration file and the weights that ``bench.weights``
made (upcast from bf16, which float32 holds exactly), and nothing of the
program: no kernel, cache, batching or helper of ``repro_torch``.  The
equations are the port's (``repro_torch.models.lm`` and ``moe``): RMSNorm,
q / k / v projections with biases where the configuration has them,
rotary embedding on the two halves of each head, causal grouped-query
attention, SwiGLU MLP or the top-k mixture of experts (dropless; the top-k
weights renormalised where ``norm_topk_prob`` says so), a final RMSNorm and
the head (tied: the embedding).

``fp8=True`` is the control: the two operands of every product with a
weight matrix (the projections, the MLP or experts, the head) rounded to
float8 e4m3 (one scale per tensor, its absolute maximum at 448) before
they are multiplied, the rest (the router, attention's scores and values)
as above.

The work goes layer by layer over all the sequences, so only one layer's
weights are held in float32 at a time.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@dataclass(frozen=True)
class RefModel:
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    eps: float
    theta: float
    tied: bool
    moe: bool
    top_k: int
    norm_topk: bool

    @classmethod
    def of(cls, conf: dict) -> "RefModel":
        moe = conf["port"]["family"] == "moe"
        return cls(layers=conf["num_hidden_layers"], heads=conf["num_attention_heads"],
                   kv_heads=conf["num_key_value_heads"],
                   head_dim=conf["hidden_size"] // conf["num_attention_heads"],
                   eps=float(conf["rms_norm_eps"]), theta=float(conf["rope_theta"]),
                   tied=bool(conf["tie_word_embeddings"]), moe=moe,
                   top_k=conf["num_experts_per_tok"] if moe else 0,
                   norm_topk=bool(conf.get("norm_topk_prob", True)))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x, w, fp8: bool):
    return _fp8(x) @ _fp8(w) if fp8 else x @ w


def _f32(t):
    return t.to(torch.float32)


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * _f32(g)


def _rope(x, pos, theta):
    """x (S, H, hd); rotate the two halves of each head by pos * freq."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, block: int = 512):
    """Causal attention, q (S, Hq, hd), k / v (S, Hkv, hd), in query blocks."""
    S, Hq, hd = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)         # (Hq, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(S, device=q.device)
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        qb = q[lo:hi].transpose(0, 1) * hd ** -0.5             # (Hq, b, hd)
        sc = qb @ k[:, :hi].transpose(1, 2)                    # (Hq, b, hi)
        mask = keys[None, :hi] <= torch.arange(lo, hi, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[lo:hi] = (torch.softmax(sc, dim=-1) @ v[:, :hi]).transpose(0, 1)
    return out


def _moe(h, p, m: RefModel, fp8: bool):
    """Every token through its top-k experts, weighted by the router."""
    logits = h @ _f32(p["router"])
    probs = torch.softmax(logits, dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :m.top_k], e[:, :m.top_k]
    if m.norm_topk:
        w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for ex in torch.unique(e).tolist():
        tok, slot = (e == ex).nonzero(as_tuple=True)
        x = h[tok]
        y = _mm(F.silu(_mm(x, _f32(p["w_gate"][ex]), fp8)) * _mm(x, _f32(p["w_up"][ex]), fp8),
                _f32(p["w_down"][ex]), fp8)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def _layer(x, bp, m: RefModel, fp8: bool):
    S = x.shape[0]
    pos = torch.arange(S, device=x.device)
    h = _rms(x, bp["ln1"], m.eps)
    q = _mm(h, _f32(bp["wq"]), fp8)
    k = _mm(h, _f32(bp["wk"]), fp8)
    v = _mm(h, _f32(bp["wv"]), fp8)
    if "bq" in bp:
        q, k, v = q + _f32(bp["bq"]), k + _f32(bp["bk"]), v + _f32(bp["bv"])
    q = _rope(q.view(S, m.heads, m.head_dim), pos, m.theta)
    k = _rope(k.view(S, m.kv_heads, m.head_dim), pos, m.theta)
    o = _attention(q, k, v.view(S, m.kv_heads, m.head_dim))
    x = x + _mm(o.reshape(S, -1), _f32(bp["wo"]), fp8)
    h = _rms(x, bp["ln2"], m.eps)
    if m.moe:
        return x + _moe(h, bp["moe"], m, fp8)
    mlp = bp["mlp"]
    return x + _mm(F.silu(_mm(h, _f32(mlp["w_gate"]), fp8)) * _mm(h, _f32(mlp["w_up"]), fp8),
                   _f32(mlp["w_down"]), fp8)


def logits(params: dict, m: RefModel, seqs, rows, *, fp8: bool = False):
    """Float32 logits of each sequence in ``seqs`` (1-D int tensors on the
    weights' device) at the positions ``rows[i]`` (1-D int tensors): the
    next-token logits after each of those positions."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            xs = [_f32(params["embed"][s.long()]) for s in seqs]
            for bp in params["blocks"]:
                xs = [_layer(x, bp, m, fp8) for x in xs]
            head = _f32(params["embed"]).T if m.tied else _f32(params["lm_head"])
            out = []
            for x, r in zip(xs, rows):
                h = _rms(x[r.long()], params["ln_f"], m.eps)
                out.append(_mm(h, head, fp8))
            return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


__all__ = ["RefModel", "logits"]
