"""Seeded weights, drawn on the device in the type they are served in.

One ``normal_`` call per kind of leaf for all layers at once (every
layer's ``wq`` is one (L, d, Hq * hd) tensor, and so on), from one
``torch.Generator`` on the device; each layer's leaf is a view of its
stack.  The tree has the layout ``repro_torch.models.lm`` takes (its
``init_params``), with the port's standard deviations: fan_in ** -0.5,
``w_down`` over its own fan-in, the embedding 0.02.  Two departures make
the check see more of the model than the port's own init would: norm gains
are 1 + N(0, 0.1) rather than ones, and q / k / v biases N(0, 0.02) rather
than zeros.  The same tensors go to the engine and to the plain reference.
"""
from __future__ import annotations

import torch


def _normal(gen, shape, dtype, std, mean=0.0):
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    return t.normal_(mean, std, generator=gen)


def make_params(cfg, seed: int, device) -> dict:
    """``cfg`` a ``repro_torch`` ModelConfig of the dense or moe family."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    L, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    stacks = {
        "ln1": _normal(gen, (L, d), dt, 0.1, 1.0),
        "ln2": _normal(gen, (L, d), dt, 0.1, 1.0),
        "wq": _normal(gen, (L, d, Hq * hd), dt, d ** -0.5),
        "wk": _normal(gen, (L, d, Hkv * hd), dt, d ** -0.5),
        "wv": _normal(gen, (L, d, Hkv * hd), dt, d ** -0.5),
        "wo": _normal(gen, (L, Hq * hd, d), dt, (Hq * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        stacks["bq"] = _normal(gen, (L, Hq * hd), dt, 0.02)
        stacks["bk"] = _normal(gen, (L, Hkv * hd), dt, 0.02)
        stacks["bv"] = _normal(gen, (L, Hkv * hd), dt, 0.02)
    ffn = {}
    if cfg.moe:
        E, f = cfg.moe.n_experts, cfg.moe.d_expert
        ffn = {"router": _normal(gen, (L, d, E), torch.float32, d ** -0.5),
               "w_gate": _normal(gen, (L, E, d, f), dt, d ** -0.5),
               "w_up": _normal(gen, (L, E, d, f), dt, d ** -0.5),
               "w_down": _normal(gen, (L, E, f, d), dt, f ** -0.5)}
    else:
        f = cfg.d_ff
        ffn = {"w_gate": _normal(gen, (L, d, f), dt, d ** -0.5),
               "w_up": _normal(gen, (L, d, f), dt, d ** -0.5),
               "w_down": _normal(gen, (L, f, d), dt, f ** -0.5)}
    key = "moe" if cfg.moe else "mlp"
    blocks = []
    for i in range(L):
        b = {k: v[i] for k, v in stacks.items()}
        b[key] = {k: v[i] for k, v in ffn.items()}
        blocks.append(b)
    params = {"embed": _normal(gen, (cfg.vocab, d), dt, 0.02),
              "blocks": blocks,
              "ln_f": _normal(gen, (d,), dt, 0.1, 1.0)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, cfg.vocab), dt, d ** -0.5)
    return params


__all__ = ["make_params"]
