"""Mixture-of-Experts layer: top-k routing with capacity-bounded sort-based
dispatch (GShard-style dropping), as plain tensor functions.

Counterpart of ``repro.models.moe``, with its semantics exactly: the
(token, expert) pairs are sorted by expert id (stable), each pair's rank
within its expert group comes from the sorted run starts, and pairs beyond
the expert capacity are dropped (their combine weight is zero, so the
residual path carries them).  The JAX module's ``_constrain`` is a sharding
hint for the expert-parallel layout and has no counterpart here yet: it
comes with ``moe_ep`` (ROADMAP.md Queue 1 item 8b).

Every product runs outside any hand-written kernel, as the JAX package runs
its ``einsum``s outside any Pallas kernel.  The combine sums each token's
contributions in a fixed order, so two runs give the same bits on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import MoEConfig


def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """x: (T, D) -> (weights (T, k) f32, experts (T, k) int64, router logits
    (T, E) f32 for the aux loss).

    ``jax.lax.top_k`` puts the lower index first among equal values; a
    stable descending sort does the same, so ties pick the same experts in
    the same order."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[:, :cfg.top_k], experts[:, :cfg.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, experts, logits


def load_balance_loss(router_logits: torch.Tensor, experts: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * p_e."""
    p_mean = torch.softmax(router_logits, dim=-1).mean(0)
    occupancy = F.one_hot(experts[:, 0], n_experts).float().mean(0)
    return n_experts * torch.sum(occupancy * p_mean)


def capacity(T: int, cfg: MoEConfig) -> int:
    """Slots per expert: the capacity factor's share of the T * k pairs,
    with a floor of 4 (or T * k) that keeps small decode batches drop-free."""
    k = cfg.top_k
    return max(int(T * k * cfg.capacity_factor / cfg.n_experts), min(4, T * k))


def dispatch(experts: torch.Tensor, C: int, n_experts: int):
    """The sort-based dispatch plan of (T, k) expert choices: ``(order,
    expert, rank, keep)`` over the T * k pairs in stable expert order --
    ``order`` indexes the flattened pairs, ``rank`` is each pair's slot in
    its expert group and ``keep`` is ``rank < C``."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(n_experts, device=se.device), side="left")
    rank = torch.arange(se.numel(), device=se.device) - starts[se]
    return order, se, rank, rank < C


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig, *, aux: bool = True):
    """x: (T, D).  params: router (D, E), w_gate/w_up (E, D, F), w_down (E, F, D).

    Returns (out (T, D) in x's dtype, aux_loss scalar).  ``aux=False`` skips
    the load-balance loss (None in its place): serving discards it, and in
    eager PyTorch, unlike under jit, a dead result still costs launches."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    weights, experts, logits = router_topk(x, params["router"], cfg)
    order, se, rank, keep = dispatch(experts, C, E)
    st = order // k                                   # each sorted pair's token

    # ---- dispatch: the (E, C, D) expert inputs; a kept pair owns its slot, and
    # every dropped pair writes into one spare row past the buffer (JAX adds a
    # zero at (0, 0) instead, which leaves the buffer as this does)
    slot = torch.where(keep, se * C + rank, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]
    buf = buf[:E * C].view(E, C, D)

    # ---- expert FFN, batched over E
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    y = torch.bmm(h, params["w_down"]).reshape(E * C, D)

    # ---- combine: each pair's output scaled in f32, dropped pairs zero; a
    # token's k terms are added one by one in ascending expert order, the
    # order of the JAX scatter-add over the expert-sorted pairs
    contrib = torch.where(keep[:, None], y[torch.where(keep, slot, 0)].float(), 0.0)
    contrib = contrib * weights.reshape(-1)[order][:, None]
    by_pair = torch.empty_like(contrib)
    by_pair[order] = contrib                          # back to (token, choice) order
    by_pair = by_pair.view(T, k, D)
    asc = torch.argsort(experts, dim=1)               # a token's experts are distinct
    by_pair = torch.gather(by_pair, 1, asc[:, :, None].expand(T, k, D))
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + by_pair[:, j]
    return out.to(x.dtype), load_balance_loss(logits, experts, E) if aux else None


__all__ = ["moe_ffn", "router_topk", "load_balance_loss", "capacity", "dispatch"]
