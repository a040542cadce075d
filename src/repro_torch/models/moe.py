"""Mixture-of-Experts layer: top-k routing with capacity-bounded sort-based
dispatch (GShard-style dropping), as plain tensor functions.

Counterpart of ``repro.models.moe``, with its semantics exactly: the
(token, expert) pairs are sorted by expert id (stable), each pair's rank
within its expert group comes from the sorted run starts, and pairs beyond
the expert capacity are dropped (their combine weight is zero, so the
residual path carries them).

Where the layers route: without an expert-parallel mesh, :func:`moe_ffn`
routes, and fills each expert's capacity, over every token the caller
passes (one device: the whole batch; in the sharded step, which runs the
model on each rank's data shard, that shard).  With one set
(:func:`repro_torch.distributed.moe_ep.set_ep_mesh`, a mesh with a
``model`` axis, and ``REPRO_MOE_EP`` unset or ``1``), ``lm._ffn`` takes
:func:`~repro_torch.distributed.moe_ep.moe_ffn_ep` instead, which routes
over each data shard's tokens, as the JAX package's ``moe_ep`` branch does.
The JAX module's ``_constrain`` (sharding hints on the dispatch buffers,
switched by ``REPRO_MOE_CONSTRAIN``) has its counterpart in that explicit
layout: the experts stay on their ranks and the tokens on their data
shard.  ``REPRO_MOE_CONSTRAIN`` has no effect in the port.

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
    E = cfg.n_experts
    weights, experts, logits = router_topk(x, params["router"], cfg)
    out = expert_outputs(x, params, weights, experts, capacity(T, cfg), E)
    return out.to(x.dtype), load_balance_loss(logits, experts, E) if aux else None


def expert_outputs(x: torch.Tensor, params: dict, weights: torch.Tensor,
                   experts: torch.Tensor, C: int, n_experts: int, *, first: int = 0,
                   n_local: int | None = None) -> torch.Tensor:
    """The float32 (T, D) combine of the routed pairs that go to experts
    ``first .. first + n_local - 1`` (all ``n_experts`` where ``n_local`` is
    None), through ``params``' w_gate / w_up (n_local, D, F) and w_down
    (n_local, F, D): the whole layer's output without an expert split,
    one rank's partial under one (:mod:`repro_torch.distributed.moe_ep`).
    The plan is :func:`dispatch` over all ``n_experts``, so capacity and
    drops are the whole layer's; a pair of another rank's expert adds 0."""
    T, D = x.shape
    k = experts.shape[1]
    n_local = n_experts if n_local is None else n_local
    order, se, rank, keep = dispatch(experts, C, n_experts)
    if n_local != n_experts:
        keep = keep & (se >= first) & (se < first + n_local)
    st = order // k                                   # each sorted pair's token

    # ---- dispatch: the (n_local, C, D) expert inputs; a kept pair owns its
    # slot, and every other pair writes into one spare row past the buffer (JAX
    # adds a zero at (0, 0) instead, which leaves the buffer as this does)
    slot = torch.where(keep, (se - first if first else se) * C + rank, n_local * C)
    buf = torch.zeros((n_local * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]
    buf = buf[:n_local * C].view(n_local, C, D)

    # ---- expert FFN, batched over the local experts
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    y = torch.bmm(h, params["w_down"]).reshape(n_local * C, D)

    # ---- combine: each pair's output scaled in f32, other pairs zero; a
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
    return out

__all__ = ["moe_ffn", "router_topk", "load_balance_loss", "capacity", "dispatch",
           "expert_outputs"]
