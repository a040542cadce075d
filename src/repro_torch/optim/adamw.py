"""AdamW with a cosine schedule, as plain tensor functions (no external
deps).

Counterpart of ``repro.optim.adamw``.  The optimizer state is a tree
congruent with the parameters (:mod:`repro_torch.pytree`): float32 ``m``
and ``v`` whatever the parameters' dtype, and an int32 ``step``.  The
schedule, the clip scale and the bias corrections are float32 tensors on
the state's device, as the JAX package computes them, not Python doubles;
each update is computed in float32 and cast back to its parameter's dtype.
The JAX optimizer is XLA, not a Pallas kernel, so this one is torch ops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step):
    """Linear warm-up then cosine decay to 0: a float32 tensor (``step``: an
    int or an integer tensor)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_init(params):
    """``{"m", "v"}``: float32 zeros shaped like each parameter, on its
    device; ``"step"``: an int32 0 on the first parameter's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = [g.float().square().sum() for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


_RUN_ELEMENTS = 1 << 26


def _groups(n_elements: list[int]) -> list[list[int]]:
    """Leaf indices in runs of at most ``_RUN_ELEMENTS`` elements (a larger
    leaf alone), so each float32 temporary of a run takes ~256 MB at most
    beyond its largest leaf."""
    groups, cur, size = [], [], 0
    for i, n in enumerate(n_elements):
        if cur and size + n > _RUN_ELEMENTS:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return groups + ([cur] if cur else [])


def adamw_update(params, grads, state, cfg: AdamWConfig, *, donate: bool = False,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW step: ``(params, state, {"lr", "grad_norm"})``.

    The gradients are clipped to a global norm of ``cfg.grad_clip``; the
    metrics report the norm before clipping.  ``grad_norm``: that norm where
    the caller has it (a sharded step's norm over every shard, of which
    ``grads`` holds this rank's), else :func:`global_norm` of ``grads``.  Without ``donate`` the
    inputs are left as they are and new trees are returned, as in the JAX
    package; with it, each parameter and moment is overwritten in place and
    the same tensors come back (``jax.jit(..., donate_argnums=(0, 1))`` of
    the JAX train driver), so a full-width model holds one copy of its
    state.  The update runs as ``torch._foreach_*`` ops over runs of leaves
    (:func:`_groups`), each op the JAX update's, in its order.
    """
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    P, M, V = tree_leaves(params), tree_leaves(state["m"]), tree_leaves(state["v"])
    G = tree_leaves(grads)
    new_p, new_m, new_v = list(P), list(M), list(V)
    for idx in _groups([p.numel() for p in P]):
        p, m, v = [P[i] for i in idx], [M[i] for i in idx], [V[i] for i in idx]
        g = torch._foreach_mul([G[i].float() for i in idx], scale)
        if not donate:                                 # fresh moments, inputs kept
            m, v = torch._foreach_mul(m, 1.0), torch._foreach_mul(v, 1.0)
        torch._foreach_mul_(m, b1)                     # m = b1 m + (1 - b1) g
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(v, b2)                     # v = b2 v + (1 - b2) g^2
        g2 = torch._foreach_mul(g, g)
        del g
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_add_(v, g2)
        del g2
        den = torch._foreach_div(v, bc2)               # sqrt(v / bc2) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(m, bc1)             # (m / bc1) / den + wd p
        torch._foreach_div_(delta, den)
        del den
        pf = [t.float() for t in p]
        torch._foreach_add_(delta, torch._foreach_mul(pf, cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        pf = torch._foreach_sub(pf, delta)             # p - lr delta, cast back
        del delta
        if donate:
            torch._foreach_copy_(p, pf)
        else:
            pf = [t.to(q.dtype) for t, q in zip(pf, p)]
        for k, i in enumerate(idx):
            new_p[i] = p[k] if donate else pf[k]
            new_m[i], new_v[i] = m[k], v[k]
    if donate:
        state["step"].copy_(step)
        step = state["step"]
    new_state = {"m": tree_unflatten(state["m"], new_m), "v": tree_unflatten(state["v"], new_v),
                 "step": step}
    return tree_unflatten(params, new_p), new_state, {"lr": lr, "grad_norm": gnorm}


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr", "global_norm"]
