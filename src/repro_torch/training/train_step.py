"""Train step: loss -> grad -> (optional microbatch accumulation) -> AdamW.

Counterpart of ``repro.training.train_step`` on one device.  Gradients
come from ``torch.autograd.grad`` of ``Model.loss_fn`` with respect to the
parameter leaves; ``requires_grad`` is set only inside the step, on
detached aliases of the leaves, so the caller's parameters, and the ones
the step returns, never require grad (serving them launches the kernels,
which refuse tensors that do: :func:`repro_torch.kernels.refuse_grad`).
``Model.loss_fn`` runs without the kernels on every device, as the JAX
package trains with ``use_kernel=False``: no kernel launches in a step.

The int8 cross-pod gradient compression and the pjit shardings need the
port's sharding, ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.pytree import tree_leaves, tree_unflatten

_NO_SHARDING = ("needs the port's sharding (repro_torch.distributed), which is not "
                "ported yet: ROADMAP.md Queue 1 item 8")


def loss_and_grads(loss_fn: Callable, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: the loss
    detached, the gradients a tree congruent with ``params`` in each
    parameter's dtype (``jax.value_and_grad(loss_fn, has_aux=True)``)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    compress_pod_grads: bool = False, donate: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics: ``{"loss", "lr", "grad_norm"}``, 0-d tensors.

    ``batch``: {name: array or tensor}, moved to the model's device.  With
    ``microbatches`` > 1 the batch is split on its leading dim and the
    microbatch gradients are summed into float32 zeros, then scaled by
    1 / microbatches with the loss (the JAX ``lax.scan``).  ``donate``
    updates the parameters and the optimizer state in place
    (:func:`~repro_torch.optim.adamw.adamw_update`), as the JAX train driver
    donates them to its jitted step.
    """
    if compress_pod_grads:
        raise NotImplementedError("compress_pod_grads " + _NO_SHARDING)
    loss_fn = model.loss_fn

    def grads_of(params, batch):
        if microbatches <= 1:
            loss, _, grads = loss_and_grads(loss_fn, params, batch)
            return loss, grads
        split = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                 for k, v in batch.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in tree_leaves(params)]
        for i in range(microbatches):
            loss, _, g = loss_and_grads(loss_fn, params, {k: v[i] for k, v in split.items()})
            loss_acc = loss_acc + loss
            for acc, gi in zip(g_acc, tree_leaves(g)):
                acc.add_(gi)
        inv = 1.0 / microbatches
        return loss_acc * inv, tree_unflatten(params, [g * inv for g in g_acc])

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        loss, grads = grads_of(params, batch)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                             donate=donate)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def train_state_shardings(model: Model, mesh, batch_abstract):
    """The JAX package's ``(param_sh, opt_sh, batch_sh)`` for pjit: not on
    one card."""
    raise NotImplementedError("train_state_shardings " + _NO_SHARDING)


class TrainState:
    """Thin convenience holder used by the example drivers."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


__all__ = ["loss_and_grads", "make_train_step", "train_state_shardings", "TrainState"]
