"""Train step: loss -> grad -> (optional microbatch accumulation) -> AdamW.

Counterpart of ``repro.training.train_step`` on one device.  Gradients
come from ``torch.autograd.grad`` of ``Model.loss_fn`` with respect to the
parameter leaves; ``requires_grad`` is set only inside the step, on
detached aliases of the leaves, so the caller's parameters, and the ones
the step returns, never require grad (serving them launches the kernels,
which refuse tensors that do: :func:`repro_torch.kernels.refuse_grad`).
``Model.loss_fn`` runs without the kernels on every device, as the JAX
package trains with ``use_kernel=False``: no kernel launches in a step.

A step exposes its two halves, ``grads_of(params, batch) -> (loss,
grads)`` and ``update(params, grads, opt_state, grad_norm=None)``, so
:func:`repro_torch.distributed.sharding.sharded_step` can run it over a
mesh (the JAX package's ``jax.jit(step, in_shardings=...)``, with
:func:`train_state_shardings`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import batch_sharding, param_sharding
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.pytree import tree_leaves, tree_unflatten


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

    ``compress_pod_grads``: the JAX step imports ``int8_pod_allreduce``,
    which ``repro.distributed.compression`` does not define, so it raises
    ImportError at its first call; the port's step does the same (the
    scheme itself is :mod:`repro_torch.distributed.compression`).
    """
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

    def update(params, grads, opt_state, grad_norm=None):
        if compress_pod_grads:
            from repro_torch.distributed.compression import int8_pod_allreduce
            grads, opt_state = int8_pod_allreduce(grads, opt_state)
        return adamw_update(params, grads, opt_state, opt_cfg, donate=donate,
                            grad_norm=grad_norm)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        loss, grads = grads_of(params, batch)
        params, opt_state, om = update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    train_step.grads_of = grads_of
    train_step.update = update
    return train_step


def train_state_shardings(model: Model, mesh, batch_abstract):
    """``(param_sh, opt_sh, batch_sh)`` trees of
    :class:`~repro_torch.distributed.sharding.NamedSharding` for
    :func:`~repro_torch.distributed.sharding.sharded_step`: the parameters
    under the rules, AdamW's ``m``/``v`` mirroring them with ``step``
    replicated, and the batch (``batch_abstract``: any tree of tensors,
    meta tensors or arrays; only shapes are read)."""
    p_abs = model.abstract_params()
    p_sh = param_sharding(p_abs, mesh)
    o_sh = param_sharding(adamw_init(p_abs), mesh)  # m/v mirror params; step replicates
    b_sh = batch_sharding(batch_abstract, mesh)
    return p_sh, o_sh, b_sh


class TrainState:
    """Thin convenience holder used by the example drivers."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


__all__ = ["loss_and_grads", "make_train_step", "train_state_shardings", "TrainState"]
