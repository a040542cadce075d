"""Int8 error-feedback gradient compression for the cross-pod all-reduce.

Counterpart of ``repro.distributed.compression``.  Cross-pod links are the
scarcest bandwidth at multi-pod scale, so the pod-axis gradient reduction
is the place to compress.  Scheme: per-leaf symmetric int8 quantization
with error feedback (the quantization residual is carried beside the
optimizer state and added back next step), all-reduced over the 'pod'
axis only -- the within-pod reduction stays full precision.

The arithmetic is the JAX package's as it is: what is all-reduced over the
pod group is the dequantized float32 ``q * scale``, divided by the pod
count, so float32 values cross the link, not int8 payloads (an int8 wire
format is later work).  The JAX function maps the pod axis by hand with
``shard_map`` and leaves 'data'/'model' to the partitioner; here each rank
takes its ('pod', 'data') shard of the batch, averages its gradient over
its 'data' group in full precision, and compresses over its 'pod' group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    _avg,
    _local,
    batch_sharding,
    data_axes,
    data_mean,
)
from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.train_step import loss_and_grads


def _quantize(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def compress_allreduce_pod(grads, error_state, *, group):
    """quantize(grad + error) -> all-reduce over ``group`` (the pod axis's
    process group) -> / pod count; returns ``(reduced_grads,
    new_error_state)``, float32 trees.  ``grads``: plain tensors, each
    rank's whole pod-local gradient; every rank of ``group`` must pass the
    same tree structure."""
    n = float(dist.get_world_size(group))

    def one(g, e):
        g = g.to(torch.float32) + e
        q, scale = _quantize(g)
        total = q.to(torch.float32) * scale
        dist.all_reduce(total, group=group)
        new_e = g - _dequantize(q, scale)
        return total / n, new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error_state))]
    return (tree_unflatten(grads, [t for t, _ in out]),
            tree_unflatten(grads, [e for _, e in out]))


def init_error_state(params_abstract, *, device=None):
    """float32 zeros shaped like each parameter, on ``device`` (each
    parameter's own where None)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device if device is None else device),
                    params_abstract)


def make_compressed_grad_fn(loss_fn, mesh):
    """Returns ``grad_fn(params, batch, error_state) -> (loss, grads,
    new_error)`` where the pod-axis reduction is int8-compressed with error
    feedback.

    ``params``: the whole parameters (plain tensors, or DTensors, which
    are gathered); ``batch``: the global batch every rank holds, of which
    each rank takes its ('pod', 'data') shard; ``error_state``: this rank's
    float32 residuals (:func:`init_error_state`).  Inside a pod the loss and
    the gradients are the pod batch's mean (:func:`data_mean` over 'data',
    as the JAX partitioner gives it); across pods, the mean of the pods'
    (the loss a ``pmean``, the gradients compressed).  They come back whole
    and equal on every rank."""
    if "pod" not in mesh.mesh_dim_names:
        raise ValueError(f"make_compressed_grad_fn needs a 'pod' axis; mesh axes "
                         f"{mesh.mesh_dim_names}")
    pod = mesh.get_group("pod")
    in_pod = tuple(a for a in data_axes(mesh) if a != "pod")

    def fn(params, batch, error_state):
        params = tree_map(lambda p: p.full_tensor() if isinstance(p, DTensor) else p, params)
        local = tree_map(_local, batch, batch_sharding(batch, mesh))
        loss, _, grads = loss_and_grads(loss_fn, params, local)
        loss, grads = data_mean(loss, grads, local, mesh, in_pod)   # full precision
        grads, new_err = compress_allreduce_pod(grads, error_state, group=pod)
        return _avg(loss, mesh, ("pod",)).to_local(), grads, new_err

    return fn


__all__ = ["compress_allreduce_pod", "init_error_state", "make_compressed_grad_fn"]
