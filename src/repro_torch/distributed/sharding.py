"""Sharding rules: parameter-path patterns -> placements on a device mesh
(DP/TP/EP/SP), and the sharded train step.

Counterpart of ``repro.distributed.sharding``.  The rules are the JAX
module's, leaf by leaf: each gives the ``PartitionSpec`` the JAX package
gives (one entry a tensor dim: ``None``, a mesh axis name, or a tuple of
them), held in a :class:`NamedSharding`, whose ``placements`` are that spec
as ``torch.distributed.tensor`` placements on a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``: a
dim named by an axis is ``Shard(dim)`` on that mesh dim, every other mesh
dim ``Replicate()``.  A tuple such as ``("pod", "data")`` on one dim is
``Shard(dim)`` on each of those mesh dims, in the mesh's order, so the rank
at mesh coordinate (p, d) holds block ``p * D + d``, as JAX places it.

Layout summary (model axis = "model", batch over ("pod", "data")):

* vocab/embedding: vocab-sharded; lm_head column-sharded;
* attention: Q/K/V column-sharded by head, O row-sharded (Megatron layout);
* MLP: gate/up column-, down row-sharded;
* MoE: experts sharded on "model" (EP); router replicated;
* Mamba: z/x/dt head-sharded, B/C (group-shared) replicated, out row-sharded;
* KV caches: head-sharded when kv_heads % model == 0, else head_dim-sharded;
* long-context (batch 1): KV *sequence* sharded on "data" (SP).

A dim that does not divide its mesh axis is replicated, as in the JAX
package: no shard is ever uneven.  The rules read only the mesh's axis
names and sizes, so they also run on an :class:`AbstractMesh` (the
counterpart of ``jax.sharding.AbstractMesh``), with no process group.

Trees: the port keeps a model's ``blocks`` (and whisper's ``enc_blocks`` /
``dec_blocks``) as a list of per-layer dictionaries, where the JAX tree
stacks each leaf on a leading layer dim.  A per-layer leaf's spec is the
JAX spec of its stacked leaf without that leading (always replicated) dim.

The sharded step (:func:`sharded_step`) is the counterpart of
``jax.jit(step, in_shardings=..., out_shardings=...)``.  Its computation
layout differs from what XLA picks under pjit: each rank gathers the
parameters whole, runs the unchanged ``Model.loss_fn`` on its data shard
of the batch, and the gradients are averaged over the data axes and cut to
the rules' placements; only the AdamW update runs on the shards.  The
port's model functions are plain tensor code, and DTensor has no sharding
rule for some of their ops (the embedding's gather mixes a plain index
tensor with a DTensor table), so the model sees plain tensors.  The
Megatron layout of the products themselves (column- and row-parallel
matmuls with their own all-reduces) is later work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.pytree import tree_leaves, tree_map

#: the keys whose value is a list of per-layer dictionaries in the port (one
#: dictionary of layer-stacked leaves in the JAX tree)
_STACKED = frozenset({"blocks", "enc_blocks", "dec_blocks"})

#: rules by leaf name, WITHOUT the stacked leading layer dim
_RULES = {
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "xq": (None, "model"), "xk": (None, "model"), "xv": (None, "model"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "wo": ("model", None), "xo": ("model", None),
    # dense mlp
    "w_gate": (None, "model"), "w_up": (None, "model"), "w_down": ("model", None),
    # mamba
    "w_z": (None, "model"), "w_x": (None, "model"), "w_dt": (None, "model"),
    "w_bc": (None, None),
    "conv_x": (None, "model"), "conv_bc": (None, None),
    "A_log": ("model",), "D": ("model",), "dt_bias": ("model",),
    "norm": ("model",),
    "out_proj": ("model", None),
    # norms / misc
    "ln": (None,), "ln1": (None,), "ln2": (None,), "ln_x": (None,),
    "router": (None, None),
}

#: MoE expert tensors (inside a "moe" subtree): expert dim -> "model"
_MOE_RULES = {
    "w_gate": ("model", None, None), "w_up": ("model", None, None),
    "w_down": ("model", None, None), "router": (None, None),
}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices and no process group:
    the counterpart of ``jax.sharding.AbstractMesh``.  The rules take it
    where they take a ``DeviceMesh``; placing tensors needs a real mesh."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple[str, ...]:
    """A spec entry as a tuple of axis names (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the counterpart of ``jax.sharding.NamedSharding``.

    ``spec`` has one entry a tensor dim (None, an axis name, or a tuple of
    axis names, the entries of a JAX ``PartitionSpec``); ``placements`` is
    the same layout as one placement a mesh dim."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple[Placement, ...]:
        names = tuple(self.mesh.mesh_dim_names)
        out: list[Placement] = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = _axes(entry)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {self.spec}: axes {axes} on one dim must follow "
                                 f"the mesh's order {names}")
            for ax in axes:
                out[names.index(ax)] = Shard(dim)
        return tuple(out)


def _walk(fn, tree, names: tuple = (), n_layers: int | None = None):
    """``fn(names, leaf, n_layers)`` over a port tree: ``names`` the
    dictionary keys on the leaf's path, ``n_layers`` the length of the
    per-layer list the leaf sits in (None outside one)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, names + (k,), n_layers) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        stacked = bool(names) and names[-1] in _STACKED
        return type(tree)(_walk(fn, v, names, len(tree) if stacked else n_layers)
                          for v in tree)
    return fn(names, tree, n_layers)


def _jax_shape(leaf, n_layers) -> tuple:
    """The shape of the JAX package's leaf for a port leaf: with the leading
    layer dim where the port keeps one dictionary a layer."""
    shape = tuple(leaf.shape)
    return shape if n_layers is None else (n_layers,) + shape


def _unstack(spec: tuple, n_layers) -> tuple:
    if n_layers is None:
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"spec {spec} shards a stacked layer dim")
    return spec[1:]


def _spec_for(names: tuple, shape: tuple) -> tuple:
    """The JAX ``_spec_for`` of the leaf at dictionary path ``names``."""
    ndim = len(shape)
    name = names[-1] if names else ""
    if name == "embed":
        return ("model", None)
    if name == "lm_head":
        return (None, "model")
    if name in ("ln_f", "ln_enc"):
        return (None,)
    rules = _MOE_RULES if "moe" in names else _RULES
    spec = rules.get(name)
    if spec is None:
        return (None,) * ndim
    if set(names) & _STACKED:
        spec = (None,) + spec
    # pad/truncate to leaf rank (biases in unstacked shared_attn etc.)
    if len(spec) < ndim:
        spec = spec + (None,) * (ndim - len(spec))
    elif len(spec) > ndim:
        spec = spec[len(spec) - ndim:]
    return spec


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch: ('pod', 'data') when 'pod' exists."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return _sizes(mesh).get("model", 1)


def _data_size(mesh) -> int:
    sizes = _sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def param_sharding(params_abstract, mesh):
    """A tree of :class:`NamedSharding` congruent with ``params_abstract``
    (tensors, meta tensors or DTensors: only shapes are read); also a train
    state's ``{"params", "opt": {"m", "v", "step"}}``, whose ``m``/``v``
    leaves take their parameter's rule and ``step`` replicates.

    Falls back to replication on any dim whose size does not divide the mesh
    axis (e.g. 15-head smollm TP on 16), as the JAX package does."""
    msize = model_axis_size(mesh)

    def one(names, leaf, n_layers):
        shape = _jax_shape(leaf, n_layers)
        spec = _spec_for(names, shape)
        parts = [None if ax == "model" and shape[dim] % msize else ax
                 for dim, ax in enumerate(spec + (None,) * (len(shape) - len(spec)))]
        # MoE experts with E < model size: shard the FFN hidden dim instead
        # (per-expert tensor parallelism; the JAX package's moe_ep TP mode)
        name = names[-1] if names else ""
        if "moe" in names and name in ("w_gate", "w_up", "w_down") and "model" not in parts:
            f_dim = len(shape) - 1 if name in ("w_gate", "w_up") else len(shape) - 2
            if shape[f_dim] % msize == 0:
                parts[f_dim] = "model"
        return NamedSharding(mesh, _unstack(tuple(parts), n_layers))

    return _walk(one, params_abstract)




def batch_sharding(batch_abstract, mesh):
    """Inputs: batch dim over ('pod','data'); other dims replicated.  Batch
    dims that do not divide the data axes' size fall back to replication
    (long-context decode feeds batch=1)."""
    daxes, dsize = data_axes(mesh), _data_size(mesh)

    def one(names, leaf, n_layers):
        if len(leaf.shape) == 0 or leaf.shape[0] % dsize != 0:
            return NamedSharding(mesh, (None,) * len(leaf.shape))
        return NamedSharding(mesh, (daxes,) + (None,) * (len(leaf.shape) - 1))

    return _walk(one, batch_abstract)


def cache_sharding(cache_abstract, cfg, mesh):
    """KV / SSM cache shardings.

    The port's caches have the JAX package's layouts and names: attention
    ``k``/``v`` (and whisper's ``xk``/``xv``, zamba2's ``attn_k``/``attn_v``,
    the int8 cache's ``k_scale``/``v_scale``) are (L, B, S, H, D), the SSM
    state ``ssm`` (L, B, H, P, N), the conv window ``conv`` (L, B, W, C);
    a paged pool's (L, P, ps, H, D) goes through the attention rule with
    pages for B and the page size for S, in both packages.  Batch on
    ('pod','data') when divisible, else the SEQUENCE dim goes on 'data' (SP
    long-context decode); heads on 'model' when divisible, else the
    sequence, else head_dim on 'model'.  ``cfg`` is not read, as in the
    JAX package."""
    daxes, dsize = data_axes(mesh), _data_size(mesh)
    msize = model_axis_size(mesh)

    def one(names, leaf, n_layers):
        name = names[-1] if names else ""
        if name in ("k", "v", "xk", "xv", "attn_k", "attn_v", "k_scale", "v_scale"):
            L, B, S, H, D = leaf.shape
            b_ax = daxes if B % dsize == 0 else None
            s_ax = None
            if b_ax is None and S % dsize == 0:
                s_ax = daxes
            # model axis preference: heads > sequence > head_dim (softmax over
            # a sharded S needs only scalar-sized reductions)
            h_ax = d_ax = s_model = None
            if H % msize == 0:
                h_ax = "model"
            elif s_ax is None and S % msize == 0:
                s_model = "model"
            elif D % msize == 0 and D > 1:
                d_ax = "model"
            return NamedSharding(mesh, (None, b_ax, s_ax or s_model, h_ax, d_ax))
        if name == "ssm":
            L, B, H, Pd, N = leaf.shape
            b_ax = daxes if B % dsize == 0 else None
            h_ax = "model" if H % msize == 0 else None
            return NamedSharding(mesh, (None, b_ax, h_ax, None, None))
        if name == "conv":
            L, B, W, C = leaf.shape
            b_ax = daxes if B % dsize == 0 else None
            return NamedSharding(mesh, (None, b_ax, None, None))
        return NamedSharding(mesh, (None,) * len(leaf.shape))

    return _walk(one, cache_abstract)


def _block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``x``, where ``x`` lies: each
    ``Shard(d)``, in mesh-dim order, keeps this rank's coordinate-th of
    dim d's equal chunks, so a dim sharded on ('pod', 'data') keeps block
    ``p * D + d``.  An uneven split is refused."""
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(mdim)
            if x.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not split into "
                                 f"{n} equal shards")
            x = x.chunk(n, p.dim)[coord[mdim]]
    return x


def place(x, sharding: NamedSharding):
    """``x`` laid out under ``sharding``, as ``jax.device_put`` does.

    A plain tensor, which every rank must hold whole and equal, is cut
    where it lies (in host memory, say) and only this rank's block moves to
    the mesh's device type: no collective, and the device holds no more
    than the block.  A DTensor on the same mesh is redistributed; a DTensor
    on another mesh is gathered whole there, then cut."""
    mesh, placements = sharding.mesh, sharding.placements
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    block = _block(x, mesh, placements).contiguous().to(mesh.device_type)
    return DTensor.from_local(block, mesh, placements, run_check=False)


def shard_params(params, mesh):
    """Place concrete params with the rule shardings (``place`` of each
    leaf: every rank passes the same whole tree)."""
    return tree_map(place, params, param_sharding(params, mesh))


# ---------------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------------

def _local(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``x`` under ``sharding`` as a plain tensor."""
    return place(torch.as_tensor(x), sharding).to_local()


def _avg(x: torch.Tensor, mesh, axes: tuple[str, ...], placements=None) -> DTensor:
    """``x``, each rank's own, as its mean over the mesh axes ``axes``
    (``Partial("avg")`` on those mesh dims), redistributed to
    ``placements`` (``Replicate()`` on every mesh dim where None)."""
    partial = [Partial("avg") if a in axes else Replicate() for a in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, partial, run_check=False).redistribute(
        mesh, placements or [Replicate()] * mesh.ndim)


def data_mean(loss, grads, local_batch, mesh, axes: tuple[str, ...], shardings=None):
    """``(loss, grads)``, each rank's from its shard ``local_batch`` of the
    batch, as the mean over the shards on the mesh axes ``axes``: the mean
    over the whole batch those shards make up, as under pjit.

    A shard's loss is the mean over its own targets, so where the batch has
    ``targets`` each shard's loss and gradients are first weighted by its
    share of the targets the loss counts (``targets[:, 1:] >= 0``, the mask
    of ``models.common.lm_loss``); the result is then the batch mean also
    where the shards' masks differ.  ``loss`` comes back a plain float32
    0-d tensor, equal on every rank; ``grads`` DTensors under
    ``shardings`` (a tree of :class:`NamedSharding`), or, where None, plain
    tensors, whole and equal on every rank."""
    loss = loss.float().reshape(())
    sizes = _sizes(mesh)
    if math.prod(sizes[a] for a in axes) > 1 and "targets" in local_batch:
        count = (local_batch["targets"][:, 1:] >= 0).sum().float()
        mean = _avg(count, mesh, axes).to_local()
        some = mean > 0                            # else every shard's loss is 0
        weight = torch.where(some, count / torch.where(some, mean, 1.0), 1.0)
        loss = loss * weight
        grads = tree_map(lambda g: (g.float() * weight).to(g.dtype), grads)
    loss = _avg(loss, mesh, axes).to_local()
    if shardings is None:
        return loss, tree_map(lambda g: _avg(g, mesh, axes).to_local(), grads)
    return loss, tree_map(lambda g, s: _avg(g, mesh, axes, s.placements), grads, shardings)


def global_norm(grads) -> torch.Tensor:
    """The float32 global norm of a tree of DTensors over all their shards:
    the one-device ``optim.adamw.global_norm`` of the whole tree.

    Each leaf's local sum of squares goes into one vector, in leaf order;
    for each mesh dim, the entries of the leaves sharded on it are summed
    over that dim's group (one all-reduce a mesh dim); a replicated leaf's
    entry is its rank's own.  At one rank the vector, and so the norm, is
    the one-device one bit for bit."""
    leaves = tree_leaves(grads)
    sums = torch.stack([g.to_local().float().square().sum() for g in leaves])
    mesh = leaves[0].device_mesh
    for mdim in range(mesh.ndim):
        flags = [g.placements[mdim].is_shard() for g in leaves]
        if mesh.size(mdim) == 1 or not any(flags):
            continue
        sharded = torch.tensor(flags, device=sums.device)
        total = torch.where(sharded, sums, torch.zeros_like(sums))
        dist.all_reduce(total, group=mesh.get_group(mdim))
        sums = torch.where(sharded, total, sums)
    return torch.sqrt(sums.sum())


def sharded_loss_and_grads(step, params, batch, shardings):
    """``(loss, grads)`` of one sharded step: each rank takes its data shard
    of ``batch``, gathers ``params`` whole (``full_tensor``), runs the
    unchanged ``step.grads_of`` (``Model.loss_fn`` through autograd, with
    its microbatches), and :func:`data_mean` over the data axes gives the
    whole batch's loss and the gradients under the parameters' placements.
    A MoE layer routes, and fills its capacity, over one shard's tokens
    (the JAX package routes over the whole batch; its expert-parallel
    layout is ROADMAP.md Queue 1 item 8b).  ``shardings``: ``(param_sh,
    batch_sh)`` trees of :class:`NamedSharding`."""
    p_sh, b_sh = shardings
    mesh = tree_leaves(p_sh)[0].mesh
    local_batch = tree_map(_local, batch, b_sh)
    whole = tree_map(lambda p: p.full_tensor() if isinstance(p, DTensor) else p, params)
    loss, grads = step.grads_of(whole, local_batch)
    del whole
    return data_mean(loss, grads, local_batch, mesh, data_axes(mesh), p_sh)


def sharded_step(step: Callable, in_shardings) -> Callable:
    """A step on whole trees (:func:`repro_torch.training.make_train_step`)
    as a step on DTensor trees laid out by the rules: the counterpart of
    ``jax.jit(step, in_shardings=(param_sh, opt_sh, batch_sh),
    out_shardings=(param_sh, opt_sh, None))``.

    ``run(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``params`` and ``opt_state`` are DTensors under ``in_shardings``' first
    two trees (placed once, by :func:`shard_params` and :func:`place`), and
    come back under the same placements; ``batch`` is the global batch
    every rank holds (or DTensors).  The gradients come from
    :func:`sharded_loss_and_grads`; their global norm, which drives the
    clipping, is :func:`global_norm` over every shard; then ``step.update``
    (AdamW, in place where the step donates) runs on each rank's shards.
    The metrics are plain tensors, equal on every rank."""
    p_sh, _, b_sh = in_shardings

    def run(params, opt_state, batch):
        loss, grads = sharded_loss_and_grads(step, params, batch, (p_sh, b_sh))
        gnorm = global_norm(grads)
        local = lambda tree: tree_map(lambda t: t.to_local(), tree)
        new_p, new_o, om = step.update(local(params), local(grads), local(opt_state),
                                       grad_norm=gnorm)
        del grads
        wrap = lambda t, like: DTensor.from_local(t, like.device_mesh, like.placements,
                                                  shape=like.shape, stride=like.stride(),
                                                  run_check=False)
        return (tree_map(wrap, new_p, params), tree_map(wrap, new_o, opt_state),
                {"loss": loss, **om})

    return run


__all__ = ["AbstractMesh", "NamedSharding", "batch_sharding", "cache_sharding",
           "data_axes", "data_mean", "global_norm", "model_axis_size", "param_sharding",
           "place", "shard_params", "sharded_loss_and_grads", "sharded_step"]
