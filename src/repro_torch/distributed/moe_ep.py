"""Expert-parallel MoE: the counterpart of ``repro.distributed.moe_ep``.

Scheme (the JAX module's, without ``shard_map``): each rank runs the model
on its own tokens -- its data shard, replicated over the ``model`` axis --
and holds only its block of the experts.

* routing is computed redundantly on every model rank
  (:func:`repro_torch.models.moe.router_topk`), and each expert's capacity
  comes from the rank's own token count;
* EP mode (``n_experts`` divisible by the model axis): rank r owns experts
  ``r * E_loc .. (r + 1) * E_loc - 1`` and dispatches only the kept pairs
  routed to them (:func:`_local_moe`);
* TP mode (otherwise): every rank dispatches to all experts, whose FFNs are
  cut on the hidden dim F, so its down-projection is a partial sum
  (:func:`_local_moe_tp`);
* each rank's partial output, cast to the input's dtype, is summed over
  ``model``: the one forward collective of a layer (an all-reduce of the
  local T x D activations).

The bodies are plain functions of ``(x, local params, cfg, rank, mp)``
returning the rank's partial, so one process can sum every rank's partials
(the tests and the card do).  :func:`moe_ffn_ep` adds the collectives as
autograd functions (defined in
:mod:`~repro_torch.distributed.tensor_parallel`, which the attention, MLP,
Mamba-2 and vocabulary regions share), Megatron's conjugate pair: the sum
over ``model`` is an
all-reduce forward and the identity backward; the layer's input and the
replicated router enter through the identity forward and an all-reduce
backward, because each rank's graph holds only its own experts' combine
terms.  The load-balance loss is computed alike on every model rank; its
mean over ``model`` is its value forward and 1 / mp of the cotangent
backward, so the sum over ``model`` in the input's and the router's
backward counts it once.  Its mean over the data axes is taken with the
loss it is part of, by the sharded step's
:func:`~repro_torch.distributed.sharding.data_mean` (the JAX body takes a
``pmean`` over them; where every shard counts the same targets, the two
means are one).  A batch that does not divide the data ranks is replicated
by the batch rule (``batch_sharding``), so each data rank computes it
whole, redundantly, as the JAX module does.

At one model rank every collective is skipped: the layer is
:func:`~repro_torch.models.moe.moe_ffn` bit for bit.
"""
from __future__ import annotations

import os

from repro_torch.distributed.tensor_parallel import (  # noqa: F401  (moe_ep's names)
    _CopyToModel,
    _MeanOfEqual,
    _SumOverModel,
)
from repro_torch.models.common import MoEConfig
from repro_torch.models.moe import capacity, expert_outputs, load_balance_loss, router_topk

#: set by launchers (dryrun / train) when a mesh is active; models pick it up.
_EP_MESH = None


def set_ep_mesh(mesh) -> None:
    global _EP_MESH
    _EP_MESH = mesh


def get_ep_mesh():
    return _EP_MESH


def active_ep_mesh():
    """The mesh ``lm._ffn`` takes the expert-parallel branch on, or None:
    the JAX switch, a set mesh with a ``model`` axis and ``REPRO_MOE_EP``
    unset or ``1``."""
    mesh = _EP_MESH
    if mesh is not None and "model" in mesh.mesh_dim_names \
            and os.environ.get("REPRO_MOE_EP", "1") == "1":
        return mesh
    return None


def _local_moe(x, params, cfg: MoEConfig, rank: int, mp: int, *, aux: bool = True):
    """EP body: x (T, D) the rank's tokens; params router (D, E) and the
    rank's experts w_gate / w_up (E / mp, D, F), w_down (E / mp, F, D).
    Returns (this rank's partial output (T, D) in x's dtype, the
    load-balance loss of its routing, or None without ``aux``)."""
    T, _ = x.shape
    E = cfg.n_experts
    E_loc = E // mp
    weights, experts, logits = router_topk(x, params["router"], cfg)
    out = expert_outputs(x, params, weights, experts, capacity(T, cfg), E,
                         first=rank * E_loc, n_local=E_loc)
    return out.to(x.dtype), load_balance_loss(logits, experts, E) if aux else None


def _local_moe_tp(x, params, cfg: MoEConfig, rank: int, mp: int, *, aux: bool = True):
    """TP body: every expert, its FFN cut on the hidden dim (w_gate / w_up
    (E, D, F / mp), w_down (E, F / mp, D)); the partial sums over F are
    completed by the same sum over ``model``.  ``rank`` and ``mp`` are not
    read (the blocks carry the cut); the signature is the EP body's."""
    T, _ = x.shape
    E = cfg.n_experts
    weights, experts, logits = router_topk(x, params["router"], cfg)
    out = expert_outputs(x, params, weights, experts, capacity(T, cfg), E)
    return out.to(x.dtype), load_balance_loss(logits, experts, E) if aux else None


def _check_blocks(params, cfg: MoEConfig, mp: int, ep_mode: bool) -> None:
    E, F_ = cfg.n_experts, cfg.d_expert
    want = ((E // mp, None, F_), (E // mp, F_, None)) if ep_mode \
        else ((E, None, F_ // mp), (E, F_ // mp, None))
    for name, shape in (("w_gate", want[0]), ("w_up", want[0]), ("w_down", want[1])):
        got = tuple(params[name].shape)
        if any(w is not None and g != w for g, w in zip(got, shape)):
            raise ValueError(
                f"moe_ffn_ep in {'EP' if ep_mode else 'TP'} mode at model size {mp} takes "
                f"the rank's block of {name} ({shape}, None = any), got {got}: pass the "
                "local blocks of the rules' placements (sharding.param_sharding)")


def moe_ffn_ep(x3d, params, cfg: MoEConfig, mesh, *, aux: bool = True):
    """x3d: (B, S, D), the rank's tokens (its data shard, or the whole batch
    where the batch rule replicates it); ``params``: the replicated router
    and the rank's expert blocks under the rules.  Returns (out (B, S, D),
    aux: the rank's load-balance loss, its mean over ``model``; None
    without ``aux``).

    EP mode when n_experts divides the model axis; per-expert TP mode
    otherwise (experts whole in E, cut on the FFN hidden dim)."""
    mp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    ep_mode = cfg.n_experts % mp == 0
    _check_blocks(params, cfg, mp, ep_mode)
    B, S, D = x3d.shape
    x = x3d.reshape(B * S, D)
    body = _local_moe if ep_mode else _local_moe_tp
    if mp == 1:
        out, a = body(x, params, cfg, 0, 1, aux=aux)
        return out.reshape(B, S, D), a
    group = mesh.get_group("model")
    rank = mesh.get_local_rank("model")
    x = _CopyToModel.apply(x, group)
    params = {**params, "router": _CopyToModel.apply(params["router"], group)}
    out, a = body(x, params, cfg, rank, mp, aux=aux)
    out = _SumOverModel.apply(out, group)       # ONE combine all-reduce per layer
    return out.reshape(B, S, D), _MeanOfEqual.apply(a, mp) if aux else None


__all__ = ["moe_ffn_ep", "set_ep_mesh", "get_ep_mesh", "active_ep_mesh"]
