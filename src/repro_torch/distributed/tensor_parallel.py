"""Tensor parallelism over the ``model`` mesh axis: the Megatron layout.

The counterpart of what ``pjit`` does for the JAX package: there the rules
(``repro.distributed.sharding``) place each leaf and XLA's partitioner
splits the products the way the rules cut them.  The port's model functions
are plain tensor code, so they run on the rank's blocks and issue the
collectives themselves, where Megatron puts them:

* a region (attention, the gated MLP, the Mamba-2 mixer, the vocabulary)
  is entered through :func:`copy_to_model` (identity forward, all-reduce
  backward: each rank's graph holds only its own columns' share of the
  input's gradient) and left through :func:`sum_over_model` (all-reduce
  forward, identity backward) after its row-parallel product;
* a leaf that the rules replicate but a split region reads (Mamba-2's
  ``w_bc`` / ``conv_bc``, a ``wk`` that does not divide) is itself wrapped
  in :func:`copy_to_model`, so its gradient is summed once; a block that
  the region needs whole comes through :func:`gather_over_model`
  (all-gather forward, reduce-scatter backward);
* the vocabulary is cut on ``model`` (``embed`` ``P("model", None)``,
  ``lm_head`` ``P(None, "model")``): :func:`vocab_embed`,
  :func:`vocab_logits` and :func:`vocab_cross_entropy` never form the whole
  (B, S, V) logits;
* :func:`merge_softmax` merges per-rank partial softmaxes (max, sum,
  unnormalised output) over a group, as ``kernels/csrc/split_merge.cuh``
  merges a kernel's splits: the decode step's cache cut on its sequence.

**Layout rule** (:func:`layout`): a region runs split when the dims it cuts
divide the ``model`` axis (attention: the query heads; the MLP: ``d_ff``;
Mamba-2: its SSM heads; the vocabulary: ``V``).  Otherwise it runs on its
leaves gathered whole, which is the rules' own replication fallback: the
rules replicate a dim that does not divide, and a head count that does
not divide cuts no head.  whisper (the audio family) runs whole.

:func:`set_tp_mesh` is the switch, like ``moe_ep.set_ep_mesh``: the model
functions read their model group, rank and size from it
(:func:`model_group`); with no mesh, or one model rank, every collective
is skipped and the model functions run as on one device.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

#: set by the sharded step and the dry run while a mesh is active
_TP_MESH = None

# the single-tensor all-gather and reduce-scatter under their newer names
# where torch has them (the older ones warn there), else the older ones
_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def set_tp_mesh(mesh) -> None:
    global _TP_MESH
    _TP_MESH = mesh


@contextlib.contextmanager
def tp_mesh(mesh):
    """:func:`set_tp_mesh` for the ``with`` block, the previous mesh after."""
    before = _TP_MESH
    set_tp_mesh(mesh)
    try:
        yield
    finally:
        set_tp_mesh(before)


@dataclass(frozen=True)
class ModelGroup:
    """The ``model`` axis of the active mesh: its process group, this
    rank's coordinate on it and its size."""

    group: object
    rank: int
    mp: int


def _axis_group(mesh, axis: str) -> ModelGroup:
    n = dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]
    return ModelGroup(mesh.get_group(axis), mesh.get_local_rank(axis), n)


def model_group() -> ModelGroup | None:
    """The active mesh's ``model`` axis, or None where there is no mesh,
    no ``model`` axis or one model rank (the model runs as on one device)."""
    mesh = _TP_MESH
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    if dict(zip(mesh.mesh_dim_names, mesh.shape))["model"] == 1:
        return None
    return _axis_group(mesh, "model")


# ---------------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------------

#: families whose model functions run whole (whisper: no tensor-parallel layout)
GATHERED_FAMILIES = ("audio", "encdec")


def attention_split(cfg, mp: int) -> bool:
    return (mp > 1 and cfg.family not in GATHERED_FAMILIES and cfg.n_heads > 0
            and cfg.n_heads % mp == 0)


def kv_split(cfg, mp: int) -> bool:
    """K/V on the rank's own kv heads (else all-gathered, each rank taking
    the kv heads its query heads read)."""
    return attention_split(cfg, mp) and cfg.n_kv_heads % mp == 0


def mlp_split(cfg, mp: int) -> bool:
    return (mp > 1 and cfg.family not in GATHERED_FAMILIES and cfg.d_ff > 0
            and cfg.d_ff % mp == 0)


def ssm_heads(cfg) -> int:
    s = cfg.ssm
    return s.expand * cfg.d_model // s.head_dim if s is not None else 0


def mamba_split(cfg, mp: int) -> bool:
    """The SSM heads divide ``model`` and share one group of B / C (every
    config's ``n_groups``), which each rank then computes whole."""
    return (mp > 1 and cfg.ssm is not None and cfg.ssm.n_groups == 1
            and ssm_heads(cfg) % mp == 0)


def vocab_split(cfg, mp: int) -> bool:
    return mp > 1 and cfg.family not in GATHERED_FAMILIES and cfg.vocab % mp == 0


def layout(cfg, mp: int) -> dict[str, str]:
    """Per region of ``cfg``'s model, ``"split"`` or ``"whole"`` at model
    size ``mp`` (the regions the family has)."""
    out = {}
    if cfg.n_heads and cfg.family != "ssm":
        out["attention"] = ("split" if attention_split(cfg, mp) else "whole")
        if attention_split(cfg, mp):
            out["attention"] += " (kv heads split)" if kv_split(cfg, mp) else \
                " (kv gathered)"
    if cfg.moe is None and cfg.d_ff and (cfg.family != "ssm"):
        out["mlp"] = "split" if mlp_split(cfg, mp) else "whole"
    if cfg.ssm is not None:
        out["mamba2"] = "split" if mamba_split(cfg, mp) else "whole"
    out["vocab"] = "split" if vocab_split(cfg, mp) else "whole"
    return out


_ATTN = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv"})
_MLP = frozenset({"w_gate", "w_up", "w_down"})
_MAMBA = frozenset({"w_z", "w_x", "w_dt", "conv_x", "A_log", "D", "dt_bias", "norm",
                    "out_proj", "w_bc", "conv_bc"})


def split_leaf(names: tuple, cfg, mp: int) -> bool:
    """Whether the leaf at dictionary path ``names`` belongs to a region
    that runs split (it is passed as the rank's block; the replicated
    ``w_bc`` / ``conv_bc`` as they are), not gathered whole.  The MoE
    experts are the expert-parallel step's affair (``moe_ep``)."""
    name = names[-1] if names else ""
    if "moe" in names:
        return False
    if name in ("embed", "lm_head"):
        return vocab_split(cfg, mp)
    if "mlp" in names and name in _MLP:
        return mlp_split(cfg, mp)
    if name in _ATTN:
        return attention_split(cfg, mp)
    if name in _MAMBA and "blocks" in names:
        return mamba_split(cfg, mp)
    return False


# ---------------------------------------------------------------------------------
# collectives as autograd functions
# ---------------------------------------------------------------------------------

class _SumOverModel(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOfEqual(torch.autograd.Function):
    """The mean over ``mp`` ranks of a value every rank holds alike: the
    value forward, 1 / mp of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.mp, None


class _SumBothWays(torch.autograd.Function):
    """All-reduce (sum) forward and backward: a value each rank's columns
    feed a share of and each rank then reads (the gated norm's variance)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _GATHER(out, x, group=group)
    return out.movedim(0, dim)


class _GatherOverModel(torch.autograd.Function):
    """All-gather along ``dim`` forward (the blocks in rank order);
    backward a reduce-scatter (``partial``: each rank's gradient of the
    whole is its own share) or the rank's own chunk (each rank's gradient
    of the whole is the whole one)."""

    @staticmethod
    def forward(ctx, x, dim, g: ModelGroup, partial: bool):
        ctx.dim, ctx.g, ctx.partial = dim, g, partial
        return _all_gather(x, dim, g.group, g.mp)

    @staticmethod
    def backward(ctx, grad):
        dim, g = ctx.dim, ctx.g
        if not ctx.partial:
            return grad.chunk(g.mp, dim)[g.rank].contiguous(), None, None, None
        full = grad.movedim(dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // g.mp,) + tuple(full.shape[1:]))
        _SCATTER(out, full, group=g.group)
        return out.movedim(0, dim), None, None, None


def sum_over_model(x, g: ModelGroup | None):
    return x if g is None else _SumOverModel.apply(x, g.group)


def copy_to_model(x, g: ModelGroup | None):
    return x if g is None or x is None else _CopyToModel.apply(x, g.group)


def sum_both_ways(x, g: ModelGroup | None):
    return x if g is None else _SumBothWays.apply(x, g.group)


def gather_over_model(x, dim: int, g: ModelGroup, *, partial: bool = True):
    return _GatherOverModel.apply(x, dim, g, partial)


def whole(w, dim: int, full: int, g: ModelGroup | None, *, in_split: bool = False):
    """Leaf ``w`` whole along ``dim`` (size ``full``): a block is
    all-gathered over ``model``; a whole leaf is taken as it is.  Inside a
    split region (``in_split``) each rank's gradient is a share, so a
    gathered block's backward reduce-scatters and a whole leaf enters
    through :func:`copy_to_model`; in a whole region every rank's gradient
    is the whole one and a gathered block keeps its own chunk of it."""
    if w is None or w.shape[dim] == full:
        return copy_to_model(w, g) if in_split else w
    if g is None or w.shape[dim] * g.mp != full:
        raise ValueError(f"a block of {tuple(w.shape)} (dim {dim} of {full}) needs the "
                         "tensor-parallel mesh it was cut on (tensor_parallel.set_tp_mesh)")
    return gather_over_model(w, dim, g, partial=in_split)


def expect_block(w, dim: int, full: int, g: ModelGroup) -> None:
    """Refuses a leaf that is not the rank's block of a split region."""
    if w is not None and w.shape[dim] * g.mp != full:
        raise ValueError(f"a split region at model size {g.mp} takes the rank's block "
                         f"(dim {dim}: {full // g.mp}), got {tuple(w.shape)}: pass the "
                         "local blocks of the rules' placements (sharding.param_sharding)")


# ---------------------------------------------------------------------------------
# the vocabulary on the model axis
# ---------------------------------------------------------------------------------

def vocab_embed(embed_block, tokens, g: ModelGroup):
    """Rows ``tokens`` of the whole ``embed`` from the rank's block of it
    (rows ``rank * V / mp`` on): tokens outside the block read 0, and the
    sum over ``model`` gives every rank the whole lookup."""
    n = embed_block.shape[0]
    local = tokens.long() - g.rank * n
    inside = (local >= 0) & (local < n)
    x = embed_block[local.clamp(0, n - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return sum_over_model(x, g)


def vocab_logits(h, w_block, g: ModelGroup):
    """The rank's columns of the logits, f32: ``h`` (replicated) enters
    through :func:`copy_to_model`, ``w_block`` (d, V / mp)."""
    return (copy_to_model(h, g) @ w_block).float()


class _VocabCE(torch.autograd.Function):
    """Per-token cross-entropy over logits cut on the vocabulary: the
    max (no gradient), the sum of exponentials and the target's logit are
    all-reduced over ``model``; backward, the rank's columns of
    ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, tgt, g: ModelGroup):
        n = logits.shape[-1]
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g.group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(dim=-1)
        local = tgt - g.rank * n
        inside = (local >= 0) & (local < n)
        picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        both = torch.stack([s, picked])
        dist.all_reduce(both, group=g.group)
        lse = torch.log(both[0]) + m
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - both[1]

    @staticmethod
    def backward(ctx, grad):
        logits, lse, local, inside = ctx.saved_tensors
        n = logits.shape[-1]
        d = torch.exp(logits - lse[..., None])
        onehot = torch.zeros_like(d).scatter_(-1, local.clamp(0, n - 1)[..., None],
                                              inside[..., None].to(d.dtype))
        return (d - onehot) * grad[..., None], None, None


def vocab_cross_entropy(logits_block, targets, g: ModelGroup):
    """``models.common.lm_loss`` over logits cut on the vocabulary
    (``logits_block`` (B, S, V / mp), the rank's columns): the mean
    next-token cross-entropy of position t against ``targets[:, t + 1]``,
    targets < 0 masked out, with no whole (B, S, V) tensor formed."""
    tgt = targets[:, 1:].long()
    nll = _VocabCE.apply(logits_block[:, :-1].float(), tgt.clamp_min(0), g)
    mask = (tgt >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------------
# the cache cut on its sequence or head dim, and the cross-rank softmax merge
# ---------------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheSplit:
    """How the rules cut an attention cache (L, B, S, H, D) beyond its
    batch and heads: ``seq`` the mesh axes on its sequence, each a
    :class:`ModelGroup` in mesh order (so the rank's span is block
    ``p * D + d`` of a ('pod', 'data') cut), ``dim`` the axis on its head
    dim, or None."""

    seq: tuple = ()
    dim: ModelGroup | None = None

    def span(self, s_local: int) -> int:
        """The first position of the rank's span of the sequence."""
        idx = 0
        for a in self.seq:
            idx = idx * a.mp + a.rank
        return idx * s_local


def cache_split(sharding) -> CacheSplit | None:
    """The :class:`CacheSplit` of an attention cache leaf's
    :class:`~repro_torch.distributed.sharding.NamedSharding` (None where
    the rules cut only its batch and heads)."""
    mesh = sharding.mesh
    seq, dim = [], None
    for mdim, p in enumerate(sharding.placements):
        if not p.is_shard() or mesh.size(mdim) == 1:
            continue
        axis = mesh.mesh_dim_names[mdim]
        if p.dim == 2:
            seq.append(_axis_group(mesh, axis))
        elif p.dim == 4:
            dim = _axis_group(mesh, axis)
    if not seq and dim is None:
        return None
    return CacheSplit(tuple(seq), dim)


def merge_softmax(m, l, acc, g: ModelGroup):
    """Merge partial softmaxes over the ranks of ``g``: ``m`` (...,) each
    row's max raw score on the rank (``NEG_INF`` where it sees no key),
    ``l`` (...,) its sum of ``exp(s - m)``, ``acc`` (..., D) its
    unnormalised ``sum exp(s - m) v``.  Returns the merged ``(m, l, acc)``
    (``acc / l`` the output), the log-sum-exp merge of
    ``kernels/csrc/split_merge.cuh``; ranks in rank order."""
    ml = _all_gather(torch.stack([m, l], dim=-1)[None], 0, g.group, g.mp)   # (mp, ..., 2)
    accs = _all_gather(acc[None], 0, g.group, g.mp)                           # (mp, ..., D)
    big = ml[..., 0].amax(dim=0)
    w = torch.exp(ml[..., 0] - big)
    return big, (ml[..., 1] * w).sum(dim=0), (accs * w[..., None]).sum(dim=0)


__all__ = ["CacheSplit", "ModelGroup", "attention_split", "cache_split", "copy_to_model",
           "expect_block", "gather_over_model", "kv_split", "layout",
           "mamba_split", "merge_softmax", "mlp_split", "model_group", "set_tp_mesh",
           "split_leaf", "sum_both_ways", "sum_over_model", "tp_mesh", "vocab_cross_entropy",
           "vocab_embed", "vocab_logits", "vocab_split", "whole"]
