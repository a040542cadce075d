"""Multi-pod dry run: one rank's step at every (arch x shape x mesh) cell, with
nothing allocated.  Counterpart of ``repro.launch.dryrun``.

For each cell this:
  1. builds the production mesh (16x16 single-pod or 2x16x16 multi-pod) as
     rank 0 of 256 or 512 under torch's ``fake`` process-group backend,
     whose collectives return at once and move no data;
  2. builds the step implied by the shape on meta tensors (shapes and
     dtypes, no storage): ``sharded_step`` for ``train_*``, the model's
     ``prefill`` for ``prefill_*`` and its ``decode_step`` for
     ``decode_*``, with the expert-parallel mesh set
     (``moe_ep.set_ep_mesh``), as the JAX module sets it;
  3. runs it once as rank 0, counting FLOPs (``FlopCounterMode``), the
     bytes each dispatched op reads and writes, the collectives
     (:func:`repro_torch.distributed.hlo_analysis.collective_stats`) and
     the peak of live tensor bytes (``MemTracker``);
  4. appends one JSON record to the output, and skips the cells the file
     already holds as ``ok`` or ``skipped``.

The record keeps the JAX module's keys where the port has a counterpart:
``memory.argument_bytes`` and ``output_bytes`` are exact sums of the rank's
blocks; ``memory.peak_bytes`` is ``MemTracker``'s peak over the run, or
null with ``peak_error``; ``cost.flops`` counts the matmuls, convolutions
and attention products; ``cost["bytes accessed"]`` is the sum of every
dispatched op's input and output bytes, views and allocations aside: the
unfused traffic, where XLA reports its fused program's; ``collectives``
and ``roofline`` as in the JAX module, except that the roofline takes the
rank's own collective bytes (the JAX module divides its per-device HLO's
bytes by the device count).  ``lower_s`` and ``compile_s`` and
``memory.bytes_per_device`` (XLA's temporary buffer) have no counterpart:
nothing is lowered or compiled, and eager PyTorch has no temporary
buffer apart from its live tensors, which ``peak_bytes`` counts.  ``fits``
says whether the rank's bytes (the peak, else the arguments) fit in the
card's 80 GB; a cell that does not fit is still ``ok``.

``layout`` says how the port lays a cell out: the Megatron layout of
:mod:`~repro_torch.distributed.tensor_parallel`, which computes what XLA
computes under the rules' ``in_shardings``.  Each region (attention, the
gated MLP, the Mamba-2 mixer, the vocabulary) runs on the rank's blocks
where the dims it cuts divide the ``model`` axis, and on its leaves
gathered whole where they do not; ``layout["regions"]`` lists which ran
split and which whole.  A train cell is ``sharded_step`` (only the leaves
of whole regions gathered, each step); a prefill or decode cell holds the
rank's blocks of every leaf under ``param_sharding`` (a whole region
gathers its leaves layer by layer), its data shard of the batch (a batch
that does not divide the data ranks, such as long-context decode's batch
of 1, whole on every rank) and, for decode, the cache as ``cache_sharding``
places it: kv heads on ``model`` where they divide, else the sequence on
``model`` (each rank attends over its span; the partial softmaxes are
merged over ``model``), the sequence on the data axes for a batch of 1,
and the head dim on ``model`` where neither divides (the scores summed
over ``model``).  A prefill cell returns its cache in the same blocks and
its logits as the rank's vocabulary block.  whisper-small keeps the
gathered layout (its 12 heads and 51865-word vocabulary divide no model
axis of 16): parameters whole and resident, the cache whole on every
rank.  The MoE experts are the rank's blocks under an expert-parallel
mesh (``moe_ep``), as before.  On meta tensors every kernel wrapper takes
its plain version: the counts are the plain route's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, shape_supported
from repro_torch.distributed import moe_ep, tensor_parallel
from repro_torch.distributed.hlo_analysis import _nbytes, collective_stats, roofline_terms
from repro_torch.distributed.sharding import (
    _block,
    _expert_leaf,
    _walk,
    batch_sharding,
    cache_sharding,
    model_axis_size,
    param_sharding,
    sharded_step,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.training.train_step import make_train_step

CARD_BYTES = 80e9               # NVIDIA H100 80GB HBM3

LAYOUTS = {
    "train": "sharded_step in the Megatron layout: the leaves of split regions the rank's "
             "blocks (column-parallel in-projections, row-parallel out-projections summed "
             "over model, the vocabulary cut on model, the MoE experts on their ranks), the "
             "leaves of whole regions gathered each step; the batch's data shard; "
             "gradients averaged over the data axes; AdamW on the rank's shards",
    "serve": "the rank's blocks of every leaf under param_sharding, resident (whole regions "
             "gather theirs layer by layer); the rank's data shard of the batch; the cache "
             "as cache_sharding places it (kv heads, else the sequence, on model; the "
             "sequence on the data axes for a batch of 1; else the head dim on model), its "
             "spans' partial softmaxes merged across ranks; the logits the rank's "
             "vocabulary block",
    "gathered": "parameters gathered whole and resident; the unchanged model on the rank's "
                "data shard of the batch and the cache, all heads (whisper: no head count "
                "or vocabulary that divides the model axis)",
}


def _local(tree) -> list:
    """The rank's tensors of ``tree`` (a DTensor's local block)."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _placed(x: torch.Tensor, sharding) -> DTensor:
    """``x`` (meta) as the rank's block under ``sharding``, a DTensor."""
    block = _block(x, sharding.mesh, sharding.placements)
    return DTensor.from_local(torch.empty_like(block, device="meta"), sharding.mesh,
                              sharding.placements, run_check=False)


def _serving_params(p_abs, mesh):
    """The serving layout's parameters: each leaf whole, except the MoE
    expert leaves, the rank's blocks under the rules."""
    p_sh = param_sharding(p_abs, mesh)
    blocks = _walk(lambda names, s, n: _expert_leaf(names), p_sh)
    return tree_map(lambda p, s, b: _placed(p, s).to_local() if b else p,
                    p_abs, p_sh, blocks)


def _data_shard(tree, mesh, dim: int):
    """The rank's data shard of each leaf of ``tree``: dim ``dim`` (the
    batch dim: 0 of a batch leaf, 1 of a cache leaf, after its layer dim)
    split over the data axes where it divides them, else whole."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = sizes.get("pod", 1) * sizes.get("data", 1)

    def one(t):
        if t.dim() <= dim or t.shape[dim] % n:
            return t
        shape = list(t.shape)
        shape[dim] //= n
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return tree_map(one, tree)


def _blocks(p_abs, mesh):
    """Every leaf as the rank's block under the rules, plain meta tensors."""
    return tree_map(lambda p, s: _placed(p, s).to_local(), p_abs, param_sharding(p_abs, mesh))


def build_cell(arch: str, shape, mesh, cfg_override=None):
    """Returns ``(fn, args)`` for the cell: ``fn(*args)`` is the rank's step
    on meta tensors (DTensors under the rules for a train cell), with the
    mesh set as the expert-parallel and the tensor-parallel mesh (unset
    them after: ``run_cell`` does).  ``shape``: a name in ``SHAPES`` or a
    ``ShapeSpec``."""
    moe_ep.set_ep_mesh(mesh)
    tensor_parallel.set_tp_mesh(mesh)
    cfg = cfg_override or get_config(arch)
    model = build_model(cfg, device="meta")
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    specs = input_specs(cfg, shape)
    p_abs = model.abstract_params()
    gathered = cfg.family in tensor_parallel.GATHERED_FAMILIES

    if sp.kind == "train":
        step = make_train_step(model, AdamWConfig(), donate=True)
        o_abs = adamw_init(p_abs)
        p_sh, o_sh = param_sharding(p_abs, mesh), param_sharding(o_abs, mesh)
        b_sh = batch_sharding(specs, mesh)
        fn = sharded_step(step, (p_sh, o_sh, b_sh))
        args = (tree_map(_placed, p_abs, p_sh), tree_map(_placed, o_abs, o_sh),
                tree_map(_placed, specs, b_sh))
        return fn, args
    params = _serving_params(p_abs, mesh) if gathered else _blocks(p_abs, mesh)
    whole_cache = model.init_cache(sp.global_batch, sp.seq_len)
    c_sh = cache_sharding(whole_cache, cfg, mesh)
    attn = next((k for k in ("k", "attn_k") if k in c_sh), None)
    split = None if gathered or attn is None else tensor_parallel.cache_split(c_sh[attn])
    if sp.kind == "prefill":
        batch = _data_shard(specs, mesh, 0)

        def fn(params, batch):
            if gathered:
                return model.prefill(params, batch, max_len=sp.seq_len)
            return model.prefill(params, batch, max_len=sp.seq_len, cache_split=split)
        return fn, (params, batch)
    token = _data_shard(specs["token"], mesh, 0)
    if gathered:
        cache = _data_shard(whole_cache, mesh, 1)
    else:
        cache = tree_map(lambda c, s: _placed(c, s).to_local(), whole_cache, c_sh)

    def fn(params, cache, token, pos):
        if gathered:
            return model.decode_step(params, cache, token, pos)
        return model.decode_step(params, cache, token, pos, cache_split=split)
    return fn, (params, cache, token, sp.seq_len - 1)


def layout_of(cfg, sp, mesh) -> dict:
    """The cell's ``layout`` record: the layout's description and, per
    region, whether it ran split or whole at the mesh's model size."""
    kind = "train" if sp.kind == "train" else (
        "gathered" if cfg.family in tensor_parallel.GATHERED_FAMILIES else "serve")
    return {"kind": kind, "description": LAYOUTS[kind],
            "regions": tensor_parallel.layout(cfg, model_axis_size(mesh))}


class _BytesAccessed(TorchDispatchMode):
    """Sums every dispatched op's input and output tensor bytes, views,
    allocations and collectives aside."""

    SKIP = {"empty", "empty_like", "empty_strided", "_local_scalar_dense"}

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func._opname in self.SKIP
                or func.namespace in ("c10d", "_c10d_functional")):
            self.total += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _peak(args):
    """A ``MemTracker`` over the run, tracking ``args``' tensors from the
    start, or ``(None, reason)`` where it cannot run."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        mt.track_external(*_local(args))
        return mt, None
    except Exception as e:          # noqa: BLE001 - recorded, never guessed
        return None, repr(e)


def _measure(fn, args, train: bool, tracker):
    """``fn(*args)`` once under the counters (and ``tracker`` where given):
    ``(out, flops, bytes accessed, CollectiveStats)``."""
    from torch.utils.flop_counter import FlopCounterMode
    flops, traffic = FlopCounterMode(display=False), _BytesAccessed()
    with contextlib.nullcontext() if train else torch.no_grad():
        track = tracker if tracker is not None else contextlib.nullcontext()
        with collective_stats() as coll, flops, traffic, track:
            out = fn(*args)
    return out, int(flops.get_total_flops()), traffic.total, coll


def run_cell(arch: str, shape, mesh_kind: str, *, mesh_shape=None, mesh_axes=None,
             cfg_override=None) -> dict:
    """One cell's record.  ``shape``: a name in ``SHAPES`` or a
    ``ShapeSpec``; ``mesh_shape`` / ``mesh_axes`` replace the production
    mesh and ``cfg_override`` the config (a small cell for tests)."""
    cfg = cfg_override or get_config(arch)
    ok, why = shape_supported(cfg, shape)
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": sp.name, "mesh": mesh_kind}
    if not ok:
        rec.update(status="skipped", reason=why, wall_s=0.0)
        return rec
    multi = mesh_kind == "multi"
    shape_ = tuple(mesh_shape or ((2, 16, 16) if multi else (16, 16)))
    axes = tuple(mesh_axes or (("pod", "data", "model") if multi else ("data", "model")))
    n_dev = 1
    for n in shape_:
        n_dev *= n
    t0 = time.time()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
    try:
        mesh = make_mesh(shape_, axes, device="cpu")
        fn, args = build_cell(arch, shape, mesh, cfg_override=cfg)
        tracker, peak_error = _peak(args)
        arg_bytes = _nbytes(_local(args))
        train = sp.kind == "train"
        try:
            out, total_flops, accessed, coll = _measure(fn, args, train, tracker)
        except Exception as e:          # noqa: BLE001 - the tracker failed: measure again
            if tracker is None:
                raise
            tracker, peak_error = None, repr(e)
            out, total_flops, accessed, coll = _measure(fn, args, train, None)
        peak = None
        if tracker is not None:
            snap = tracker.get_tracker_snapshot("peak")
            peak = int(sum(v["Total"] for v in snap.values()))
        terms = roofline_terms(total_flops, accessed, coll.total_bytes)
        mem = {"argument_bytes": arg_bytes, "output_bytes": _nbytes(_local(out)),
               "peak_bytes": peak}
        if peak is None:
            mem["peak_error"] = peak_error
        rank_bytes = peak if peak is not None else arg_bytes
        rec.update(
            status="ok",
            devices=n_dev,
            layout=layout_of(cfg, sp, mesh),
            memory=mem,
            cost={"flops": total_flops, "bytes accessed": accessed},
            collectives=coll.as_dict(),
            roofline=terms,
            fits=rank_bytes <= CARD_BYTES,
            fits_by="peak_bytes" if peak is not None else "argument_bytes",
        )
    except Exception as e:              # noqa: BLE001 - one record per cell
        rec.update(status="error", error=repr(e),
                   traceback=traceback.format_exc()[-2000:])
    finally:
        moe_ep.set_ep_mesh(None)
        tensor_parallel.set_tp_mesh(None)
        dist.destroy_process_group()
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    args = ap.parse_args()

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for mk in meshes:
                cells.append((a, s, mk))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass

    with open(args.out, "a") as f:
        for a, s, mk in cells:
            if (a, s, mk) in done:
                print(f"[skip-done] {a} {s} {mk}", flush=True)
                continue
            print(f"[cell] {a} {s} {mk} ...", flush=True)
            rec = run_cell(a, s, mk)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(f"  -> {rec['status']} wall={rec.get('wall_s', 0)}s "
                  f"{rec.get('error', '')[:200]}", flush=True)


if __name__ == "__main__":
    main()
