"""What each rank runs in the port's multi-rank tests.

``tests/test_torch_distributed.py`` and ``tests/test_torch_cuda.py`` start
one child process per scenario group::

    python tests/_torch_dist_ranks.py <scenario> <args.json>

so that no process group is ever initialised in the pytest process.  The
child spawns its ranks with ``torch.multiprocessing`` (gloo on the CPU,
NCCL on the card), joined through a ``file://`` store in the test's own
temporary directory (no port is shared between test workers); ``rules``
runs in the child itself under torch's ``fake`` backend.  Rank 0 writes
what it measured to ``args["out"]`` as JSON; the test holds it to its
tolerances.  This module imports no JAX: the inputs come as files.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def _placements(sh) -> list[str]:
    return [f"S{p.dim}" if p.is_shard() else "R" for p in sh.placements]


def _collect(tree, fn, prefix="", out=None) -> dict:
    """{dictionary path (list indices dropped): sorted distinct fn(leaf)}."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _collect(v, fn, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, fn, prefix, out)
    else:
        out.setdefault(prefix[:-1], set()).add(json.dumps(fn(tree)))
    return out


def _as_lists(d: dict) -> dict:
    return {k: sorted(v) for k, v in d.items()}


# ---------------------------------------------------------------------------------
# rules: the placements at the production meshes, under the fake backend
# ---------------------------------------------------------------------------------

def rules(args) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.distributed import batch_sharding, cache_sharding, param_sharding
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    trees = {}
    for arch in args["archs"]:
        cfg = get_config(arch)
        model = build_model(cfg, device="meta")
        p_abs = model.abstract_params()
        caches = {}
        for B, S in args["caches"]:
            caches[f"{B}x{S}"] = model.init_cache(B, S)
            if cfg.family in ("dense", "moe", "vlm"):
                caches[f"{B}x{S}/int8"] = build_model(
                    dataclasses.replace(cfg, kv_cache_dtype="int8"),
                    device="meta").init_cache(B, S)
        batch = {f"b{B}": {k: torch.empty((B,) + tuple(s), device="meta")
                           for k, s in args["batch_leaves"][arch].items()}
                 for B in args["batches"]}
        trees[arch] = (cfg, p_abs, adamw_init(p_abs), batch, caches)
    out = {}
    for shape, names in args["meshes"]:
        world = 1
        for n in shape:
            world *= n
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        try:
            mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
            key = "x".join(map(str, shape))
            for arch, (cfg, p_abs, o_abs, batch, caches) in trees.items():
                out.setdefault(arch, {})[key] = {
                    "params": _as_lists(_collect(param_sharding(p_abs, mesh), _placements)),
                    "opt": _as_lists(_collect(param_sharding(o_abs, mesh), _placements)),
                    "batch": _as_lists(_collect(batch_sharding(batch, mesh), _placements)),
                    "cache": {k: _as_lists(_collect(cache_sharding(c, cfg, mesh), _placements))
                              for k, c in caches.items()},
                }
        finally:
            dist.destroy_process_group()
    Path(args["out"]).write_text(json.dumps(out))


# ---------------------------------------------------------------------------------
# the multi-rank scenarios
# ---------------------------------------------------------------------------------

def _init(rank: int, args) -> None:
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    backend = args.get("backend", "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{args['store']}", rank=rank,
                            world_size=args["world"])


def _worker(rank: int, name: str, args) -> None:
    _init(rank, args)
    try:
        result = globals()["_" + name](rank, args)
        if rank == 0:
            Path(args["out"]).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def _scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    a, b = a.detach().cpu().float(), b.detach().cpu().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _step(rank, args):
    """(b) The sharded step on (4, 2) against the one-device step, each
    arch's parameters from a JAX checkpoint and its (8, 32) tokens: with
    ``targets = tokens`` ("same") and with targets -1 on part of data shard
    0's rows ("masked"), so the shards count different numbers of targets."""
    import numpy as np

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        place,
        shard_params,
        sharded_loss_and_grads,
        sharded_step,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.training import make_train_step, train_state_shardings

    mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
    result = {}
    for arch in args["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        params, _ = load_checkpoint(args["ckpt"][arch], model.abstract_params(), device="cpu")
        toks = torch.from_numpy(np.load(args["tokens"][arch]))
        masked = toks.clone()
        masked[:2, 12:] = -1                       # data shard 0 holds rows 0 and 1
        for kind, targets in (("same", toks), ("masked", masked)):
            batch = {"tokens": toks, "targets": targets}
            step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=10))
            p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batch)
            sp = shard_params(params, mesh)
            so = tree_map(place, adamw_init(params), o_sh)
            loss2, g2 = sharded_loss_and_grads(step, sp, batch, (p_sh, b_sh))
            g2 = [g.full_tensor() for g in tree_leaves(g2)]
            p2, o2, m2 = sharded_step(step, (p_sh, o_sh, b_sh))(sp, so, batch)
            placed_as_in = all(a.placements == b.placements
                               for a, b in zip(tree_leaves((p2, o2)), tree_leaves((sp, so))))
            p2 = [p.full_tensor() for p in tree_leaves(p2)]
            m2v = [o.full_tensor() for o in tree_leaves(o2["v"])]
            ok_shards = all(
                tuple(p.to_local().shape) == _chunk(p.shape, sh.placements, mesh)
                for p, sh in zip(tree_leaves(sp), tree_leaves(p_sh)))
            if rank != 0:
                continue
            loss1, grads1 = step.grads_of(params, batch)
            p1, o1, m1 = step(params, adamw_init(params), batch)
            result[f"{arch}/{kind}"] = {
                "loss": [float(loss1), float(loss2), float(m2["loss"])],
                "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
                "grad_err": max(_scaled_err(a, b) for a, b in zip(g2, tree_leaves(grads1))),
                "param_diff": max(float((a - b).abs().max())
                                  for a, b in zip(p2, tree_leaves(p1))),
                "v_err": max(_scaled_err(a, b) for a, b in zip(m2v, tree_leaves(o1["v"]))),
                "sharded_leaves": sum(any(q.is_shard() for q in sh.placements)
                                      for sh in tree_leaves(p_sh)),
                "leaves": len(tree_leaves(p_sh)),
                "local_shapes_ok": ok_shards,
                "placed_as_in": placed_as_in,
                "counted": int((targets[:, 1:] >= 0).sum()),
            }
    return result


def _chunk(shape, placements, mesh) -> tuple:
    """The local block shape of ``shape`` under ``placements``: each
    ``Shard(d)`` divides dim d by its mesh dim's size."""
    out = list(shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(mdim)
    return tuple(out)


def _mesh_state(rank, args):
    """(c) compression on (2, 2, 2); (d) restore_resharded onto (2, 4), and
    ``CheckpointManager.restore_latest`` with and without shardings;
    (e) remesh (4, 2) -> (2, 4) -> (8, 1); a fleet replica spawned while
    the group is up."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import (
        CheckpointManager,
        load_checkpoint,
        restore_resharded,
        save_checkpoint,
    )
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.elastic.remesh import measure_provision_delay, scale_replicas
    from repro_torch.distributed.compression import (
        _dequantize,
        _quantize,
        compress_allreduce_pod,
        init_error_state,
        make_compressed_grad_fn,
    )
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.pytree import tree_leaves
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.fleet import ReplicaPool
    from repro_torch.training.train_step import loss_and_grads

    out = {}
    # (c) compression over the pod axis of a (2, 2, 2) mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    pod_group = mesh.get_group("pod")
    pod = mesh.get_coordinate()[0]
    g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    err = init_error_state(g)
    red, new_err = compress_allreduce_pod(g, err, group=pod_group)
    out["identical"] = {
        "q_err": float((red["w"] - g["w"]).abs().max()),
        "residual": float((new_err["w"] + red["w"] - g["w"] - err["w"]).abs().max())}
    gens = [torch.Generator().manual_seed(10 + p) for p in range(2)]
    per_pod = [{"w": torch.randn(8, 8, generator=gen), "b": torch.randn(5, generator=gen)}
               for gen in gens]
    e0 = {"w": torch.full((8, 8), 1e-3), "b": torch.zeros(5)}
    red, new_err = compress_allreduce_pod(per_pod[pod], e0, group=pod_group)
    mine = {k: v + e0[k] for k, v in per_pod[pod].items()}
    exact, resid = True, True
    for k in ("w", "b"):
        deq = [_dequantize(*_quantize(pp[k] + e0[k])) for pp in per_pod]
        exact &= torch.equal(red[k], (deq[0] + deq[1]) / 2.0)
        resid &= torch.equal(new_err[k], mine[k] - _dequantize(*_quantize(mine[k])))
    out["differing"] = {"mean_of_dequantized": bool(exact), "residual_exact": bool(resid)}
    # make_compressed_grad_fn on smollm-135m smoke, f32, with part of pod 0's
    # data shard 0 (rows 0 and 1) masked: against the pods' one-device
    # gradients, each the mean over its pod's batch
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    toks = torch.randint(0, cfg.vocab, (8, 16), generator=torch.Generator().manual_seed(3))
    targets = toks.clone()
    targets[:2, 8:] = -1
    batch = {"tokens": toks, "targets": targets}
    loss, grads, errs = make_compressed_grad_fn(model.loss_fn, mesh)(
        params, batch, init_error_state(params))
    pods = [loss_and_grads(model.loss_fn, params, {k: v[4 * p:4 * p + 4]
                                                   for k, v in batch.items()})
            for p in range(2)]
    worst = 0.0
    for r, a, b in zip(tree_leaves(grads), tree_leaves(pods[0][2]), tree_leaves(pods[1][2])):
        half_step = max(float(a.abs().max()), float(b.abs().max())) / 127.0 / 2
        worst = max(worst, float((r - (a + b) / 2).abs().max()) / max(half_step, 1e-30))
    pod_mean_loss = (float(pods[0][0]) + float(pods[1][0])) / 2
    out["grad_fn"] = {"loss_rel": abs(float(loss) - pod_mean_loss) / pod_mean_loss,
                      "err_over_half_step": worst,
                      "residual_max_over_half_step": max(
                          float(e.abs().max()) / max(float(a.abs().max()) / 254, 1e-30)
                          for e, a in zip(tree_leaves(errs), tree_leaves(pods[pod][2])))}
    # (d) restore_resharded onto (2, 4): files the JAX package and the port wrote
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    out["restore"], out["restore_latest"] = {}, {}
    for arch in args["restore_archs"]:
        cfg = get_smoke_config(arch)
        template = build_model(cfg, device="meta").abstract_params()
        ref, _ = load_checkpoint(args["ckpt"][arch], template, device="cpu")
        port_path = os.path.join(args["tmp"], f"{arch}-port.npz")
        if rank == 0:
            save_checkpoint(port_path, ref, step=3)
        dist.barrier()
        sh = param_sharding(template, mesh)
        for who, path in (("jax", args["ckpt"][arch]), ("port", port_path)):
            tree, meta = restore_resharded(path, template, sh)
            same = all(torch.equal(t.full_tensor(), r) and t.dtype == r.dtype
                       for t, r in zip(tree_leaves(tree), tree_leaves(ref)))
            shapes = all(tuple(t.to_local().shape) == _chunk(t.shape, s.placements, mesh)
                         and tuple(t.placements) == s.placements
                         for t, s in zip(tree_leaves(tree), tree_leaves(sh)))
            dtypes = sorted({str(t.dtype) for t in tree_leaves(tree)})
            out["restore"][f"{arch}/{who}"] = {"equal": same, "local_shapes_ok": shapes,
                                               "step": meta.get("step"), "dtypes": dtypes}
        # the manager's restore_latest: with shardings it is restore_resharded
        # of its newest file, block for block; without, the plain load
        mgr_dir = os.path.join(args["tmp"], f"{arch}-mgr")
        if rank == 0:
            CheckpointManager(mgr_dir, async_save=False).save(ref, step=5)
        dist.barrier()
        mgr = CheckpointManager(mgr_dir, async_save=False)
        tree, meta = mgr.restore_latest(template, sh)
        want, want_meta = restore_resharded(mgr.latest(), template, sh)
        plain, plain_meta = mgr.restore_latest(template, device="cpu")
        out["restore_latest"][arch] = {
            "blocks_equal": all(
                isinstance(t, DTensor) and tuple(t.placements) == tuple(w.placements)
                and t.dtype == w.dtype and torch.equal(t.to_local(), w.to_local())
                for t, w in zip(tree_leaves(tree), tree_leaves(want))),
            "meta_equal": meta == want_meta, "step": meta.get("step"),
            "plain_equal": all(not isinstance(t, DTensor) and t.dtype == r.dtype
                               and torch.equal(t, r)
                               for t, r in zip(tree_leaves(plain), tree_leaves(ref))),
            "plain_step": plain_meta.get("step")}
    # (e) remesh: (4, 2) -> (2, 4) -> (8, 1), then a provision delay at (4, 2)
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    ref = model.init_params(0)
    params = ref
    out["remesh"] = []
    for tp in (2, 4, 1):
        new_mesh, params = scale_replicas(params, devices=list(range(8)), model_parallel=tp)
        sh = param_sharding(ref, new_mesh)
        out["remesh"].append({
            "mesh": list(new_mesh.shape),
            "equal": all(torch.equal(t.full_tensor(), r)
                         for t, r in zip(tree_leaves(params), tree_leaves(ref))),
            "local_shapes_ok": all(
                tuple(t.to_local().shape) == _chunk(t.shape, s.placements, new_mesh)
                and tuple(t.placements) == s.placements
                for t, s in zip(tree_leaves(params), tree_leaves(sh))),
            "split_leaves": sum(tuple(t.to_local().shape) != tuple(t.shape)
                                for t in tree_leaves(params))})
    secs, new_mesh, params = measure_provision_delay(model, ref, devices=list(range(8)),
                                                     model_parallel=2)
    out["provision"] = {"seconds": secs, "mesh": list(new_mesh.shape)}
    # a fleet replica spawned while this gloo group is up: the one-device copy
    if rank == 0:
        cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        path = save_checkpoint(os.path.join(args["tmp"], "fleet", "ckpt_00000001.npz"),
                               model.init_params(0), step=1)
        ref, _ = load_checkpoint(path, model.abstract_params(), device="cpu")
        rep, secs = ReplicaPool(model, path, ServeConfig(max_batch=4, max_len=128,
                                                         decode_steps=4)).spawn()
        leaves = tree_leaves(rep.eng.params)
        out["fleet_spawn"] = {
            "seconds": secs,
            "plain": not any(isinstance(t, DTensor) for t in leaves),
            "equal": all(torch.equal(t, r) for t, r in zip(leaves, tree_leaves(ref)))}
    return out


def _nccl_step(rank, args):
    """World size 1 on the card: the sharded step on a 1x1 mesh against the
    plain step, bit for bit, from the same seeded state."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import place, shard_params, sharded_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.training import make_train_step, train_state_shardings

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    cfg = get_smoke_config(args["arch"])
    model = build_model(cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": toks}
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3))
    params = model.init_params(0)
    p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batch)
    sp, so = shard_params(params, mesh), tree_map(place, adamw_init(params), o_sh)
    run = sharded_step(step, (p_sh, o_sh, b_sh))
    p, o = params, adamw_init(params)
    plain, sharded = [], []
    for _ in range(3):
        p, o, m = step(p, o, batch)
        sp, so, ms = run(sp, so, batch)
        plain.append(float(m["loss"]))
        sharded.append(float(ms["loss"]))
    same = all(torch.equal(a.full_tensor(), b) for a, b in zip(tree_leaves(sp), tree_leaves(p)))
    same_v = all(torch.equal(a.full_tensor(), b)
                 for a, b in zip(tree_leaves(so["v"]), tree_leaves(o["v"])))
    return {"plain": plain, "sharded": sharded, "params_equal": same, "v_equal": same_v}


def _moe_ep(rank, args):
    """The expert-parallel sharded step (``moe_ep.set_ep_mesh(mesh)``)
    against the plain sharded step on the same mesh and the one-device
    step, each case's f32 smoke parameters from a JAX checkpoint and its
    tokens (``targets = tokens``): losses, every gradient leaf, the
    parameters and the second moments after one step.  The one-device
    reference is the one-device step's gradients over each data shard's
    rows, averaged (equal shares of targets): the batch mean when each
    shard routes its own tokens, as both sharded steps do; at one data
    rank, the one-device step itself.  Every MoE dispatch's dropped pairs
    are counted.  Both sharded steps run the tensor-parallel layout
    (attention, the vocabulary and, under EP, the experts split)."""
    import numpy as np

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed.sharding import (
        place,
        shard_params,
        sharded_loss_and_grads,
        sharded_step,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.training import make_train_step, train_state_shardings

    drops = []
    plain_dispatch = moe.dispatch

    def counting(experts, C, n_experts):
        plan = plain_dispatch(experts, C, n_experts)
        drops.append(int((~plan[3]).sum()))
        return plan

    moe.dispatch = counting
    ep_calls = []
    plain_ep = moe_ep.moe_ffn_ep

    def counted_ep(*a, **kw):
        ep_calls.append(1)
        return plain_ep(*a, **kw)

    moe_ep.moe_ffn_ep = counted_ep
    result = {}
    for arch, shape in args["cases"]:
        mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        params, _ = load_checkpoint(args["ckpt"][arch], model.abstract_params(), device="cpu")
        toks = torch.from_numpy(np.load(args["tokens"][arch]))
        batch = {"tokens": toks, "targets": toks}
        step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=10))
        p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batch)
        names = [k for k, _ in _named_leaves(params)]
        runs = {}
        for mode in ("plain", "ep"):
            moe_ep.set_ep_mesh(mesh if mode == "ep" else None)
            n0, e0 = len(drops), len(ep_calls)
            sp = shard_params(params, mesh)
            so = tree_map(place, adamw_init(params), o_sh)
            loss, g = sharded_loss_and_grads(step, sp, batch, (p_sh, b_sh))
            placed = all(a.placements == s.placements
                         for a, s in zip(tree_leaves(g), tree_leaves(p_sh)))
            g = [x.full_tensor() for x in tree_leaves(g)]
            p2, o2, m2 = sharded_step(step, (p_sh, o_sh, b_sh))(sp, so, batch)
            placed &= all(a.placements == b.placements
                          for a, b in zip(tree_leaves((p2, o2)), tree_leaves((sp, so))))
            runs[mode] = {"loss": float(loss), "metric": float(m2["loss"]), "grads": g,
                          "params": [x.full_tensor() for x in tree_leaves(p2)],
                          "v": [x.full_tensor() for x in tree_leaves(o2["v"])],
                          "placed": placed, "drops": sum(drops[n0:]),
                          "dispatches": len(drops) - n0, "ep_calls": len(ep_calls) - e0}
        moe_ep.set_ep_mesh(None)
        if rank != 0:
            continue
        n_data = shape[0]
        rows = toks.shape[0] // n_data
        n0 = len(drops)
        parts = [step.grads_of(params, {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
                 for d in range(n_data)]
        ref_loss = sum(float(lo) for lo, _ in parts) / n_data
        ref_g = [sum(gs) / n_data for gs in zip(*(tree_leaves(g) for _, g in parts))]
        p1, o1, _ = step.update(params, tree_unflatten(params, ref_g), adamw_init(params))
        ref = {"grads": ref_g, "params": tree_leaves(p1), "v": tree_leaves(o1["v"])}
        res = {"loss": {"one": ref_loss, **{m: [r["loss"], r["metric"]] for m, r in runs.items()}},
               "placed": {m: r["placed"] for m, r in runs.items()},
               "drops": {m: r["drops"] for m, r in runs.items()} | {"one": sum(drops[n0:])},
               "dispatches": {m: r["dispatches"] for m, r in runs.items()},
               "ep_calls": {m: r["ep_calls"] for m, r in runs.items()}}
        for against, other in (("one", ref), ("plain", runs["plain"])):
            for what in ("grads", "params", "v"):
                res[f"{what}_vs_{against}"] = {
                    n: _scaled_err(a, b) for n, a, b in zip(names, runs["ep"][what], other[what])}
        result[f"{arch}/{'x'.join(map(str, shape))}"] = res
    moe.dispatch, moe_ep.moe_ffn_ep = plain_dispatch, plain_ep
    return result


def _named_leaves(tree, prefix=""):
    """(path, leaf) pairs in ``tree_leaves`` order; a list index is kept."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


# ---------------------------------------------------------------------------------
# the tensor-parallel (Megatron) layout
# ---------------------------------------------------------------------------------

def _tensor_parallel(rank, args):
    """The tensor-parallel layout on 8 gloo ranks: (a) the sharded step on
    each mesh of ``args["meshes"]`` for each arch, its f32 smoke parameters
    and (8, 32) batch from files, against the JAX package's one-device
    loss and gradients (files, computed in the test process) and the
    port's one-device step (loss, every gradient leaf, the parameters and
    second moments after one step); ``sharding.gather_whole`` counted, so
    only the leaves of whole regions are gathered; (b) ``vocab_cross_entropy``
    against ``lm_loss``; (c) ``prefill`` and one ``decode_step`` on the
    rank's blocks at each cache placement, against the one-device ones."""
    import numpy as np
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import moe_ep, tensor_parallel
    from repro_torch.distributed.sharding import (
        _block,
        batch_sharding,
        cache_sharding,
        param_sharding,
        place,
        shard_params,
        sharded_loss_and_grads,
        sharded_step,
        split_blocks,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import lm_loss
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.training import make_train_step, train_state_shardings

    from repro_torch.distributed import sharding

    gathered = []
    plain_gather = sharding.gather_whole

    def counting_gather(x):
        gathered.append(isinstance(x, DTensor))
        return plain_gather(x)

    result = {"step": {}, "decode": {}}
    meshes = {tuple(m): make_mesh(tuple(m), ("data", "model"), device="cpu")
              for m in args["meshes"]}
    for arch in args["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        params, _ = load_checkpoint(args["ckpt"][arch], model.abstract_params(), device="cpu")
        batch = {k: torch.from_numpy(np.load(v)) for k, v in args["batch"][arch].items()}
        names = [k for k, _ in _named_leaves(params)]
        step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=10))
        ep = cfg.moe is not None
        for shape, mesh in meshes.items():
            key = f"{arch}/{'x'.join(map(str, shape))}"
            jax_ref, _ = load_checkpoint(args["jax_grads"][key], model.abstract_params(),
                                         device="cpu")
            p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batch)
            moe_ep.set_ep_mesh(mesh if ep else None)
            try:
                sp = shard_params(params, mesh)
                so = tree_map(place, adamw_init(params), o_sh)
                blocks = split_blocks(p_sh, cfg, mesh)
                sharding.gather_whole = counting_gather
                n0 = len(gathered)
                loss, g = sharded_loss_and_grads(step, sp, batch, (p_sh, b_sh))
                n_full = sum(gathered[n0:])
                sharding.gather_whole = plain_gather
                g = [x.full_tensor() for x in tree_leaves(g)]
                p2, o2, m2 = sharded_step(step, (p_sh, o_sh, b_sh))(sp, so, batch)
                p2 = [x.full_tensor() for x in tree_leaves(p2)]
                v2 = [x.full_tensor() for x in tree_leaves(o2["v"])]
            finally:
                sharding.gather_whole = plain_gather
                moe_ep.set_ep_mesh(None)
            if rank != 0:
                continue
            # the one-device reference: the whole batch, or with EP the mean
            # over the data shards' own steps (each shard routes its tokens)
            n_data = shape[0] if ep else 1
            rows = batch["tokens"].shape[0] // n_data
            parts = [step.grads_of(params, {k: v[d * rows:(d + 1) * rows]
                                            for k, v in batch.items()})
                     for d in range(n_data)]
            loss1 = sum(float(lo) for lo, _ in parts) / n_data
            g1 = [sum(gs) / n_data for gs in zip(*(tree_leaves(x) for _, x in parts))]
            p1, o1, _ = step.update(params, tree_unflatten(params, g1), adamw_init(params))
            layout = tensor_parallel.layout(cfg, shape[1])
            # the parameters against the one-device step's where its gradient
            # is not within near_zero of 0 (there AdamW's first step is linear in g)
            far = [gg.abs() > args["near_zero"] for gg in g1]
            result["step"][key] = {
                "layout": layout,
                "loss": {"jax": float(args["jax_loss"][key]), "one": loss1,
                         "tp": float(loss), "tp_metric": float(m2["loss"])},
                "grads_vs_jax": {n: _scaled_err(a, b) for n, a, b in
                                 zip(names, g, tree_leaves(jax_ref))},
                "grads_vs_one": {n: _scaled_err(a, b) for n, a, b in zip(names, g, g1)},
                "one_vs_jax": {n: _scaled_err(a, b) for n, a, b in
                               zip(names, g1, tree_leaves(jax_ref))},
                "params_vs_one": max(float(((a - b).abs() * f).max())
                                     for a, b, f in zip(p2, tree_leaves(p1), far)),
                "params_vs_one_all": max(float((a - b).abs().max())
                                         for a, b in zip(p2, tree_leaves(p1))),
                "near_zero": {"excluded": sum(int((~f).sum()) for f in far),
                              "of_them_zero": sum(int((gg == 0).sum()) for gg in g1),
                              "elements": sum(gg.numel() for gg in g1)},
                # the one-device AdamW update of the tensor-parallel step's own
                # gradients: the sharded update, held apart from gradient noise
                "params_vs_update": max(
                    float((a - b).abs().max()) for a, b in zip(p2, tree_leaves(step.update(
                        params, tree_unflatten(params, g), adamw_init(params))[0]))),
                "params_worst": max(((float((a - b).abs().max()), n,
                                      float(gg.flatten()[(a - b).abs().argmax()]))
                                     for n, a, b, gg in zip(names, p2, tree_leaves(p1), g1)),
                                    key=lambda t: t[0]),
                "v_vs_one": max(_scaled_err(a, b) for a, b in zip(v2, tree_leaves(o1["v"]))),
                "blocks": sum(tree_leaves(blocks)),
                "whole_leaves": len(tree_leaves(blocks)) - sum(tree_leaves(blocks)),
                "gathered_leaves": n_full,
            }

    # (b) the vocabulary-parallel cross-entropy on a (2, 4) mesh's model axis
    mesh = meshes[(2, 4)]
    with tensor_parallel.tp_mesh(mesh):
        g = tensor_parallel.model_group()
        rng = np.random.default_rng(5)
        logits = torch.from_numpy(rng.normal(size=(3, 9, 64)).astype(np.float32) * 3)
        targets = torch.from_numpy(rng.integers(0, 64, (3, 9)))
        targets[0, 4:] = -1
        targets[2, 1] = -7
        whole = logits.clone().requires_grad_(True)
        ref = lm_loss(whole, targets)
        ref.backward()
        block = logits.chunk(g.mp, -1)[g.rank].clone().requires_grad_(True)
        got = tensor_parallel.vocab_cross_entropy(block, targets, g)
        got.backward()
        all_masked = targets.clone().fill_(-1)
        zero = tensor_parallel.vocab_cross_entropy(logits.chunk(g.mp, -1)[g.rank], all_masked, g)
        result["ce"] = {"loss": [float(ref), float(got)],
                        "grad_err": _scaled_err(block.grad, whole.grad.chunk(g.mp, -1)[g.rank]),
                        "all_masked": float(zero)}

    # (c) prefill and one decode step on the rank's blocks, per cache placement
    for name, (arch, shape, B) in args["decode"].items():
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        params, _ = load_checkpoint(args["ckpt"][arch], model.abstract_params(), device="cpu")
        mesh = meshes[tuple(shape)]
        s_max, s0 = args["decode_len"]
        rng = np.random.default_rng(17)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, s0 + 1)).astype(np.int32))
        with torch.no_grad():
            lp1, cache1 = model.prefill(params, {"tokens": toks[:, :s0]}, max_len=s_max)
            pre1 = tree_map(lambda t: t.clone(), cache1)
            ld1, cache1 = model.decode_step(params, cache1, toks[:, s0:], s0)
        c_sh = cache_sharding(pre1, cfg, mesh)
        p_sh = param_sharding(params, mesh)
        lparams = tree_map(lambda t, sh: _block(t, mesh, sh.placements), params, p_sh)
        rows = batch_sharding({"t": toks}, mesh)["t"]
        ltoks = _block(toks, mesh, rows.placements)
        split = tensor_parallel.cache_split(c_sh["attn_k" if "attn_k" in c_sh else "k"])
        vocab = tensor_parallel.vocab_split(cfg, shape[1])
        coord = mesh.get_coordinate()

        def logit_block(t):
            t = _block(t, mesh, rows.placements)
            return t.chunk(shape[1], -1)[coord[1]] if vocab else t

        with torch.no_grad(), tensor_parallel.tp_mesh(mesh):
            lp, cache = model.prefill(lparams, {"tokens": ltoks[:, :s0]}, max_len=s_max,
                                      cache_split=split)
            pre_err = max(_scaled_err(cache[k], _block(pre1[k], mesh, c_sh[k].placements))
                          for k in cache)
            ld, cache = model.decode_step(lparams, cache, ltoks[:, s0:], s0, cache_split=split)
        result["decode"][name] = {
            "placements": {k: [str(p) for p in c_sh[k].placements] for k in c_sh},
            "split": None if split is None else {"seq": [a.mp for a in split.seq],
                                                 "dim": split.dim and split.dim.mp},
            "layout": tensor_parallel.layout(cfg, shape[1]),
            "prefill_logits": _scaled_err(lp, logit_block(lp1)),
            "prefill_cache": pre_err,
            "decode_logits": _scaled_err(ld, logit_block(ld1)),
            "decode_cache": max(_scaled_err(cache[k], _block(cache1[k], mesh, c_sh[k].placements))
                                for k in cache),
            "shapes_ok": all(tuple(cache[k].shape) == tuple(_block(cache1[k], mesh,
                                                                   c_sh[k].placements).shape)
                             for k in cache)}
    return result


# ---------------------------------------------------------------------------------
# restore_resharded as one rank of a (2, 4) mesh, under the fake backend
# ---------------------------------------------------------------------------------

FAKE_RANK, FAKE_COORD = 6, (1, 2)              # rank 6 of a (2, 4) mesh


def fake_restore(args) -> None:
    """``restore_resharded`` of ``args["ckpt"]`` onto a (2, 4) ("data",
    "model") mesh on ``args["device"]``, as rank 6 of 8 under the fake
    backend (no other rank runs; no collective moves data): each leaf's
    local block against the whole leaf's block at mesh coordinate (1, 2),
    cut here independently; on the card, the restore's peak device memory
    beside the bytes of this rank's blocks and of the whole tree."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.checkpoint import load_checkpoint, restore_resharded
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import param_sharding
    from repro_torch.models import build_model
    from repro_torch.pytree import tree_leaves

    cfg = (get_smoke_config if args["smoke"] else get_config)(args["arch"])
    template = build_model(cfg, device="meta").abstract_params()
    ref, _ = load_checkpoint(args["ckpt"], template, device="cpu")
    cuda = args["device"] == "cuda"
    dist.init_process_group("fake", store=FakeStore(), rank=FAKE_RANK, world_size=8)
    try:
        mesh = init_device_mesh(args["device"], (2, 4), mesh_dim_names=("data", "model"))
        sh = param_sharding(template, mesh)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        tree, meta = restore_resharded(args["ckpt"], template, sh)
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        equal, split = True, 0
        for t, r, s in zip(tree_leaves(tree), tree_leaves(ref), tree_leaves(sh)):
            want = r
            for mdim, pl in enumerate(s.placements):
                if pl.is_shard():
                    n = want.shape[pl.dim] // mesh.size(mdim)
                    want = want.narrow(pl.dim, FAKE_COORD[mdim] * n, n)
            split += tuple(want.shape) != tuple(r.shape)
            equal &= (t.device.type == args["device"] and t.dtype == r.dtype
                      and torch.equal(t.to_local().cpu(), want))
        result = {
            "coordinate": list(mesh.get_coordinate()), "equal": bool(equal),
            "split_leaves": split, "step": meta.get("step"), "peak_bytes": peak,
            "local_bytes": sum(t.to_local().numel() * t.element_size()
                               for t in tree_leaves(tree)),
            "whole_bytes": sum(r.numel() * r.element_size() for r in tree_leaves(ref))}
    finally:
        dist.destroy_process_group()
    Path(args["out"]).write_text(json.dumps(result))


# ---------------------------------------------------------------------------------
# the dry run's small cells and the collective counter, under the fake backend
# ---------------------------------------------------------------------------------

def dryrun(args) -> None:
    """``launch.dryrun.run_cell`` at the smoke configs' small cells (each
    starts and destroys its own fake process group); the collectives of an
    olmoe-smoke prefill on a (2, 4) mesh, one event each; and a scripted
    sequence of every collective kind through ``collective_stats``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeSpec, get_smoke_config
    from repro_torch.distributed.hlo_analysis import collective_stats
    from repro_torch.launch.dryrun import build_cell, run_cell

    out = {"cells": {}}
    for name, (arch, kind, seq, batch, shape, axes) in args["cells"].items():
        out["cells"][name] = run_cell(arch, ShapeSpec(name, seq, batch, kind), "small",
                                      mesh_shape=shape, mesh_axes=axes,
                                      cfg_override=get_smoke_config(arch))
    out["skipped"] = run_cell("qwen2.5-3b", "long_500k", "single")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        fn, cell_args = build_cell("olmoe-1b-7b", ShapeSpec("p", 32, 8, "prefill"), mesh,
                                   cfg_override=get_smoke_config("olmoe-1b-7b"))
        with torch.no_grad(), collective_stats() as st:
            fn(*cell_args)
        out["prefill_events"] = st.events
        g = mesh.get_group("model")
        with collective_stats() as st:
            dist.all_reduce(torch.empty(3, 5), group=g)                       # 60 B
            dist.all_gather_into_tensor(torch.empty(8, 3), torch.empty(2, 3),
                                        group=g)                                # 96 B
            dist.reduce_scatter_tensor(torch.empty(2, 3, dtype=torch.bfloat16),
                                       torch.empty(8, 3, dtype=torch.bfloat16),
                                       group=g)                                # 12 B
            dist.all_to_all_single(torch.empty(8, 2, dtype=torch.float64),
                                   torch.empty(8, 2, dtype=torch.float64),
                                   group=g)                                    # 128 B
            dist.recv(torch.empty(7, dtype=torch.int32), src=1, group=g)       # 28 B
            dist.send(torch.empty(7, dtype=torch.int32), dst=1, group=g)       # none
            funcol.all_reduce(torch.empty(4), "sum", g)                        # 16 B
            DTensor.from_local(torch.empty(2, 4, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False).full_tensor()
        out["scripted"] = {"events": st.events, "stats": st.as_dict()}
    finally:
        dist.destroy_process_group()
    Path(args["out"]).write_text(json.dumps(out))


def main() -> None:
    name, args = sys.argv[1], json.loads(Path(sys.argv[2]).read_text())
    if name in ("rules", "fake_restore", "dryrun"):           # one process
        globals()[name](args)
        return
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")    # before cuBLAS starts
    mp.spawn(_worker, args=(name, args), nprocs=args["world"], join=True)


if __name__ == "__main__":
    main()
