"""The port's distribution layer against the JAX package's
(``repro_torch.distributed``, ``launch/mesh.py``, the sharded train step,
``checkpoint.restore_resharded``, ``core/elastic/remesh.py``).

No process group is ever initialised in the pytest process.  Each
scenario group runs in one child process (``tests/_torch_dist_ranks.py``),
which spawns its ranks (8 gloo ranks at most, joined through a ``file://``
store in the test's temporary directory) or, for the rules, builds its
meshes under torch's ``fake`` backend; a hang fails at the child's
timeout.  The JAX side runs here: the rules on ``jax.sharding.AbstractMesh``
(no devices needed), the inputs from ``init_params`` and
``save_checkpoint``.  The JAX package's own distributed tests fail in this
container, so the sharded step is held against the port's one-device step,
which ``tests/test_torch_training.py`` holds against JAX's.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed.compression import _dequantize as jax_dequantize
from repro.distributed.compression import _quantize as jax_quantize
from repro.distributed.sharding import batch_sharding as jax_batch_sharding
from repro.distributed.sharding import cache_sharding as jax_cache_sharding
from repro.distributed.sharding import param_sharding as jax_param_sharding
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.training import make_train_step as jax_make_train_step
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.distributed import AbstractMesh, param_sharding
from repro_torch.distributed.compression import _dequantize, _quantize
from repro_torch.launch.mesh import data_axes, make_mesh, make_production_mesh, model_axis_size
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.training import make_train_step

ROOT = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
CHILD_TIMEOUT = 300
STACKED = {"blocks", "enc_blocks", "dec_blocks"}
MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
BATCHES = (1, 2, 8, 16, 256, 512)
CACHES = ((1, 4096), (8, 1000), (3, 96))
SEQ = 64


@pytest.fixture(autouse=True)
def _no_process_group_here():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group in the pytest process"


def _child(name: str, tmp: Path, args: dict) -> dict:
    """Run scenario ``name`` in a child process; its rank 0's JSON."""
    tmp.mkdir(parents=True, exist_ok=True)
    args = {**args, "out": str(tmp / f"{name}.json"), "store": str(tmp / f"{name}.store"),
            "tmp": str(tmp)}
    path = tmp / f"{name}.args.json"
    path.write_text(json.dumps(args))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, str(RANKS), name, str(path)], capture_output=True,
                       text=True, env=env, timeout=CHILD_TIMEOUT)
    assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-6000:]}"
    return json.loads((tmp / f"{name}.json").read_text())


# ---------------------------------------------------------------------------------
# (a) the rules, leaf by leaf, at six meshes, for all ten configs
# ---------------------------------------------------------------------------------

def _batch_leaves(cfg) -> dict:
    """Per-example shapes of ``cfg``'s training batch."""
    leaves = {"tokens": (SEQ,), "targets": (SEQ,)}
    if cfg.family == "audio":
        leaves["enc_embeds"] = (cfg.enc_len, cfg.d_model)
    if cfg.input_mode == "embeddings":
        leaves["embeds"] = (SEQ, cfg.d_model)
    return leaves


@pytest.fixture(scope="module")
def port_rules(tmp_path_factory):
    args = {"archs": ARCHS, "meshes": MESHES, "batches": BATCHES, "caches": CACHES,
            "batch_leaves": {a: _batch_leaves(jax_config(a)) for a in ARCHS}}
    return _child("rules", tmp_path_factory.mktemp("rules"), args)


def _jax_placements(spec, ndim: int, names, stacked: bool) -> str:
    """The placements a JAX spec names: a mesh dim whose axis shards tensor
    dim d is "S{d}", any other "R"; a stacked leaf's layer dim dropped."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if stacked:
        assert entries[0] is None, spec
        entries = entries[1:]
    out = []
    for axis in names:
        dims = [d for d, e in enumerate(entries)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        assert len(dims) <= 1, (spec, axis)
        out.append(f"S{dims[0]}" if dims else "R")
    return json.dumps(out)


def _jax_expected(tree_sh, tree_abs, names) -> dict:
    out = {}
    flat_sh = jax.tree_util.tree_flatten_with_path(tree_sh)[0]
    flat_abs = jax.tree.leaves(tree_abs)
    assert len(flat_sh) == len(flat_abs)
    for (path, sh), leaf in zip(flat_sh, flat_abs):
        keys = [str(p.key) for p in path if hasattr(p, "key")]
        out["/".join(keys)] = [_jax_placements(sh.spec, leaf.ndim, names,
                                               bool(set(keys) & STACKED))]
    return out


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    cfg = jax_config(arch)
    jm = jax_build_model(cfg)
    p_abs = jm.abstract_params()
    o_abs = jax.eval_shape(jax_adamw_init, p_abs)
    batch = {f"b{B}": {k: jax.ShapeDtypeStruct((B,) + s, jnp.float32)
                       for k, s in _batch_leaves(cfg).items()} for B in BATCHES}
    caches = {}
    for B, S in CACHES:
        caches[f"{B}x{S}"] = jax.eval_shape(functools.partial(jm.init_cache, B, S))
        if cfg.family in ("dense", "moe", "vlm"):
            jm8 = jax_build_model(dataclasses.replace(cfg, kv_cache_dtype="int8"))
            caches[f"{B}x{S}/int8"] = jax.eval_shape(functools.partial(jm8.init_cache, B, S))
    return cfg, p_abs, o_abs, batch, caches


@pytest.mark.parametrize("kind", ["params", "opt", "batch", "cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_jax_leaf_by_leaf(arch, kind, port_rules):
    """``param_sharding`` (and the AdamW state through it), ``batch_sharding``
    and ``cache_sharding`` of the full-width trees give, leaf by leaf and at
    each of six meshes (DeviceMeshes under the fake backend), the
    placements JAX's spec names on the same AbstractMesh."""
    cfg, p_abs, o_abs, batch, caches = _jax_trees(arch)
    for shape, names in MESHES:
        mesh = JaxAbstractMesh(shape, names)
        port = port_rules[arch]["x".join(map(str, shape))][kind]
        if kind == "params":
            expected = _jax_expected(jax_param_sharding(p_abs, mesh), p_abs, names)
        elif kind == "opt":
            expected = _jax_expected(jax_param_sharding(o_abs, mesh), o_abs, names)
        elif kind == "batch":
            expected = _jax_expected(jax_batch_sharding(batch, mesh), batch, names)
        else:
            expected = {k: _jax_expected(jax_cache_sharding(c, cfg, mesh), c, names)
                        for k, c in caches.items()}
        assert port == expected, (shape, names)
        if kind == "params" and shape == (16, 16):
            assert any("S" in v[0] for v in port.values())   # the rules do shard


def test_rules_read_only_names_and_sizes():
    """The rules take an ``AbstractMesh`` with no process group, and a
    ``("pod", "data")`` batch dim is Shard(0) on both mesh dims."""
    model = build_model(get_smoke_config("smollm-135m"), device="meta")
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    sh = param_sharding(model.abstract_params(), mesh)
    assert sh["embed"].spec == ("model", None)
    assert [str(p) for p in sh["embed"].placements] == ["R", "R", "S(0)"]
    from repro_torch.distributed import batch_sharding
    b = batch_sharding({"tokens": torch.empty(8, 4, device="meta")}, mesh)["tokens"]
    assert b.spec == (("pod", "data"), None)
    assert [str(p) for p in b.placements] == ["S(0)", "S(0)", "R"]


def test_meshes_refuse_without_a_process_group():
    """``make_mesh`` and ``make_production_mesh`` never build a one-rank
    mesh quietly; the axis helpers read names and sizes."""
    with pytest.raises(RuntimeError, match="process group of 8 ranks"):
        make_mesh((4, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="process group of 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((4, 2), ("data",), device="cpu")
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert data_axes(mesh) == ("pod", "data") and model_axis_size(mesh) == 16
    assert model_axis_size(AbstractMesh((8,), ("data",))) == 1


# ---------------------------------------------------------------------------------
# (b) the sharded step on (4, 2) against the one-device step
# ---------------------------------------------------------------------------------

STEP_ARCHS = ("qwen2.5-3b", "smollm-135m")


@pytest.fixture(scope="module")
def step_out(tmp_path_factory):
    """The JAX test's inputs (``tests/test_distributed.py``): f32 smoke
    parameters from ``init_params(key(0))``, (8, 32) tokens from
    ``randint(key(1))``, through files."""
    tmp = tmp_path_factory.mktemp("step")
    ckpt, tokens = {}, {}
    for arch in STEP_ARCHS:
        cfg = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32)
        params = jax_build_model(cfg).init_params(jax.random.key(0))
        ckpt[arch] = jax_save_checkpoint(str(tmp / f"{arch}.npz"), params)
        tokens[arch] = str(tmp / f"{arch}-tokens.npy")
        np.save(tokens[arch], np.asarray(
            jax.random.randint(jax.random.key(1), (8, 32), 0, cfg.vocab)))
    return _child("step", tmp, {"world": 8, "mesh": [4, 2], "archs": list(STEP_ARCHS),
                                "ckpt": ckpt, "tokens": tokens})


@pytest.mark.parametrize("kind", ["same", "masked"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_step_matches_one_device_step(arch, kind, step_out):
    """On 8 gloo ranks at (4, 2): the reduced gradients within 1e-5 of each
    leaf's largest magnitude, the loss and ``grad_norm`` (the global norm
    over every shard) within 1e-6 relative, and the parameters after one
    step within the JAX test's 0.05 (what it measures is printed).  With
    ``targets = tokens`` ("same") and with part of one data shard's targets
    masked ("masked"), where each shard's weight is its share of the
    counted targets.  The step's outputs keep its inputs' placements."""
    r = step_out[f"{arch}/{kind}"]
    print(f"{arch}/{kind}: {r}")              # what was measured, with -s
    one, sharded, metric = r["loss"]
    assert sharded == pytest.approx(one, rel=1e-6) and metric == sharded
    assert r["grad_norm"][1] == pytest.approx(r["grad_norm"][0], rel=1e-6)
    assert r["grad_err"] <= 1e-5, r
    assert r["param_diff"] < 0.05, r
    assert r["param_diff"] < 1e-6, r        # what it measures: f32 rounding only
    assert r["v_err"] <= 1e-5, r
    assert r["local_shapes_ok"] and 0 < r["sharded_leaves"] < r["leaves"], r
    assert r["placed_as_in"], r
    assert r["counted"] == (8 * 31 if kind == "same" else 8 * 31 - 2 * 20), r


# ---------------------------------------------------------------------------------
# (c) compression, (d) restore_resharded, (e) remesh: one child
# ---------------------------------------------------------------------------------

RESTORE_ARCHS = ("smollm-135m", "olmoe-1b-7b")


@pytest.fixture(scope="module")
def mesh_out(tmp_path_factory):
    """Checkpoints the JAX package wrote (smoke configs at their own dtype,
    bf16 with olmoe's float32 router), then the child's three groups."""
    tmp = tmp_path_factory.mktemp("mesh")
    ckpt = {}
    for arch in RESTORE_ARCHS:
        params = jax_build_model(jax_smoke_config(arch)).init_params(jax.random.key(0))
        ckpt[arch] = jax_save_checkpoint(str(tmp / f"{arch}.npz"), params, step=3)
    return _child("mesh_state", tmp, {"world": 8, "restore_archs": list(RESTORE_ARCHS),
                                      "ckpt": ckpt})


@pytest.mark.parametrize("seed,shape,scale", [(0, (8, 8), 1.0), (1, (3, 257), 1e-3),
                                              (2, (64,), 1e4), (3, (5, 7, 11), 0.0)])
def test_quantize_matches_jax_bit_for_bit(seed, shape, scale):
    g = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    jq, js = jax_quantize(jnp.asarray(g))
    q, s = _quantize(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(_dequantize(q, s).numpy(),
                                  np.asarray(jax_dequantize(jq, js)))


def test_compression_identical_replicas(mesh_out):
    """The JAX test's two properties on (2, 2, 2): identical replicas reduce
    to the original within int8 error, and the residual is exact."""
    r = mesh_out["identical"]
    assert r["q_err"] < 2.0 / 127.0 and r["residual"] < 1e-6, r


def test_compression_differing_replicas(mesh_out):
    """Pods with different gradients (and a carried error): the reduction is
    the mean of the pods' dequantized values, and each residual is its
    pod's quantization error, bit for bit."""
    r = mesh_out["differing"]
    assert r["mean_of_dequantized"] and r["residual_exact"], r


def test_compressed_grad_fn(mesh_out):
    """``make_compressed_grad_fn`` on (2, 2, 2), with part of one data
    shard's targets masked inside pod 0: the loss is the mean of the pods'
    batch losses (JAX's ``pmean`` over 'pod'), each gradient within half an
    int8 step of the mean of the pods' one-device gradients (each pod's the
    mean over its batch, as the JAX partitioner gives it inside a pod),
    each residual within half a step."""
    r = mesh_out["grad_fn"]
    assert r["loss_rel"] <= 1e-6, r
    assert r["err_over_half_step"] <= 1.01 and r["residual_max_over_half_step"] <= 1.01, r


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("arch", RESTORE_ARCHS)
def test_restore_resharded(arch, writer, mesh_out):
    """A checkpoint written by each package, restored onto (2, 4): every
    ``full_tensor()`` equal bit for bit to the plain load, in its dtype
    (olmoe's router float32), each local block the rules' shape."""
    r = mesh_out["restore"][f"{arch}/{writer}"]
    assert r["equal"] and r["local_shapes_ok"] and r["step"] == 3, r
    if arch == "olmoe-1b-7b":
        assert r["dtypes"] == ["torch.bfloat16", "torch.float32"], r


@pytest.mark.parametrize("i,mesh", [(0, [4, 2]), (1, [2, 4]), (2, [8, 1])])
def test_remesh_keeps_every_value(i, mesh, mesh_out):
    """``scale_replicas`` (4, 2) -> (2, 4) -> (8, 1) over 8 ranks: every
    value bit for bit, the local shards the rules' shapes (a block smaller
    than its leaf only where the model axis has more than one rank)."""
    r = mesh_out["remesh"][i]
    assert r["mesh"] == mesh and r["equal"] and r["local_shapes_ok"], r
    assert (r["split_leaves"] > 0) == (mesh[1] > 1), r


def test_measure_provision_delay_on_a_mesh(mesh_out):
    r = mesh_out["provision"]
    assert r["mesh"] == [4, 2] and r["seconds"] > 0.0, r


def test_fleet_spawn_with_a_process_group_up(mesh_out):
    """A fleet replica spawned while a gloo group is up takes the one-device
    copy (``scale_replicas`` chooses by its ``devices``, not by whether a
    group exists): plain tensors, equal to the checkpoint's."""
    r = mesh_out["fleet_spawn"]
    assert r["plain"] and r["equal"] and r["seconds"] > 0.0, r


def test_restore_resharded_cuts_each_block_where_it_lies(tmp_path):
    """``restore_resharded`` onto (2, 4) as rank 6 (coordinate (1, 2)) under
    the fake backend: each leaf's local block is the whole leaf's block at
    that coordinate, bit for bit, in its dtype (``tests/test_torch_cuda.py``
    reads the card's peak memory of the same restore)."""
    cfg = get_smoke_config("smollm-135m")
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, build_model(cfg, device="cpu").init_params(0), step=2)
    r = _child("fake_restore", tmp_path, {"arch": "smollm-135m", "smoke": True,
                                           "device": "cpu", "ckpt": path})
    assert r["coordinate"] == [1, 2] and r["equal"] and r["step"] == 2, r
    assert r["split_leaves"] > 0 and r["local_bytes"] < r["whole_bytes"], r


# ---------------------------------------------------------------------------------
# (f) compress_pod_grads: ImportError at the first call, in both packages
# ---------------------------------------------------------------------------------

def test_compress_pod_grads_fails_at_first_call_as_in_jax():
    jcfg = dataclasses.replace(jax_smoke_config("smollm-135m"), dtype=jnp.float32)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.key(0))
    toks = jnp.zeros((2, 8), jnp.int32)
    jstep = jax_make_train_step(jm, JaxAdamWConfig(), compress_pod_grads=True)
    with pytest.raises(ImportError, match="int8_pod_allreduce"):
        jstep(jp, jax_adamw_init(jp), {"tokens": toks, "targets": toks})
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    step = make_train_step(model, AdamWConfig(), compress_pod_grads=True)   # no raise here
    t = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ImportError, match="int8_pod_allreduce"):
        step(params, adamw_init(params), {"tokens": t, "targets": t})
