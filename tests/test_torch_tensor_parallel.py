"""The port's tensor-parallel (Megatron) layout
(``repro_torch.distributed.tensor_parallel`` and the model functions on the
rank's blocks) against the JAX package's one-device training step.

The JAX package runs its step under ``pjit`` with the rules'
``in_shardings``, so its products are split the way the rules cut the
leaves; its own multi-device tests do not run in this container, so the
port's layout is held against JAX's one-device ``loss_fn`` and gradients
(computed here, on the CPU, from seeded numpy weights) and against the
port's one-device step.  The ranks run in one child process
(``tests/_torch_dist_ranks.py tensor_parallel``, 8 gloo ranks): no process
group is ever started in the pytest process.  Tolerances (float32): the
loss within 1e-6 relative; each gradient leaf within 1e-5 of its largest
magnitude of the port's one-device gradients (2e-5 for zamba2-2.7b, see
``ONE_TOL``), and of JAX's beyond the distance the port's one-device
step keeps from JAX's on that leaf; the parameters after one AdamW step
within 1e-6 of the one-device step's and of the one-device update of the
step's own gradients, leaving out the elements whose one-device gradient
is within ``NEAR_ZERO`` of 0 (their count is printed): below 10 * eps a
first AdamW step, lr * g / (|g| + eps), is linear in g and turns 1e-9 of
gradient noise into up to 1e-6 of parameter; the second moments within
2e-5; a decode step's logits and cache within 1e-5 of their largest
magnitude.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model

ROOT = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
CHILD_TIMEOUT = 300
MESHES = [(2, 4), (4, 2)]
# qwen2.5-3b smoke (4 / 2 heads): kv heads split at model 2, gathered at 4;
# gemma3-4b (windows, head dim 16); zamba2-2.7b (split attention and
# Mamba-2); mamba2-1.3b; olmoe-1b-7b with EP on; smollm-135m (3 heads:
# attention whole, MLP and vocabulary split)
ARCHS = ["qwen2.5-3b", "gemma3-4b", "zamba2-2.7b", "mamba2-1.3b", "olmoe-1b-7b",
         "smollm-135m"]
B, S = 8, 32
LOSS_TOL, PARAM_TOL, DECODE_TOL = 1e-6, 1e-6, 1e-5
GRAD_TOL = 1e-5
# against the port's one-device step: zamba2-2.7b's smoke gradients carry f32
# noise of ~1e-5 of some leaves' largest magnitude between any two orders of
# summation (the port's one-device step is 1.36e-5 from JAX's on its conv_bc,
# the tensor-parallel step 1.01e-5 from the port's on a gated-norm weight)
ONE_TOL = {"zamba2-2.7b": 2e-5}
V_TOL = 2 * GRAD_TOL        # the second moments: a squared gradient, twice its error
NEAR_ZERO = 10 * 1e-8       # 10 * AdamW's eps
# name -> (arch, mesh, batch): each placement the cache rules pick
DECODE = {
    "heads": ("qwen2.5-3b", (4, 2), 8),              # kv heads on model, batch on data
    "seq_data": ("qwen2.5-3b", (4, 2), 1),           # batch 1: sequence on data
    "seq_model": ("qwen2.5-3b", (2, 4), 8),          # 2 kv heads at 4: sequence on model
    "head_dim": ("qwen2.5-3b", (2, 4), 1),           # sequence on data, head dim on model
    "seq_model_whole": ("smollm-135m", (2, 4), 8),   # attention whole, sequence on model
    "windows_head_dim": ("gemma3-4b", (2, 4), 1),    # sliding windows over the spans
    "hybrid": ("zamba2-2.7b", (2, 4), 1),            # Mamba-2 split, attention heads
}
DECODE_LEN = (32, 21)                                # cache length, prompt length


@pytest.fixture(autouse=True)
def _no_process_group_here():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group in the pytest process"


def _numpy_params(jm, seed: int):
    """Every leaf drawn with numpy: a layer's matrices at std fan_in ** -0.5
    (their second-to-last dim), its vectors (norms, biases, ``A_log``,
    ``D``, ``dt_bias``) at the JAX init's value plus 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    init = jm.init_params(jax.random.key(seed))

    def draw(path, leaf):
        stacked = any(getattr(k, "key", None) in ("blocks", "enc_blocks", "dec_blocks")
                      for k in path)
        per_layer = leaf.shape[1:] if stacked else leaf.shape
        if len(per_layer) >= 2:
            a = rng.normal(size=leaf.shape) * per_layer[-2] ** -0.5
        else:
            a = np.asarray(leaf, np.float32) + 0.1 * rng.normal(size=leaf.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, init)


def _batch(cfg, masked: bool):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    targets = tokens.copy()
    if masked:                             # data shard 0's rows count fewer targets
        targets[:2, 20:] = -1
    return {"tokens": tokens, "targets": targets}


@pytest.fixture(scope="module")
def tp_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ckpt, batches, jax_grads, jax_loss = {}, {}, {}, {}
    for i, arch in enumerate(ARCHS):
        jc = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32)
        jm = jax_build_model(jc)
        jp = _numpy_params(jm, seed=100 + i)
        ckpt[arch] = jax_save_checkpoint(str(tmp / f"{arch}.npz"), jp)
        batch = _batch(jc, masked=jc.moe is None)
        batches[arch] = {}
        for k, v in batch.items():
            batches[arch][k] = str(tmp / f"{arch}-{k}.npy")
            np.save(batches[arch][k], v)
        grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
        for mesh in MESHES:
            # EP routes each data shard's tokens: the reference is the mean
            # of the shards' one-device steps (equal targets a shard)
            n = mesh[0] if jc.moe is not None else 1
            rows = B // n
            parts = [grad_fn(jp, {k: jnp.asarray(v[d * rows:(d + 1) * rows])
                                  for k, v in batch.items()}) for d in range(n)]
            loss = sum(float(lo) for (lo, _), _ in parts) / n
            grads = jax.tree.map(lambda *g: sum(g) / n, *(g for _, g in parts))
            key = f"{arch}/{mesh[0]}x{mesh[1]}"
            jax_loss[key] = loss
            jax_grads[key] = jax_save_checkpoint(str(tmp / f"{arch}-{key.split('/')[1]}-g.npz"),
                                                 grads)
    args = {"world": 8, "archs": ARCHS, "meshes": MESHES, "ckpt": ckpt, "batch": batches,
            "jax_grads": jax_grads, "jax_loss": jax_loss, "decode": DECODE,
            "near_zero": NEAR_ZERO,
            "decode_len": DECODE_LEN, "out": str(tmp / "tp.json"),
            "store": str(tmp / "tp.store"), "tmp": str(tmp)}
    path = tmp / "tp.args.json"
    path.write_text(json.dumps(args))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("REPRO_MOE_EP", None)
    p = subprocess.run([sys.executable, str(RANKS), "tensor_parallel", str(path)],
                       capture_output=True, text=True, env=env, timeout=CHILD_TIMEOUT)
    assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-6000:]}"
    return json.loads((tmp / "tp.json").read_text())


CASES = [(a, m) for a in ARCHS for m in MESHES]


def _key(arch, mesh):
    return f"{arch}/{mesh[0]}x{mesh[1]}"


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tp_step_matches_jax_one_device(arch, mesh, tp_out):
    """The tensor-parallel sharded step's loss (and its metric) within 1e-6
    relative of JAX's one-device ``loss_fn`` and of the port's one-device
    step; every gradient leaf within 1e-5 (``ONE_TOL``) of its largest
    magnitude of the port's one-device gradients, and within 1e-5 of JAX's
    ``value_and_grad`` beyond the port's one-device distance from JAX on
    that leaf."""
    r = tp_out["step"][_key(arch, mesh)]
    loss = r["loss"]
    print(arch, mesh, r["layout"], loss)
    for got in (loss["tp"], loss["tp_metric"]):
        assert got == pytest.approx(loss["jax"], rel=LOSS_TOL)
        assert got == pytest.approx(loss["one"], rel=LOSS_TOL)
    one = r["grads_vs_one"]
    worst = max(one, key=one.get)
    print("grads_vs_one", worst, one[worst])
    assert one[worst] <= ONE_TOL.get(arch, GRAD_TOL), ("grads_vs_one", worst, one[worst])
    floor = r["one_vs_jax"]
    over = {n: e - floor[n] for n, e in r["grads_vs_jax"].items()}
    worst = max(over, key=over.get)
    print("grads_vs_jax", worst, r["grads_vs_jax"][worst], "one-device vs JAX", floor[worst])
    assert over[worst] <= GRAD_TOL, ("grads_vs_jax", worst, r["grads_vs_jax"][worst], floor[worst])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tp_step_update_matches_one_device(arch, mesh, tp_out):
    """After one sharded step the parameters are within 1e-6 of the
    one-device step's, each element whose one-device gradient is within
    ``NEAR_ZERO`` of 0 left out (their count, the exact zeros among them,
    and the largest difference over every element are printed), and of
    the one-device AdamW update of the step's own gradients; the second
    moments within 2e-5 of the one-device step's largest magnitude."""
    r = tp_out["step"][_key(arch, mesh)]
    print(arch, mesh, r["params_vs_one"], r["near_zero"], r["params_vs_one_all"],
          r["params_worst"], r["params_vs_update"], r["v_vs_one"])
    assert r["params_vs_one"] <= PARAM_TOL
    assert r["params_vs_update"] <= PARAM_TOL
    assert r["v_vs_one"] <= V_TOL


# the regions each case must run split (the layout rule) at its model size
SPLIT = {
    ("qwen2.5-3b", 2): {"attention": "split (kv heads split)", "mlp": "split", "vocab": "split"},
    ("qwen2.5-3b", 4): {"attention": "split (kv gathered)", "mlp": "split", "vocab": "split"},
    ("gemma3-4b", 2): {"attention": "split (kv heads split)", "mlp": "split", "vocab": "split"},
    ("gemma3-4b", 4): {"attention": "split (kv gathered)", "mlp": "split", "vocab": "split"},
    ("zamba2-2.7b", 2): {"attention": "split (kv heads split)", "mlp": "split",
                         "mamba2": "split", "vocab": "split"},
    ("zamba2-2.7b", 4): {"attention": "split (kv heads split)", "mlp": "split",
                         "mamba2": "split", "vocab": "split"},
    ("mamba2-1.3b", 2): {"mamba2": "split", "vocab": "split"},
    ("mamba2-1.3b", 4): {"mamba2": "split", "vocab": "split"},
    ("olmoe-1b-7b", 2): {"attention": "split (kv heads split)", "vocab": "split"},
    ("olmoe-1b-7b", 4): {"attention": "split (kv heads split)", "vocab": "split"},
    ("smollm-135m", 2): {"attention": "whole", "mlp": "split", "vocab": "split"},
    ("smollm-135m", 4): {"attention": "whole", "mlp": "split", "vocab": "split"},
}


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tp_step_gathers_only_whole_regions(arch, mesh, tp_out):
    """The layout rule's regions at the case's model size, and a leaf
    gathered whole (``sharding.gather_whole`` of a DTensor, the step's
    ``full_tensor``) once for each leaf of a whole region and for no
    block of a split one."""
    r = tp_out["step"][_key(arch, mesh)]
    assert r["layout"] == SPLIT[(arch, mesh[1])]
    assert r["blocks"] > 0
    assert r["gathered_leaves"] == r["whole_leaves"], r


def test_vocab_cross_entropy_matches_lm_loss(tp_out):
    """``vocab_cross_entropy`` over four vocabulary blocks equals
    ``lm_loss`` on the whole logits (targets < 0 masked, a row half
    masked), its gradient each rank's block of ``lm_loss``'s; every target
    masked gives 0."""
    r = tp_out["ce"]
    assert r["loss"][1] == pytest.approx(r["loss"][0], rel=LOSS_TOL)
    assert r["grad_err"] <= GRAD_TOL
    assert r["all_masked"] == 0.0


# the rules' cache placement each decode case exercises: (data, model) mesh dims
PLACED = {
    "heads": ["S(1)", "S(3)"],
    "seq_data": ["S(2)", "S(3)"],
    "seq_model": ["S(1)", "S(2)"],
    "head_dim": ["S(2)", "S(4)"],
    "seq_model_whole": ["S(1)", "S(2)"],
    "windows_head_dim": ["S(2)", "S(4)"],
    "hybrid": ["S(2)", "S(3)"],
}


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_at_each_cache_placement(case, tp_out):
    """``prefill`` on the rank's blocks gives the rank's block of the
    one-device cache and of its last logits (its vocabulary block), and
    one ``decode_step`` over that cache block the rank's block of the
    one-device logits and cache, within 1e-5 of their largest magnitude,
    at each placement the rules give the cache."""
    r = tp_out["decode"][case]
    print(case, r)
    leaf = "attn_k" if case == "hybrid" else "k"
    assert r["placements"][leaf] == PLACED[case]
    assert r["shapes_ok"]
    for what in ("prefill_logits", "prefill_cache", "decode_logits", "decode_cache"):
        assert r[what] <= DECODE_TOL, (what, r[what])
