"""The port's dry run (``repro_torch.launch.dryrun``), the configs' shape
helpers and the collective counter (``distributed/hlo_analysis.py``)
against the JAX package's.

The shape helpers are compared here, in the pytest process.  Every cell
starts torch's ``fake`` process-group backend, so the cells run in one
child process (``tests/_torch_dist_ranks.py dryrun``), or through the CLI
in another: no process group is ever started in the pytest process.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_supported as jax_shape_supported
from repro.distributed.sharding import batch_sharding as jax_batch_sharding
from repro.distributed.sharding import param_sharding as jax_param_sharding
from repro.models import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import (
    ARCHS,
    SHAPES,
    get_config,
    get_smoke_config,
    input_specs,
    shape_supported,
)

ROOT = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
CHILD_TIMEOUT = 300
SMALL = ((2, 2, 2), ("pod", "data", "model"))
# name -> (arch, kind, seq_len, global batch, mesh shape, mesh axes), smoke configs
CELLS = {
    "olmoe_train": ("olmoe-1b-7b", "train", 32, 8) + SMALL,
    "smollm_prefill": ("smollm-135m", "prefill", 64, 8) + SMALL,
}


@pytest.fixture(autouse=True)
def _no_process_group_here():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group in the pytest process"


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------------------
# the shape helpers
# ---------------------------------------------------------------------------------

def test_archs_and_shapes_match_jax():
    """``ARCHS`` in the JAX order (``--all`` walks the cells alike) and the
    four ``SHAPES`` field for field."""
    assert ARCHS == JAX_ARCHS
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, sp in SHAPES.items():
        assert dataclasses.astuple(sp) == dataclasses.astuple(JAX_SHAPES[name])


@pytest.mark.parametrize("shape", list(JAX_SHAPES))
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_shape_helpers_match_jax(arch, shape):
    """``shape_supported`` gives JAX's verdict and reason; ``input_specs``
    JAX's names, shapes and dtypes, as meta tensors."""
    assert shape_supported(get_config(arch), shape) == jax_shape_supported(
        jax_config(arch), shape)
    port, ref = input_specs(get_config(arch), shape), jax_input_specs(jax_config(arch), shape)
    assert list(port) == list(ref)
    for k, t in port.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(ref[k].dtype), k


# ---------------------------------------------------------------------------------
# small cells under the fake backend
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dry_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    args = {"cells": CELLS, "out": str(tmp / "dryrun.json")}
    path = tmp / "dryrun.args.json"
    path.write_text(json.dumps(args))
    p = subprocess.run([sys.executable, str(RANKS), "dryrun", str(path)], capture_output=True,
                       text=True, env=_env(), timeout=CHILD_TIMEOUT)
    assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-6000:]}"
    return json.loads((tmp / "dryrun.json").read_text())


def test_dryrun_cell_small_mesh(dry_out):
    """The counterpart of ``tests/test_distributed.py``'s miniature cell:
    olmoe smoke's train step on a (2, 2, 2) pod x data x model mesh is
    ``ok``, with its FLOPs, bytes and reductions counted and a peak of live
    bytes at least its arguments.  Every region runs split at model size
    2 (4 heads, 256 words; the 8 experts on their ranks), so the step
    gathers no leaf: its collectives are all all-reduces."""
    r = dry_out["cells"]["olmoe_train"]
    assert r["status"] == "ok", r
    assert r["devices"] == 8 and r["fits"] and r["fits_by"] == "peak_bytes"
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    mem = r["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert r["layout"]["regions"] == {"attention": "split (kv heads split)", "vocab": "split"}
    kinds = r["collectives"]["count_by_kind"]
    assert set(kinds) == {"all-reduce"} and kinds["all-reduce"] > 0, kinds
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert set(r["roofline"]) == {"t_compute_s", "t_memory_s", "t_collective_s", "dominant"}


def _shard_bytes(tree_sh, tree_abs, mesh_sizes) -> int:
    """The bytes of one device's shards under JAX's specs."""
    total = 0
    for sh, leaf in zip(jax.tree.leaves(tree_sh), jax.tree.leaves(tree_abs)):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        for entry in sh.spec:
            for ax in (entry,) if isinstance(entry, str) else (entry or ()):
                n //= mesh_sizes[ax]
        total += n
    return total


def test_argument_bytes_match_jax_shards(dry_out):
    """The train cell's per-rank ``argument_bytes`` equal the bytes of one
    device's shards under JAX's ``param_sharding`` (parameters and AdamW
    state) and ``batch_sharding`` on the same (2, 2, 2) mesh."""
    shape, axes = SMALL
    mesh = JaxAbstractMesh(shape, axes)
    sizes = dict(zip(axes, shape))
    p_abs = jax_build_model(jax_smoke_config("olmoe-1b-7b")).abstract_params()
    o_abs = jax.eval_shape(jax_adamw_init, p_abs)
    specs = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
             "targets": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
    want = (_shard_bytes(jax_param_sharding(p_abs, mesh), p_abs, sizes)
            + _shard_bytes(jax_param_sharding(o_abs, mesh), o_abs, sizes)
            + _shard_bytes(jax_batch_sharding(specs, mesh), specs, sizes))
    assert dry_out["cells"]["olmoe_train"]["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("what", ["moe_layers", "tp_sequence"])
def test_one_forward_all_reduce_per_moe_layer(what, dry_out):
    """An olmoe-smoke prefill on a (2, 4) data x model mesh (batch 8 x 32:
    4 rows, 128 tokens a rank).  ``moe_layers``: each MoE layer dispatches
    exactly one collective, an all-reduce over the model group (4 ranks)
    of the local T x d bf16 activations.  ``tp_sequence``: the whole
    forward's collectives in the tensor-parallel layout, in order: the
    vocabulary-parallel embedding's sum, then per layer the row-parallel
    ``wo``'s sum and the MoE layer's, each a T x d bf16 all-reduce over
    the model group; the logits are the rank's vocabulary block (no
    collective) and the cache holds the rank's kv heads (none)."""
    cfg = get_smoke_config("olmoe-1b-7b")
    T = (8 // 2) * 32
    one = ["all-reduce", T * cfg.d_model * cfg.dtype.itemsize, 4]
    events = dry_out["prefill_events"]
    if what == "moe_layers":
        assert events[2::2] == [one] * cfg.n_layers
    else:
        assert events == [one] + [one, one] * cfg.n_layers


def test_collective_stats_counts_each_kind(dry_out):
    """A scripted sequence through ``collective_stats``: each collective
    under JAX's kind, with the exact bytes of its result on this rank
    (a send writes nothing here; a recv is the permute's result)."""
    ev = dry_out["scripted"]["events"]
    assert ev == [["all-reduce", 60, 4], ["all-gather", 96, 4], ["reduce-scatter", 12, 4],
                  ["all-to-all", 128, 4], ["collective-permute", 28, 4],
                  ["all-reduce", 16, 4], ["all-gather", 128, 4]]
    st = dry_out["scripted"]["stats"]
    assert st["total_bytes"] == 468
    assert st["count_by_kind"] == {"all-reduce": 2, "all-gather": 2, "reduce-scatter": 1,
                                   "all-to-all": 1, "collective-permute": 1}
    assert st["bytes_by_kind"]["all-gather"] == 224


def test_dense_prefill_flops_match_analytic(dry_out):
    """smollm smoke's prefill cell (64 tokens, 2 rows a rank, model size
    2): ``flops`` equals, exactly (tolerance 0), the rank's analytic count
    of its products under the tensor-parallel layout: per layer the whole
    attention (3 heads divide no model axis of 2: the Q, K, V and O
    projections and the two attention products over the full S x S square,
    which the plain route masks, it does not skip), the gated MLP's three
    matmuls on the rank's half of ``d_ff``, and the lm-head at the last
    position on the rank's half of the vocabulary.  Its collectives, also
    exactly: the embedding's and each layer's MLP sum (T x d bf16
    all-reduces over the model group) and each layer's gathered Q, K, V
    and O weights (bf16 all-gathers, the whole weights' bytes)."""
    r = dry_out["cells"]["smollm_prefill"]
    assert r["status"] == "ok", r
    cfg = get_smoke_config("smollm-135m")
    B, S, mp = 8 // 4, 64, 2
    T, d, hd = B * S, cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    assert r["layout"]["regions"] == {"attention": "whole", "mlp": "split", "vocab": "split"}
    per_layer = (2 * T * d * (Hq + 2 * Hkv) * hd + 2 * T * Hq * hd * d
                 + 3 * 2 * T * d * cfg.d_ff // mp + 2 * 2 * B * Hq * S * S * hd)
    want = cfg.n_layers * per_layer + 2 * B * d * cfg.vocab // mp
    assert r["cost"]["flops"] == want
    act = T * d * 2
    weights = 2 * (d * (Hq + 2 * Hkv) * hd + Hq * hd * d)
    c = r["collectives"]
    assert c["bytes_by_kind"] == {"all-reduce": act * (1 + cfg.n_layers),
                                  "all-gather": weights * cfg.n_layers}
    assert c["count_by_kind"] == {"all-reduce": 1 + cfg.n_layers, "all-gather": 4 * cfg.n_layers}


# ---------------------------------------------------------------------------------
# the CLI at full width, with its resume
# ---------------------------------------------------------------------------------

def _cli(out: Path, *extra) -> str:
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(out),
                        *extra], capture_output=True, text=True, env=_env(),
                       timeout=CHILD_TIMEOUT, cwd=ROOT)
    assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-6000:]}"
    return p.stdout


def test_cli_full_config_cell_and_resume(tmp_path):
    """mamba2-1.3b ``CONFIG`` at ``long_500k`` on the 16x16 production mesh
    (256 fake ranks) through the CLI: one ``ok`` record; a second run skips
    the done cell and appends nothing."""
    out = tmp_path / "dry.jsonl"
    args = ("--arch", "mamba2-1.3b", "--shape", "long_500k", "--mesh", "single")
    _cli(out, *args)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["mesh"], r["status"], r["devices"]) for r in recs] == [
        ("mamba2-1.3b", "single", "ok", 256)]
    r = recs[0]
    assert r["fits"] and r["memory"]["argument_bytes"] > 0 and r["cost"]["flops"] > 0
    again = _cli(out, *args)
    assert again.count("[skip-done]") == 1 and "[cell]" not in again
    assert len(out.read_text().splitlines()) == 1


# the gathered layout's per-rank peak for qwen2.5-3b train_4k on the 16x16 mesh,
# as the dry run measured it before the tensor-parallel layout (PERF.md, §6)
GATHERED_QWEN_TRAIN_PEAK = 139.12e9


def test_qwen_train_cell_peak_below_gathered_layout(tmp_path):
    """qwen2.5-3b ``CONFIG`` at ``train_4k`` on the 16x16 production mesh
    through the CLI: ``ok``, attention split with its 2 kv heads gathered,
    the MLP and the vocabulary split, and a per-rank peak below the
    gathered layout's 139.12 GB, within one H100's 80 GB."""
    out = tmp_path / "qwen.jsonl"
    _cli(out, "--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh", "single")
    (r,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert r["status"] == "ok", r
    assert r["layout"]["regions"] == {"attention": "split (kv gathered)", "mlp": "split",
                                      "vocab": "split"}
    peak = r["memory"]["peak_bytes"]
    print("qwen2.5-3b train_4k 16x16 peak", peak)
    assert peak < GATHERED_QWEN_TRAIN_PEAK and r["fits"]


def test_full_attention_500k_cell_is_skipped_as_in_jax(dry_out):
    """A full-attention arch's 500k cell is skipped with JAX's reason,
    before any process group starts."""
    r = dry_out["skipped"]
    assert r["status"] == "skipped" and r["wall_s"] == 0.0
    assert r["reason"] == jax_shape_supported(jax_config("qwen2.5-3b"), "long_500k")[1]
