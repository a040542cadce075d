"""The port's expert-parallel MoE (``repro_torch.distributed.moe_ep``)
against the JAX package's.

The JAX EP bodies run here without ``shard_map``: each goes under
``jax.vmap(..., axis_name="model")`` with the per-rank parameter blocks
stacked on the mapped axis, where ``axis_index`` is the rank and ``psum``
the sum over ranks.  The port's bodies return each rank's partial output;
their sum over ranks is held against that ``psum`` and against JAX's
``moe_ffn``.  The sharded step with the expert-parallel layout runs on 8
gloo ranks in one child process (``tests/_torch_dist_ranks.py``): no
process group is ever started in the pytest process.  Inputs are f32 and
seeded with numpy.
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
import torch
import torch.distributed as dist

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed import moe_ep as jax_moe_ep
from repro.models import build_model as jax_build_model
from repro.models.common import MoEConfig as JaxMoEConfig
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import AbstractMesh, moe_ep
from repro_torch.models import build_model, moe
from repro_torch.models.common import MoEConfig

ROOT = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
CHILD_TIMEOUT = 300
BODY_TOL = 2e-6          # the bodies' summed partials, over the largest |output|
AUX_TOL = 1e-6
# the sharded steps, over each leaf's largest magnitude: both run the
# tensor-parallel layout, whose row-parallel sums and vocabulary-parallel
# loss reorder f32 sums (sound: gradients up to 1.49e-6, parameters 6.8e-7;
# a router or an attention input whose gradient is not summed over `model`:
# gradients 0.16 to 0.93, parameters 5.6e-5 to 2.6e-4)
STEP_TOL = 2e-6
V_TOL = 2 * STEP_TOL     # the second moments: a squared gradient, twice its error


@pytest.fixture(autouse=True)
def _no_process_group_here():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group in the pytest process"


# ---------------------------------------------------------------------------------
# the bodies against JAX's under vmap
# ---------------------------------------------------------------------------------

def _layer(arch: str, T: int, seed: int, capacity_factor=None):
    """(jax MoEConfig, port MoEConfig, x (T, D), whole layer params), numpy."""
    jc, tc = jax_smoke_config(arch).moe, get_smoke_config(arch).moe
    if capacity_factor is not None:
        jc = JaxMoEConfig(jc.n_experts, jc.top_k, jc.d_expert, capacity_factor)
        tc = MoEConfig(tc.n_experts, tc.top_k, tc.d_expert, capacity_factor)
    D, E, Fh = get_smoke_config(arch).d_model, tc.n_experts, tc.d_expert
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    params = {"router": f(D, E), "w_gate": f(E, D, Fh), "w_up": f(E, D, Fh),
              "w_down": f(E, Fh, D)}
    return jc, tc, f(T, D), params


def _blocks(params, r: int, mp: int, ep: bool) -> dict:
    """Rank r's blocks: the expert dim cut (EP) or the hidden dim (TP)."""
    E, _, Fh = params["w_gate"].shape
    if ep:
        n = E // mp
        cut = {k: params[k][r * n:(r + 1) * n] for k in ("w_gate", "w_up", "w_down")}
    else:
        n = Fh // mp
        cut = {"w_gate": params["w_gate"][:, :, r * n:(r + 1) * n],
               "w_up": params["w_up"][:, :, r * n:(r + 1) * n],
               "w_down": params["w_down"][:, r * n:(r + 1) * n]}
    return {"router": params["router"], **{k: np.ascontiguousarray(v) for k, v in cut.items()}}


def _dropped(experts: torch.Tensor, C: int, E: int) -> int:
    return int((~moe.dispatch(experts, C, E)[3]).sum())


@pytest.mark.parametrize("arch,mp,capacity_factor", [
    ("olmoe-1b-7b", 2, None), ("olmoe-1b-7b", 4, None), ("olmoe-1b-7b", 8, None),
    ("mixtral-8x22b", 8, None), ("olmoe-1b-7b", 4, 0.5)])
def test_bodies_match_jax_under_vmap(arch, mp, capacity_factor):
    """The port's EP body (olmoe smoke, 8 experts: 4, 2, 1 a rank) or TP
    body (mixtral smoke, 4 experts at mp 8: hidden dim 8 a rank), its
    partials summed over the ranks, within 2e-6 of the largest |output| of
    JAX's body under vmap (every mapped index holds the same psum) and of
    JAX's ``moe_ffn``; every rank's aux within 1e-6 of JAX's.  At capacity
    factor 0.5 pairs are dropped, the same on every rank and in the
    one-device layer."""
    jc, tc, x, params = _layer(arch, T=96, seed=mp, capacity_factor=capacity_factor)
    ep = tc.n_experts % mp == 0
    assert ep == (arch == "olmoe-1b-7b")
    stacked = {k: jnp.stack([jnp.asarray(_blocks(params, r, mp, ep)[k]) for r in range(mp)])
               for k in params}
    if ep:
        body = lambda p: jax_moe_ep._local_moe(jnp.asarray(x), p, jc, "model", mp)
    else:
        body = lambda p: jax_moe_ep._local_moe_tp(jnp.asarray(x), p, jc, "model")
    j_out, j_aux = jax.vmap(body, axis_name="model")(stacked)
    j_out, j_aux = np.asarray(j_out), np.asarray(j_aux)
    assert all(np.array_equal(j_out[r], j_out[0]) for r in range(mp))
    ref, ref_aux = jax_moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jc)
    ref = np.asarray(ref)

    port_body = moe_ep._local_moe if ep else moe_ep._local_moe_tp
    xt = torch.from_numpy(x)
    parts = [port_body(xt, {k: torch.from_numpy(v) for k, v in _blocks(params, r, mp, ep).items()},
                       tc, r, mp) for r in range(mp)]
    total = parts[0][0]
    for out, _ in parts[1:]:
        total = total + out
    total = total.numpy()
    scale = float(np.abs(ref).max())
    assert float(np.abs(total - j_out[0]).max()) <= BODY_TOL * scale
    assert float(np.abs(total - ref).max()) <= BODY_TOL * scale
    for _, aux in parts:
        assert abs(float(aux) - float(j_aux[0])) <= AUX_TOL
        assert abs(float(aux) - float(ref_aux)) <= AUX_TOL
    # drops: the plan is the whole layer's on every rank
    _, experts, _ = moe.router_topk(xt, torch.from_numpy(params["router"]), tc)
    C = moe.capacity(x.shape[0], tc)
    n_drop = _dropped(experts, C, tc.n_experts)
    assert (n_drop > 0) == (capacity_factor is not None), n_drop
    one, _ = moe.moe_ffn(xt, {k: torch.from_numpy(v) for k, v in params.items()}, tc)
    assert float((torch.from_numpy(total) - one).abs().max()) <= BODY_TOL * scale


def test_one_model_rank_is_moe_ffn_bit_for_bit():
    """At one model rank ``moe_ffn_ep`` issues no collective and is the
    one-device layer bit for bit (the card's one-rank step relies on it)."""
    _, tc, x, params = _layer("olmoe-1b-7b", T=48, seed=3)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    out, aux = moe_ep.moe_ffn_ep(xt.reshape(2, 24, -1), p, tc,
                                 AbstractMesh((1, 1), ("data", "model")))
    ref, ref_aux = moe.moe_ffn(xt, p, tc)
    assert torch.equal(out.reshape(48, -1), ref) and torch.equal(aux, ref_aux)


def test_blocks_of_the_wrong_shape_are_refused():
    """Whole experts under a model axis of 2 would count every expert
    twice in the sum: the layer refuses them, naming the blocks it takes."""
    _, tc, x, params = _layer("olmoe-1b-7b", T=8, seed=0)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="rank's block of w_gate"):
        moe_ep.moe_ffn_ep(torch.from_numpy(x)[None], p, tc,
                          AbstractMesh((1, 2), ("data", "model")))


class _Taken(Exception):
    pass


@pytest.mark.parametrize("mesh,env,expect_ep", [
    (None, None, False), ("model", "0", False), ("model", None, True), ("model", "1", True),
    ("data", None, False)])
def test_ffn_takes_the_jax_branch(monkeypatch, mesh, env, expect_ep):
    """``lm._ffn`` takes ``moe_ffn_ep`` exactly where the JAX ``_ffn`` does:
    a mesh set with a ``model`` axis and ``REPRO_MOE_EP`` unset or ``1``;
    ``set_ep_mesh(None)``, ``REPRO_MOE_EP=0`` or a mesh without ``model``
    take the plain branch, whose output is the unset forward's."""
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)))
    plain, _ = model.forward(params, {"tokens": toks})

    def spy(*a, **kw):
        raise _Taken

    monkeypatch.setattr(moe_ep, "moe_ffn_ep", spy)
    if env is None:
        monkeypatch.delenv("REPRO_MOE_EP", raising=False)
    else:
        monkeypatch.setenv("REPRO_MOE_EP", env)
    names = {"model": ("data", "model"), "data": ("data", "pod")}
    moe_ep.set_ep_mesh(None if mesh is None else AbstractMesh((1, 2), names[mesh]))
    try:
        if expect_ep:
            with pytest.raises(_Taken):
                model.forward(params, {"tokens": toks})
        else:
            out, _ = model.forward(params, {"tokens": toks})
            assert torch.equal(out, plain)
    finally:
        moe_ep.set_ep_mesh(None)
    assert moe_ep.get_ep_mesh() is None


# ---------------------------------------------------------------------------------
# the expert-parallel sharded step on 8 gloo ranks
# ---------------------------------------------------------------------------------

CASES = [("olmoe-1b-7b", [2, 4]), ("mixtral-8x22b", [1, 8])]


@pytest.fixture(scope="module")
def ep_out(tmp_path_factory):
    """f32 smoke parameters from JAX's ``init_params(key(0))`` through a
    checkpoint, (8, 32) tokens from numpy; one child of 8 gloo ranks."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    ckpt, tokens = {}, {}
    for arch, _ in CASES:
        cfg = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32)
        params = jax_build_model(cfg).init_params(jax.random.key(0))
        ckpt[arch] = jax_save_checkpoint(str(tmp / f"{arch}.npz"), params)
        tokens[arch] = str(tmp / f"{arch}-tokens.npy")
        np.save(tokens[arch], np.random.default_rng(11).integers(
            0, cfg.vocab, (8, 32)).astype(np.int32))
    args = {"world": 8, "cases": CASES, "ckpt": ckpt, "tokens": tokens,
            "out": str(tmp / "moe_ep.json"), "store": str(tmp / "moe_ep.store"),
            "tmp": str(tmp)}
    path = tmp / "moe_ep.args.json"
    path.write_text(json.dumps(args))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("REPRO_MOE_EP", None)
    p = subprocess.run([sys.executable, str(RANKS), "moe_ep", str(path)], capture_output=True,
                       text=True, env=env, timeout=CHILD_TIMEOUT)
    assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-6000:]}"
    return json.loads((tmp / "moe_ep.json").read_text())


def _key(arch, mesh):
    return f"{arch}/{'x'.join(map(str, mesh))}"


@pytest.mark.parametrize("arch,mesh", CASES)
def test_ep_step_losses_and_no_drops(arch, mesh, ep_out):
    """Losses of the EP and plain sharded steps (and their metrics) within
    2e-6 relative of the one-device reference; the EP step takes
    ``moe_ffn_ep`` in every MoE layer and the plain one never; no pair
    dropped in any compared run, so per-shard and whole-batch routing
    agree; the gradients and outputs keep their placements."""
    r = ep_out[_key(arch, mesh)]
    print(arch, mesh, r["loss"], r["drops"], r["dispatches"])
    one = r["loss"]["one"]
    for mode in ("plain", "ep"):
        for v in r["loss"][mode]:
            assert v == pytest.approx(one, rel=STEP_TOL), r["loss"]
    assert r["drops"] == {"plain": 0, "ep": 0, "one": 0}, r["drops"]
    assert min(r["dispatches"].values()) > 0, r["dispatches"]
    # the EP run took moe_ffn_ep in every MoE layer of both forwards, the plain none
    assert r["ep_calls"] == {"plain": 0, "ep": r["dispatches"]["ep"]}, r["ep_calls"]
    assert r["placed"] == {"plain": True, "ep": True}


@pytest.mark.parametrize("what", ["grads", "params", "v"])
@pytest.mark.parametrize("against", ["one", "plain"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_ep_step_matches(arch, mesh, against, what, ep_out):
    """The EP step's gradients (the embeddings, the router and each expert
    leaf among them) and parameters after one step within 2e-6, and its
    second moments within 4e-6, leaf by leaf, of each leaf's largest
    magnitude of the one-device reference and of the plain sharded step on
    the same mesh."""
    errs = ep_out[_key(arch, mesh)][f"{what}_vs_{against}"]
    worst = max(errs, key=errs.get)
    print(arch, mesh, against, what, worst, errs[worst])
    assert any(k.endswith("moe/router") for k in errs) and any(
        k.endswith("moe/w_down") for k in errs) and "embed" in errs
    assert errs[worst] <= (V_TOL if what == "v" else STEP_TOL), (worst, errs[worst])
