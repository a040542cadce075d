"""PyTorch port, ``models/moe.py``: ``router_topk``, ``load_balance_loss``
and ``moe_ffn`` against the JAX package on the same numpy inputs, at float32
(outputs within 1e-5) and bf16 (within 2e-2 + 1e-2 * |ref|: about two bf16
steps at the outputs' magnitude, from the expert products' rounding); and
the MoE router carried through checkpoints both ways at bf16, bit for bit
and in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models.common import MoEConfig as JaxMoEConfig
from repro_torch.checkpoint import F32_LEAVES, load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, moe
from repro_torch.models.common import MoEConfig

from _torch_helpers import flatten_jax

F32_TOL = dict(atol=1e-5, rtol=0)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)

# (T, D, E, k, F, capacity factor, least dropped pairs)
CASES = [(1, 32, 8, 2, 16, 1.25, 0),        # the capacity floor: C = min(4, T k)
         (2, 32, 8, 2, 16, 1.25, 0),
         (48, 32, 8, 2, 16, 1.0, 1),
         (48, 32, 8, 2, 16, 1.25, 1),
         (48, 32, 64, 8, 16, 1.25, 1)]      # olmoe's E and k at d 32


def _inputs(T, D, E, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    p = {"router": rng.normal(size=(D, E)) * D ** -0.5,
         "w_gate": rng.normal(size=(E, D, F)) * D ** -0.5,
         "w_up": rng.normal(size=(E, D, F)) * D ** -0.5,
         "w_down": rng.normal(size=(E, F, D)) * F ** -0.5}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _both(x, p, dtype):
    """(jax x, jax params, torch x, torch params); the router stays f32."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jd) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else td)
          for k, v in p.items()}
    return jnp.asarray(x).astype(jd), jp, torch.from_numpy(x).to(td), tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,E,k,F,cf,least_drops", CASES)
def test_moe_ffn_matches_jax(T, D, E, k, F, cf, least_drops, dtype):
    x, p = _inputs(T, D, E, F, seed=T + E)
    jx, jp, tx, tp = _both(x, p, dtype)
    jcfg, tcfg = JaxMoEConfig(E, k, F, cf), MoEConfig(E, k, F, cf)
    jw, je, jl = jmoe.router_topk(jx, jp["router"], jcfg)
    tw, te, tl = moe.router_topk(tx, tp["router"], tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(float(moe.load_balance_loss(tl, te, E)),
                               float(jmoe.load_balance_loss(jl, je, E)), atol=1e-5)
    C = moe.capacity(T, tcfg)
    assert C == max(int(T * k * cf / E), min(4, T * k))
    dropped = int((~moe.dispatch(te, C, E)[3]).sum())
    assert dropped >= least_drops and (least_drops or dropped == 0)
    jo, jaux = jmoe.moe_ffn(jx, jp, jcfg)
    to, taux = moe.moe_ffn(tx, tp, tcfg)
    assert to.dtype == tx.dtype and to.shape == (T, D)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)


def test_router_ties_pick_the_lower_expert_first():
    """Equal router probabilities: jax.lax.top_k's order (lower index
    first), so the same pairs are kept and dropped."""
    x, p = _inputs(12, 16, 8, 8, seed=3)
    p["router"][:, 5] = p["router"][:, 2]          # experts 2 and 5 tie on every token
    p["router"][:, 7] = p["router"][:, 0]
    jx, jp, tx, tp = _both(x, p, "float32")
    cfg = (JaxMoEConfig(8, 4, 8, 1.0), MoEConfig(8, 4, 8, 1.0))
    _, je, _ = jmoe.router_topk(jx, jp["router"], cfg[0])
    _, te, _ = moe.router_topk(tx, tp["router"], cfg[1])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(moe.moe_ffn(tx, tp, cfg[1])[0].numpy(),
                               np.asarray(jmoe.moe_ffn(jx, jp, cfg[0])[0]), **F32_TOL)


def test_combine_is_the_same_bits_run_to_run():
    """The combine adds a token's k terms in a fixed order: two calls give
    the same bits (at float32, where a reordered sum would show)."""
    x, p = _inputs(48, 32, 64, 16, seed=4)
    _, _, tx, tp = _both(x, p, "float32")
    cfg = MoEConfig(64, 8, 16, 1.25)
    assert torch.equal(moe.moe_ffn(tx, tp, cfg)[0], moe.moe_ffn(tx, tp, cfg)[0])


# ---------------------------------------------------------------------------------
# the router through checkpoints
# ---------------------------------------------------------------------------------

def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_router_stays_float32_through_bf16_checkpoints(tmp_path):
    """olmoe-smoke at bf16: JAX save_checkpoint -> the port's load_checkpoint
    (dtype=bfloat16) -> the port's save_checkpoint -> JAX load_checkpoint.
    Every leaf bit-equal to the JAX tree, every router float32 on the way."""
    assert "router" in F32_LEAVES
    jc = jax_smoke_config("olmoe-1b-7b")
    jm = jax_build_model(jc)
    jp = jm.init_params(jax.random.key(7))
    ref = flatten_jax(jp)
    assert ref["blocks/moe/router"].dtype == np.float32
    path = jax_save_checkpoint(str(tmp_path / "jax.npz"), jp, step=1)
    params, _ = load_checkpoint(path, device="cpu", dtype=torch.bfloat16)
    for layer in params["blocks"]:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w_up"].dtype == torch.bfloat16
    back = save_checkpoint(str(tmp_path / "port.npz"), params, step=2)
    jtree, meta = jax_load_checkpoint(back, jm.abstract_params())
    assert meta == {"step": 2}
    out = flatten_jax(jtree)
    assert sorted(out) == sorted(ref)
    for key, a in ref.items():
        assert out[key].dtype == a.dtype, key
        np.testing.assert_array_equal(_bits(out[key]), _bits(a), err_msg=key)


def test_bf16_router_cast_would_change_the_routing():
    """Why the router stays float32: the same weights with a bf16-cast
    router route some tokens to other experts at olmoe-smoke's widths."""
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype=torch.float32)
    tp = build_model(cfg, device="cpu").init_params(0)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(256, cfg.d_model))
                         .astype(np.float32))
    w = tp["blocks"][0]["moe"]["router"]
    _, e32, _ = moe.router_topk(x, w, cfg.moe)
    _, e16, _ = moe.router_topk(x, w.bfloat16(), cfg.moe)
    assert not torch.equal(e32, e16)
