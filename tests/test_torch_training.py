"""PyTorch port, training: ``Model.loss_fn`` and its gradients, AdamW, the
train step (microbatched too), remat, the ``TokenStream`` and the analytic
parameter counts, against the JAX package on the CPU at float32.

Inputs are made with numpy from a seed; weights are drawn by the JAX
package and carried across through its ``save_checkpoint`` and the port's
``load_checkpoint``.  Tolerances: the loss within 1e-5 relative; every
gradient leaf within 1e-5 + 1e-4 * |ref| of the JAX one, measured against
the leaf's own scale (``_grad_close``); AdamW on identical inputs within
1e-6 relative (float32 rounding of the same arithmetic in two orders);
loss curves over 5 steps within 1e-4 relative (AdamW's first steps move a
parameter by about ±lr whatever its gradient's size, so parameters after a
step are compared by the loss they give, not leaf by leaf)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenStream as JaxTokenStream
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro.optim.adamw import global_norm as jax_global_norm
from repro.training import make_train_step as jax_make_train_step
from repro_torch.checkpoint import load_checkpoint
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.optim.adamw import global_norm
from repro_torch.training import make_train_step, train_state_shardings
from repro_torch.training.train_step import loss_and_grads

from _torch_helpers import flatten_jax

B, S = 2, 16


def _pair(arch, tmp_path, *, seed=0, **over):
    """(jax model, jax params, torch model, torch params) at float32, the
    port's weights read from the JAX package's checkpoint."""
    jc = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32, **over)
    tc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32, **over)
    jm = jax_build_model(jc)
    jp = jm.init_params(jax.random.key(seed))
    path = jax_save_checkpoint(str(tmp_path / f"w{seed}.npz"), jp)
    tm = build_model(tc, device="cpu")
    tp, _ = load_checkpoint(path, tm.abstract_params(), device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, *, seed=1, b=B, s=S):
    """numpy inputs for ``cfg``'s family; targets < 0 at the end of row 0
    exercise the loss's mask."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    targets = tokens.copy()
    targets[0, -3:] = -1
    if cfg.family == "audio":
        enc = rng.normal(size=(b, cfg.enc_len, cfg.d_model)).astype(np.float32)
        return {"enc_embeds": enc, "tokens": tokens, "targets": targets}
    if cfg.input_mode == "embeddings":
        emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "targets": targets}
    return {"tokens": tokens, "targets": targets}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_close(got: dict, ref: dict):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key].detach().float().numpy()
        r = np.asarray(r, np.float32)
        assert g.shape == r.shape, key
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(g / scale, r / scale, atol=1e-5, rtol=1e-4, err_msg=key)


def _jax_grads(jm, jp, batch):
    (loss, _), g = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), flatten_jax(g)


# ---------------------------------------------------------------------------------
# loss and gradients, every architecture
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, tmp_path):
    jm, jp, tm, tp = _pair(arch, tmp_path)
    batch = _batch(tm.cfg)
    ref_loss, ref_g = _jax_grads(jm, jp, batch)
    loss, metrics, g = loss_and_grads(tm.loss_fn, tp, _torch_batch(batch))
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    assert float(metrics["ce"]) <= float(loss) + 1e-6
    flat = _flatten(g)
    _grad_close(flat, ref_g)
    # the step sets requires_grad on aliases only
    assert not any(t.requires_grad for t in _flatten(tp).values())
    if tm.cfg.moe:
        # the router's gradient comes through the sorted gate values, their
        # renormalisation and the aux loss's softmax; every expert that got a
        # token has a gradient, the same experts as in JAX
        assert float(flat["blocks/moe/router"].abs().max()) > 0
        used = flat["blocks/moe/w_gate"].abs().amax(dim=(2, 3)) > 0      # (L, E)
        assert used.any(dim=1).all()
        np.testing.assert_array_equal(
            used.numpy(), np.abs(ref_g["blocks/moe/w_gate"]).max(axis=(2, 3)) > 0)


def test_loss_masks_negative_targets(tmp_path):
    """Targets < 0 drop out of the mean: a batch whose masked positions
    hold other tokens gives the same loss."""
    *_, tm, tp = _pair("smollm-135m", tmp_path)
    batch = _torch_batch(_batch(tm.cfg))
    other = dict(batch, targets=batch["targets"].clone())
    other["targets"][0, -3:] = -7
    assert torch.equal(tm.loss_fn(tp, batch)[0], tm.loss_fn(tp, other)[0])


def test_ssd_decay_gradient_is_finite_where_exp_overflows():
    """Above a chunk's diagonal exp(acs_t - acs_u) overflows once the decay
    over the chunk passes ~88 (mamba2-1.3b's 256-token chunks pass it at
    init): JAX's ``where(tri, exp(diff), 0)`` then has NaN gradients
    (0 * inf), and so would a step of the JAX package's mamba2-1.3b.  The
    port's ``_decay`` selects the exponent too: the same values, and a
    gradient that float64 finite differences confirm, overflow included."""
    from repro.kernels.ssd.ref import ssd_intra_ref
    from repro_torch.kernels.ssd.ops import _decay, ssd_intra_plain
    rng = np.random.default_rng(7)
    steps = rng.uniform(300.0, 500.0, size=(1, 1, 6, 2))
    acs64 = torch.from_numpy(-np.cumsum(steps, axis=2)).requires_grad_(True)
    assert torch.autograd.gradcheck(_decay, (acs64,))
    q, h, p, n = 8, 2, 4, 3
    xb = rng.normal(size=(1, 1, q, h, p)).astype(np.float32)
    acs = (-np.cumsum(rng.uniform(20.0, 40.0, size=(1, 1, q, h)), axis=2)).astype(np.float32)
    Bh = rng.normal(size=(1, 1, q, h, n)).astype(np.float32)
    Ch = rng.normal(size=(1, 1, q, h, n)).astype(np.float32)
    jref = lambda a: jnp.sum(ssd_intra_ref(jnp.asarray(xb[0]), a, jnp.asarray(Bh[0]),
                                           jnp.asarray(Ch[0])))
    assert np.isnan(np.asarray(jax.grad(jref)(jnp.asarray(acs[0])))).any()
    a_t = torch.from_numpy(acs).requires_grad_(True)
    y = ssd_intra_plain(torch.from_numpy(xb), a_t, torch.from_numpy(Bh), torch.from_numpy(Ch))
    np.testing.assert_allclose(y.detach().numpy()[0], np.asarray(
        ssd_intra_ref(jnp.asarray(xb[0]), jnp.asarray(acs[0]), jnp.asarray(Bh[0]),
                      jnp.asarray(Ch[0]))), rtol=1e-6, atol=1e-7)
    t = torch.from_numpy(acs)
    diff = t[:, :, :, None, :] - t[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool).tril()[None, None, :, :, None]
    assert torch.equal(_decay(t), torch.where(tri, torch.exp(diff), 0.0))
    y.sum().backward()
    assert torch.isfinite(a_t.grad).all()


# ---------------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------------

def _tree(rng, dtype):
    shapes = {"a": (5, 7), "b": (13,), "c": {"w": (3, 4), "u": (2, 3, 4)}}
    p = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), p)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jtree = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(jd), t)
    ttree = lambda t: jax.tree.map(lambda a: torch.from_numpy(a).to(td), t)
    return jtree(p), jtree(g), ttree(p), ttree(g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("donate", [False, True])
def test_adamw_update_matches_jax(dtype, donate):
    """Three updates on identical parameters and gradients (each package
    fed its own state), clipped: the new parameters, m, v, step, lr and
    grad_norm.  bf16 parameters round the same f32 update, so they may
    differ by one bf16 step where the f32 values straddle a rounding
    boundary."""
    cfg = AdamWConfig(lr=0.05, grad_clip=0.5, warmup_steps=2, total_steps=6)
    jcfg = JaxAdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    jp, jg, tp, tg = _tree(rng, dtype)
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        jp, js, jm = jax_adamw_update(jp, jg, js, jcfg)
        tp, ts, tm = adamw_update(tp, tg, ts, cfg, donate=donate)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"])
        for name, t, j in (("m", ts["m"], js["m"]), ("v", ts["v"], js["v"])):
            for key, ref in flatten_jax(j).items():
                got = _flatten(t)[key]
                assert got.dtype == torch.float32, (name, key)
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-9,
                                           err_msg=f"{name}/{key}")
        for key, ref in flatten_jax(jp).items():
            got = _flatten(tp)[key]
            assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
            tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=8e-3, atol=1e-6)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                       err_msg=key, **tol)


def test_adamw_update_leaves_inputs_without_donate():
    rng = np.random.default_rng(1)
    _, _, tp, tg = _tree(rng, "float32")
    before = {k: t.clone() for k, t in _flatten(tp).items()}
    state = adamw_init(tp)
    new, new_state, _ = adamw_update(tp, tg, state, AdamWConfig())
    assert all(torch.equal(before[k], t) for k, t in _flatten(tp).items())
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert not torch.equal(_flatten(new)["a"], before["a"])


@pytest.mark.parametrize("warmup,total", [(0, 10), (10, 100), (5, 5), (100, 10_000)])
def test_cosine_lr_matches_jax(warmup, total):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    jcfg = JaxAdamWConfig(**dataclasses.asdict(cfg))
    for s in sorted({0, 1, warmup, warmup + 1, total // 2, total, total + 3}):
        got = cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(jax_cosine_lr(jcfg, jnp.int32(s))),
                                           rel=1e-6, abs=1e-12)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    jp, _, tp, _ = _tree(rng, "bfloat16")
    assert float(global_norm(tp)) == pytest.approx(float(jax_global_norm(jp)), rel=1e-6)


# ---------------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_microbatched_step_matches_jax(arch, tmp_path):
    """microbatches=2 over a batch of 4: the loss, the grad norm and the
    loss the new parameters give, against JAX's microbatched step."""
    jm, jp, tm, tp = _pair(arch, tmp_path)
    batch = _batch(tm.cfg, b=4)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**dataclasses.asdict(cfg)),
                                        microbatches=2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp2, _, jmet = jstep(jp, jax_adamw_init(jp), jb)
    tstep = make_train_step(tm, cfg, microbatches=2)
    tp2, _, tmet = tstep(tp, adamw_init(tp), batch)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    ref_after = float(jax.jit(jm.loss_fn)(jp2, jb)[0])
    assert float(tm.loss_fn(tp2, _torch_batch(batch))[0]) == pytest.approx(ref_after, rel=1e-4)


def test_step_returns_parameters_without_grad(tmp_path):
    *_, tm, tp = _pair("smollm-135m", tmp_path)
    p2, o2, met = make_train_step(tm, AdamWConfig())(tp, adamw_init(tp), _batch(tm.cfg))
    assert not any(t.requires_grad for t in _flatten(p2).values())
    assert all(t.dtype == torch.float32 for t in _flatten(o2["m"]).values())
    assert not met["loss"].requires_grad


def test_sharded_training_waits_for_the_port_sharding(tmp_path):
    *_, tm, _ = _pair("smollm-135m", tmp_path)
    with pytest.raises(NotImplementedError, match="item 8"):
        make_train_step(tm, AdamWConfig(), compress_pod_grads=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        train_state_shardings(tm, None, None)


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b", "mamba2-1.3b",
                                  "zamba2-2.7b", "whisper-small"])
def test_remat_policies_give_equal_grads(arch, tmp_path):
    """``remat`` "none", "block" and "dots" recompute the same arithmetic:
    the loss and every gradient leaf are equal."""
    out = {}
    for remat in ("none", "block", "dots"):
        *_, tm, tp = _pair(arch, tmp_path, remat=remat)
        loss, _, g = loss_and_grads(tm.loss_fn, tp, _torch_batch(_batch(tm.cfg)))
        out[remat] = (loss, _flatten(g))
    loss0, g0 = out["none"]
    for remat in ("block", "dots"):
        loss, g = out[remat]
        assert torch.equal(loss, loss0), remat
        for key, t in g0.items():
            torch.testing.assert_close(g[key], t, rtol=1e-6, atol=1e-9,
                                       msg=lambda m, k=key: f"{remat} {k}: {m}")


def _stream_batches(cfg, n, *, b=4, s=32):
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=3))
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        batch = data.batch(i)
        if cfg.family == "audio":
            batch["enc_embeds"] = rng.normal(size=(b, cfg.enc_len, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b", "whisper-small"])
def test_loss_curve_matches_jax(arch, tmp_path):
    """Five steps on the TokenStream: each step's loss within 1e-4 of the
    JAX package's (the dense, ssm and audio families)."""
    jm, jp, tm, tp = _pair(arch, tmp_path)
    cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**dataclasses.asdict(cfg))))
    tstep = make_train_step(tm, cfg, donate=True)
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    jl, tl = [], []
    for batch in _stream_batches(tm.cfg, 5):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------------
# data, parameter counts, abstract parameters
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_token_stream_matches_jax_bit_for_bit(n_hosts, host_id):
    kw = dict(vocab=977, seq_len=130, global_batch=8, seed=5, n_hosts=n_hosts,
              host_id=host_id)
    ours, ref = TokenStream(DataConfig(**kw)), JaxTokenStream(JaxDataConfig(**kw))
    for i in (0, 1, 17):
        a, b = ours.batch(i), ref.batch(i)
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == (8 // n_hosts, 130)
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    ours, ref = get_config(arch), jax_config(arch)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax_eval_shape(arch):
    """Full configs: the port's meta tree has JAX's keys, shapes and dtypes
    (the MoE router and the Mamba-2 vectors float32 at bf16), and draws
    nothing."""
    ours = _flatten(build_model(get_config(arch), device="cpu").abstract_params())
    ref = {"/".join(str(p.key) for p in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(
               jax_build_model(jax_config(arch)).abstract_params())[0]}
    assert set(ours) == set(ref)
    for key, a in ref.items():
        t = ours[key]
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(a.shape), key
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, key
