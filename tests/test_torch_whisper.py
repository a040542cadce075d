"""PyTorch port, ``models/whisper.py`` and the train state across the two
packages, at float32 on the CPU.

Whisper: ``forward``, ``prefill`` then ``decode_step`` against the JAX
package on the same numpy inputs (logits within 1e-4), prefill + decode
against the full forward in the port itself (as tests/test_serving.py
holds the JAX model), and both serving engines' failure on the family.
Train states: a state written by either package's ``CheckpointManager``
resumes in the other with JAX's keys and dtypes, and the next two steps'
losses equal the writer's own continuation (within 1e-4 relative).  The
training CLI: one ``--supervise --simulate-failure`` run on the CPU."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxEngine
from repro.training import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (
    CheckpointManager, load_checkpoint, load_jax_npz, params_from_jax,
)
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.training import make_train_step

from _torch_helpers import flatten_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-small"
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(arch=ARCH, seed=0):
    jc = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jm = jax_build_model(jc)
    jp = jm.init_params(jax.random.key(seed))
    return jm, jp, build_model(tc, device="cpu"), params_from_jax(flatten_jax(jp), device="cpu")


def _audio(cfg, B=2, S=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (B, S + 4)).astype(np.int32))


# ---------------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------------

def test_params_from_jax_on_whisper_trees(tmp_path):
    """``enc_blocks``/``dec_blocks`` become per-layer lists, no empty
    ``blocks`` appears, and the port's writer gives JAX's keys back."""
    jm, jp, tm, _ = _pair()
    path = jax_save_checkpoint(str(tmp_path / "w.npz"), jp)
    params = params_from_jax(load_jax_npz(path), device="cpu")
    assert set(params) == {"embed", "enc_blocks", "dec_blocks", "ln_enc", "ln_f", "lm_head"}
    assert len(params["enc_blocks"]) == tm.cfg.n_enc_layers
    assert len(params["dec_blocks"]) == tm.cfg.n_layers
    assert {"ln_x", "xq", "xk", "xv", "xo", "mlp"} <= set(params["dec_blocks"][0])
    ref = flatten_jax(jp)
    flat = _flatten(params)
    assert set(flat) == set(ref)
    for key, a in ref.items():
        np.testing.assert_array_equal(flat[key].numpy(), a, err_msg=key)
    # the meta tree of abstract_params has the same leaves
    assert {k: tuple(t.shape) for k, t in _flatten(tm.abstract_params()).items()} == \
        {k: a.shape for k, a in ref.items()}


def test_forward_matches_jax():
    jm, jp, tm, tp = _pair()
    enc, toks = _audio(tm.cfg)
    ref, _ = jax.jit(jm.forward)(jp, {"enc_embeds": jnp.asarray(enc),
                                      "tokens": jnp.asarray(toks)})
    out, aux = tm.forward(tp, {"enc_embeds": torch.from_numpy(enc),
                               "tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32 and aux == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_prefill_then_decode_matches_jax():
    """Prefill 16 tokens into a cache of 24, then four decode steps at one
    scalar position each: logits and caches against the JAX package's, and
    each step's logits against the port's own full forward (the check of
    tests/test_serving.py, here at 1e-4)."""
    jm, jp, tm, tp = _pair()
    enc, toks = _audio(tm.cfg)
    S = 16
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S + 8))(
        jp, {"enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks[:, :S])})
    tl, tcache = tm.prefill(tp, {"enc_embeds": torch.from_numpy(enc),
                                 "tokens": torch.from_numpy(toks[:, :S])}, max_len=S + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    for k in jcache:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), err_msg=k, **TOL)
    full, _ = tm.forward(tp, {"enc_embeds": torch.from_numpy(enc),
                              "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, S - 1].numpy(), **TOL)
    jstep = jax.jit(jm.decode_step)
    for i in range(4):
        pos = S + i
        tok = toks[:, pos:pos + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, pos].numpy(), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), err_msg=k, **TOL)
    with pytest.raises(ValueError, match="one position"):
        tm.decode_step(tp, tcache, torch.from_numpy(tok), torch.tensor([S, S]))


def test_serving_engine_fails_on_whisper_as_in_jax():
    """Neither engine serves the audio family: the dense prefill passes
    ``{"tokens": ...}`` and ``encode`` reads ``batch["enc_embeds"]``, so the
    first prefill raises ``KeyError: 'enc_embeds'`` in both (ROADMAP.md
    Queue 3, reference caveats)."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(5)
    kw = dict(max_batch=2, max_len=32)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = ServingEngine(tm, tp, ServeConfig(**kw), device="cpu")
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        for i in range(2):
            eng.submit(cls(rid=i, prompt=rng.integers(0, 256, 6).astype(np.int32),
                           max_new_tokens=3))
        with pytest.raises(KeyError, match="enc_embeds"):
            eng.run_until_drained()


# ---------------------------------------------------------------------------------
# train states across the packages
# ---------------------------------------------------------------------------------

def _batches(cfg, n, b=4, s=24):
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=7))
    rng = np.random.default_rng(8)
    out = []
    for i in range(n):
        batch = data.batch(i)
        if cfg.family == "audio":
            batch["enc_embeds"] = rng.normal(size=(b, cfg.enc_len, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


OPT = dict(lr=3e-3, warmup_steps=1, total_steps=6)


def _jax_steps(jm, state, batches):
    step = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**OPT)))
    p, o, losses = state["params"], state["opt"], []
    for b in batches:
        p, o, met = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(met["loss"]))
    return {"params": p, "opt": o}, losses


def _torch_steps(tm, state, batches):
    step = make_train_step(tm, AdamWConfig(**OPT), donate=True)
    p, o, losses = state["params"], state["opt"], []
    for b in batches:
        p, o, met = step(p, o, b)
        losses.append(float(met["loss"]))
    return {"params": p, "opt": o}, losses


def _assert_state_keys_and_dtypes(flat, jstate):
    ref = flatten_jax(jstate)
    assert set(flat) == set(ref)
    assert "opt/step" in ref and "opt/m/embed" in ref
    assert any(k.startswith("opt/v/") and "_blocks/" in k for k in ref) or \
        any(k.startswith("opt/v/blocks/") for k in ref)
    for key, a in ref.items():
        assert str(flat[key].dtype).replace("torch.", "") == a.dtype.name, key


@pytest.mark.parametrize("arch", ["smollm-135m", ARCH])
def test_jax_train_state_resumes_in_the_port(arch, tmp_path):
    """JAX trains two steps and saves {params, opt} through its
    CheckpointManager; the port restores it against its own template (keys
    ``opt/m/...``, f32 m/v and the int32 step kept) and its next two steps'
    losses equal JAX's own next two."""
    jm, jp, tm, tp = _pair(arch)
    batches = _batches(tm.cfg, 4)
    jstate, _ = _jax_steps(jm, {"params": jp, "opt": jax_adamw_init(jp)}, batches[:2])
    mgr = JaxCheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(jstate, step=2)
    _, ref_losses = _jax_steps(jm, jstate, batches[2:])
    template = {"params": tp, "opt": adamw_init(tp)}
    state, meta = CheckpointManager(str(tmp_path)).restore_latest(template, device="cpu")
    assert meta == {"step": 2} and int(state["opt"]["step"]) == 2
    assert state["opt"]["step"].dtype == torch.int32
    _assert_state_keys_and_dtypes(_flatten(state), jstate)
    _, losses = _torch_steps(tm, state, batches[2:])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


@pytest.mark.parametrize("arch", ["smollm-135m", ARCH])
def test_port_train_state_resumes_in_jax(arch, tmp_path):
    """The reverse: the port trains two steps from JAX's weights and saves
    through its CheckpointManager; JAX restores the file against its own
    template, and its next two steps' losses equal the port's own."""
    jm, jp, tm, tp = _pair(arch)
    batches = _batches(tm.cfg, 4)
    state, _ = _torch_steps(tm, {"params": tp, "opt": adamw_init(tp)}, batches[:2])
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(state, step=2)
    mgr.wait()
    _, losses = _torch_steps(tm, state, batches[2:])
    jtmpl = {"params": jp, "opt": jax_adamw_init(jp)}
    jstate, meta = JaxCheckpointManager(str(tmp_path)).restore_latest(jtmpl)
    assert meta == {"step": 2} and int(jstate["opt"]["step"]) == 2
    _assert_state_keys_and_dtypes(_flatten(state), jstate)
    _, ref_losses = _jax_steps(jm, jstate, batches[2:])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_train_state_keeps_f32_moments_at_bf16(tmp_path):
    """At bf16 parameters the state's m/v stay float32 and step int32
    through the port's writer and reader, and the file's keys and dtypes
    are JAX's (the JAX reader restores it against JAX's own template)."""
    tc = get_smoke_config(ARCH)
    tm = build_model(tc, device="cpu")
    tp = tm.init_params(2)
    state = {"params": tp, "opt": adamw_init(tp)}
    state["opt"]["step"] += 3
    CheckpointManager(str(tmp_path), async_save=False).save(state, step=3)
    path = CheckpointManager(str(tmp_path)).latest()
    back, _ = load_checkpoint(path, state, device="cpu")
    for key, t in _flatten(state).items():
        got = _flatten(back)[key]
        assert got.dtype == t.dtype and torch.equal(got, t), key
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(path, state, device="cpu", dtype=torch.float32)
    jm = jax_build_model(jax_smoke_config(ARCH))
    jp = jm.abstract_params()
    jstate, _ = JaxCheckpointManager(str(tmp_path)).restore_latest(
        {"params": jp, "opt": jax.eval_shape(jax_adamw_init, jp)})
    assert int(jstate["opt"]["step"]) == 3
    assert jstate["opt"]["m"]["dec_blocks"]["xq"].dtype == jnp.float32
    assert jstate["params"]["dec_blocks"]["xq"].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------------

def test_train_cli_supervised_failure_resumes(tmp_path):
    """``--supervise --simulate-failure 5``: the child exits 17 at step 5,
    the supervisor restarts it, and the restart resumes from the newest
    complete train-state checkpoint and finishes.  Checkpoints are written
    after steps 2 and 4 (``--ckpt-every 2``) on a thread; the second may
    still be in flight when the process dies, and is then skipped for its
    missing ``.ok`` marker, so the resume is from step 3 or step 5."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_SUPERVISED", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke",
         "--supervise", "--simulate-failure", "5", "--steps", "8", "--batch", "2",
         "--seq", "32", "--ckpt-every", "2", "--log-every", "1",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    log = out.stdout + out.stderr
    assert out.returncode == 0, log
    assert "SIMULATED FAILURE at step 5" in log
    assert "child exited rc=17" in log
    assert re.search(r"\[train\] resumed from step [35]\b", log), log
    assert "[supervisor] run completed" in log
    assert re.search(r"\[train\] done: loss [\d.]+ -> [\d.]+", log), log
