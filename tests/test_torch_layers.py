"""PyTorch port, model substrate: primitive layers, configs, weights carried
across from the JAX package, and the device rule.  Inputs are made with
numpy from a seed and handed to both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.checkpoint import load_jax_npz, params_from_jax
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import common as tcommon

from _torch_helpers import flatten_jax, smoke_pair

TOL = dict(atol=1e-6, rtol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3.0
    g = rng.normal(size=(48,)).astype(np.float32)
    ref = np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    out = tcommon.rms_norm(_t(x), _t(g), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    pos = np.array([[0, 1, 2, 3], [17, 18, 19, 20], [60, 61, 62, 63]], np.int32)
    x = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    jc, js = jcommon.rope_tables(jnp.asarray(pos), 16, theta)
    tc, ts = tcommon.rope_tables(_t(pos), 16, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    ref = np.asarray(jcommon.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(tcommon.apply_rope(_t(x), tc, ts).numpy(), ref, **TOL)


@pytest.mark.parametrize("per_batch", [False, True])
def test_sdpa_matches_jax(per_batch):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 8)).astype(np.float32)
    if per_batch:
        mask = rng.random((2, 5, 7)) < 0.7
        mask[..., 0] = True
    else:
        mask = np.asarray(jattn.attention_mask(5, 7, causal=True, window=3, q_offset=2))
        tmask = tattn.attention_mask(5, 7, causal=True, window=3, q_offset=2)
        np.testing.assert_array_equal(tmask.numpy(), mask)
    ref = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask)))
    out = tattn.sdpa(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """Every ModelConfig field equals the JAX config's, dtype aside."""
    for get_t, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke_config)):
        t, j = dataclasses.asdict(get_t(arch)), dataclasses.asdict(get_j(arch))
        assert t.pop("dtype") == torch.bfloat16 and j.pop("dtype") == jnp.bfloat16
        assert t == j


def test_jax_checkpoint_carries_across_bit_exact(tmp_path):
    """JAX save_checkpoint at bf16 -> load_jax_npz: every leaf bit-exact,
    and params_from_jax splits the layer-stacked blocks."""
    from repro.models import build_model as jax_build
    import jax
    cfg = jax_smoke_config("qwen2.5-3b")                 # bf16, with qkv bias
    jp = jax_build(cfg).init_params(jax.random.key(3))
    path = save_checkpoint(str(tmp_path / "ckpt_00000001.npz"), jp, step=1)
    flat = load_jax_npz(path)
    ref = flatten_jax(jp)
    assert set(flat) == set(ref)
    for key, a in ref.items():
        t = flat[key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, key
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=key)
    params = params_from_jax(flat)
    assert len(params["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(
        params["blocks"][2]["mlp"]["w_up"].view(torch.int16).numpy(),
        ref["blocks/mlp/w_up"][2].view(np.int16))
    assert params["blocks"][1]["bq"].shape == (cfg.n_heads * cfg.resolved_head_dim,)


def test_params_from_jax_matches_tree():
    _, tc, _, jp, tp = smoke_pair("gemma3-4b")
    assert len(tp["blocks"]) == tc.n_layers
    for layer in (0, tc.n_layers - 1):
        np.testing.assert_array_equal(tp["blocks"][layer]["wq"].numpy(),
                                      np.asarray(jp["blocks"]["wq"][layer]))
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))


def test_init_params_seeded_with_jax_std_rule():
    cfg = get_smoke_config("smollm-135m")
    a = build_model(cfg, device="cpu").init_params(7)
    b = build_model(cfg, device="cpu").init_params(7)
    assert torch.equal(a["blocks"][1]["wq"], b["blocks"][1]["wq"])
    assert a["embed"].dtype == torch.bfloat16 and len(a["blocks"]) == cfg.n_layers
    w_down = a["blocks"][0]["mlp"]["w_down"].float()
    assert abs(w_down.std().item() - cfg.d_ff ** -0.5) < 0.2 * cfg.d_ff ** -0.5


def test_build_model_needs_gpu_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, device="cuda")
    assert build_model(cfg, device="cpu").device == torch.device("cpu")


def test_forward_refuses_cuda_tensors():
    """forward is the CPU oracle: on the card it would stand in for the
    flash-attention kernel, which is not ported."""
    from repro_torch.models import lm
    cfg = get_smoke_config("smollm-135m")

    class FakeCuda:
        is_cuda = True

    with pytest.raises(NotImplementedError, match="flash-attention"):
        lm.forward({}, {"tokens": FakeCuda()}, cfg)
