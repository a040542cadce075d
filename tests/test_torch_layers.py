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
    params = params_from_jax(flat, device="cpu")
    assert len(params["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(
        params["blocks"][2]["mlp"]["w_up"].view(torch.int16).numpy(),
        ref["blocks/mlp/w_up"][2].view(np.int16))
    assert params["blocks"][1]["bq"].shape == (cfg.n_heads * cfg.resolved_head_dim,)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b"])
def test_params_from_jax_nests_every_path_and_keeps_f32_leaves(tmp_path, arch):
    """A bf16 JAX checkpoint carried across: every ``/``-separated path nests
    (``shared_attn/mlp/w_gate`` -> params["shared_attn"]["mlp"]["w_gate"],
    not a flat key), values bit-exact; and with ``dtype=`` the leaves the JAX
    package keeps in float32 (A_log, D, dt_bias) stay float32."""
    from repro.models import build_model as jax_build
    import jax
    from repro_torch.checkpoint import F32_LEAVES
    jp = jax_build(jax_smoke_config(arch)).init_params(jax.random.key(4))
    ref = flatten_jax(jp)
    flat = load_jax_npz(save_checkpoint(str(tmp_path / "ckpt_00000001.npz"), jp, step=1))
    for dtype in (None, torch.bfloat16, torch.float32):
        params = params_from_jax(flat, device="cpu", dtype=dtype)
        assert not any("/" in key for key in params)
        for key, a in ref.items():
            names = key.split("/")
            node = params["blocks"][1] if names[0] == "blocks" else params
            for name in names[1:] if names[0] == "blocks" else names:
                node = node[name]
            want = a[1] if names[0] == "blocks" else a
            if names[-1] in F32_LEAVES or dtype is None:
                assert node.dtype == flat[key].dtype, key        # as stored
            else:
                assert node.dtype == dtype, key
            np.testing.assert_array_equal(node.float().numpy(),
                                          np.asarray(want, np.float32), err_msg=key)
    if arch == "zamba2-2.7b":
        params = params_from_jax(flat, device="cpu", dtype=torch.bfloat16)
        assert params["shared_attn"]["mlp"]["w_gate"].dtype == torch.bfloat16
        assert params["blocks"][0]["A_log"].dtype == torch.float32


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


def test_params_from_jax_needs_gpu_or_explicit_cpu(monkeypatch):
    """The checkpoint loader places the weights on the card by default, as
    build_model does: without a GPU it raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flat = {"embed": torch.zeros(4, 2), "blocks/wq": torch.zeros(3, 2, 2)}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(flat)
    params = params_from_jax(flat, device="cpu")
    assert params["embed"].device == torch.device("cpu") and len(params["blocks"]) == 3


def test_forward_refuses_cuda_tensors(monkeypatch):
    """forward refused CUDA tensors until the flash-attention kernel was
    ported; now it runs there, each layer's attention through the kernel's
    wrapper.  A tensor that reports itself as CUDA takes that route here."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.models import lm
    _, tc, _, _, tp = smoke_pair("gemma3-4b")

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    calls = []

    def flash(q, k, v, window):
        calls.append((window, q.is_cuda))
        return flash_attention_plain(q, k, v, window)

    monkeypatch.setattr(lm, "flash_attention_dyn", flash)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab, (2, 11)))
    ref, _ = lm.forward(tp, {"tokens": tokens}, tc)
    calls.clear()
    out, _ = lm.forward(tp, {"tokens": tokens.as_subclass(FakeCuda)}, tc)
    assert calls == [(w, True) for w in lm.layer_windows(tc)]
    torch.testing.assert_close(out.as_subclass(torch.Tensor), ref, atol=0, rtol=0)


def _jax_prefill_inputs(tc, B=3, S=16, seed=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
    last_idx = np.array([S - 1, 4, 9][:B], np.int32)
    return tokens, last_idx


def _assert_cache_close(tcache, jcache):
    for key, jleaf in jcache.items():
        t, j = tcache[key].numpy(), np.asarray(jleaf)
        assert t.shape == j.shape, key
        if t.dtype == np.int8:      # a rounding tie may land one step apart
            assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(t, j, atol=2e-5, rtol=2e-5, err_msg=key)


PARAMS3 = [("smollm-135m", "native"), ("gemma3-4b", "native"), ("qwen2.5-3b", "int8")]


@pytest.mark.parametrize("arch,kv", PARAMS3)
def test_forward_and_prefill_match_jax(arch, kv):
    """forward logits; prefill with a per-row last_idx, a scalar one and
    none, padded to max_len, int8-quantized after attention."""
    from repro.models import lm as jax_lm
    from repro_torch.models import lm
    jc, tc, _, jp, tp = smoke_pair(arch, kv=kv)
    tokens, last_idx = _jax_prefill_inputs(tc)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    jl, _ = jax_lm.forward(jp, {"tokens": jt}, jc)
    tl, _ = lm.forward(tp, {"tokens": tt}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    for li in (last_idx, 7, None):
        jli = None if li is None else jnp.asarray(li)
        tli = None if li is None else (torch.from_numpy(li) if isinstance(li, np.ndarray)
                                       else li)
        jlog, jcache = jax_lm.prefill(jp, {"tokens": jt}, jc, max_len=24, last_idx=jli)
        tlog, tcache = lm.prefill(tp, {"tokens": tt}, tc, max_len=24, last_idx=tli)
        assert tlog.shape == (3, 1, tc.vocab)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5, rtol=2e-5)
        _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("arch,kv", PARAMS3)
def test_decode_step_paged_matches_jax(arch, kv):
    """One token per row at heterogeneous positions over a paged pool: the
    logits and every written page match the JAX gather route."""
    from repro.models import lm as jax_lm
    from repro_torch.models import lm
    jc, tc, _, jp, tp = smoke_pair(arch, kv=kv)
    rng = np.random.default_rng(9)
    B, ps, n = 3, 4, 8
    P = B * n + 1
    L, Hkv, hd = jc.n_layers, jc.n_kv_heads, jc.resolved_head_dim
    pos = np.array([0, 6, 27], np.int32)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tbl = np.zeros((B, n), np.int32)
    for b in range(B):
        live = pos[b] // ps + 1
        tbl[b, :live] = perm[b * n:b * n + live]
    if kv == "int8":
        cache = {"k": rng.integers(-127, 128, (L, P, ps, Hkv, hd)).astype(np.int8),
                 "v": rng.integers(-127, 128, (L, P, ps, Hkv, hd)).astype(np.int8),
                 "k_scale": rng.uniform(1e-3, 2e-2, (L, P, ps, Hkv, 1)).astype(np.float32),
                 "v_scale": rng.uniform(1e-3, 2e-2, (L, P, ps, Hkv, 1)).astype(np.float32)}
    else:
        cache = {"k": rng.normal(size=(L, P, ps, Hkv, hd)).astype(np.float32),
                 "v": rng.normal(size=(L, P, ps, Hkv, hd)).astype(np.float32)}
    token = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
    jlog, jcache = jax_lm.decode_step(jp, {k: jnp.asarray(a) for k, a in cache.items()},
                                      jnp.asarray(token), jnp.asarray(pos), jc,
                                      block_table=jnp.asarray(tbl))
    tcache = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    tlog, tcache = lm.decode_step(tp, tcache, torch.from_numpy(token), torch.from_numpy(pos),
                                  tc, block_table=torch.from_numpy(tbl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5, rtol=2e-5)
    _assert_cache_close({k: v[:, 1:] for k, v in tcache.items()},
                        {k: v[:, 1:] for k, v in jcache.items()})


@pytest.mark.parametrize("window", [-1, 300])
def test_stream_attention_matches_jax(window):
    """The CPU route above STREAM_THRESHOLD, at S = 1024 with small heads:
    two query chunks against the JAX scan and the port's plain version."""
    from repro.models import lm as jax_lm
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.models import lm
    rng = np.random.default_rng(10)
    q = rng.normal(size=(1, 1024, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, 1024, 1, 8)).astype(np.float32)
    v = rng.normal(size=(1, 1024, 1, 8)).astype(np.float32)
    ref = np.asarray(jax_lm._stream_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), jnp.int32(window)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = lm._stream_attention(tq, tk, tv, window)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), flash_attention_plain(tq, tk, tv, window).numpy(),
                               atol=2e-5, rtol=2e-5)
