"""PyTorch port, the ssm path: the SSD intra-chunk and dense decode-attention
kernel modules, the SSD scan and the Mamba-2 block, and the mamba2 / zamba2
models.  Each is held against the JAX package on the same numpy inputs at
float32; the CUDA kernels are held against these plain versions on the card
in tests/test_torch_cuda.py.  The engine's dense-cache fallback is in
tests/test_torch_dense_cache.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.ssd.ops import ssd_intra as jax_ssd_intra
from repro.kernels.ssd.ref import ssd_intra_ref
from repro.models import attention as jattn
from repro.models import mamba_lm as jax_mamba_lm
from repro.models import ssm as jssm
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_plain
from repro_torch.kernels.ssd.ops import ssd_intra, ssd_intra_plain
from repro_torch.models import attention as tattn
from repro_torch.models import mamba_lm
from repro_torch.models import ssm as tssm

from _torch_helpers import (
    DENSE_DECODE_SHAPES, dense_decode_inputs, ssd_inputs, torch_pair,
)

KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_kernels.py's f32 tolerance
# whole SSD scans, blocks and model stacks: the same f32 functions summed in
# another order (cumsum, einsum contraction paths) over values of O(10)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------------
# kernel modules
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("b,nc,q,h,p,n,groups", [
    (1, 2, 16, 4, 8, 8, 1),
    (2, 2, 16, 4, 8, 8, 2),          # group -> head order matters
    (1, 3, 32, 4, 16, 16, 4),
])
def test_ssd_intra_plain_matches_jax(b, nc, q, h, p, n, groups):
    """The plain version against the Pallas kernel (interpret mode) and the
    ssd_intra_ref oracle, Bh/Ch repeated over heads in jnp.repeat's order."""
    xb, acs, Bq, Cq = ssd_inputs(b, nc, q, h, p, n, groups)
    rep = h // groups
    Bh, Ch = np.repeat(Bq, rep, axis=3), np.repeat(Cq, rep, axis=3)
    j = [jnp.asarray(a) for a in (xb, acs, Bh, Ch)]
    ref_kernel = np.asarray(jax_ssd_intra(*j))
    flat = [a.reshape((b * nc,) + a.shape[2:]) for a in j]
    ref = np.asarray(ssd_intra_ref(*flat)).reshape(ref_kernel.shape)
    t = [_t(a) for a in (xb, acs, Bh, Ch)]
    out = ssd_intra_plain(*t)
    np.testing.assert_allclose(out.numpy(), ref_kernel, **KERNEL_TOL)
    np.testing.assert_allclose(out.numpy(), ref, **KERNEL_TOL)
    # the wrapper takes the plain version for CPU tensors, and only there
    assert torch.equal(ssd_intra(*t), out)
    # torch's repeat_interleave is jnp.repeat; Tensor.repeat (tiling) is not
    assert torch.equal(_t(Bq).repeat_interleave(rep, dim=3), t[2])
    if 1 < groups < h:
        assert not torch.equal(_t(Bq).repeat(1, 1, 1, rep, 1), t[2])


@pytest.mark.parametrize("B,S,Hq,Hkv,D,pos,window", DENSE_DECODE_SHAPES)
def test_decode_attention_plain_matches_jax(B, S, Hq, Hkv, D, pos, window):
    """The dense one-query plain version, and mha_decode with and without
    the kernel route, against the Pallas kernel (interpret mode) and the
    decode_attention_ref oracle."""
    q, k, v = dense_decode_inputs(B, S, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_kernel = np.asarray(jax_decode_attention(jq, jk, jv, pos, window=window, block_k=256))
    ref = np.asarray(decode_attention_ref(jq[:, 0], jk, jv, pos, window))[:, None]
    tq, tk, tv = (_t(a) for a in (q, k, v))
    out = decode_attention_plain(tq, tk, tv, pos, window=window or -1)
    np.testing.assert_allclose(out.numpy(), ref_kernel, **KERNEL_TOL)
    np.testing.assert_allclose(out.numpy(), ref, **KERNEL_TOL)
    assert torch.equal(decode_attention(tq, tk, tv, pos, window=window, block_k=256), out)
    jplain = np.asarray(jattn.mha_decode(jq, jk, jv, pos, window=window))
    np.testing.assert_allclose(tattn.mha_decode(tq, tk, tv, pos, window=window).numpy(),
                               jplain, **KERNEL_TOL)
    assert torch.equal(tattn.mha_decode(tq, tk, tv, pos, window=window, use_kernel=True),
                       out)


def test_decode_attention_plain_no_visible_key_gives_zeros():
    """pos = 0: the TPU kernel skips every key tile and its clamped
    denominator gives zeros; the plain version follows the kernel."""
    q, k, v = (_t(a) for a in dense_decode_inputs(2, 64, 4, 2, 16))
    ref = np.asarray(jax_decode_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)), 0,
                                          block_k=32))
    out = decode_attention_plain(q, k, v, 0)
    assert not out.any() and not ref.any()


# ---------------------------------------------------------------------------------
# the SSD scan and the Mamba-2 block
# ---------------------------------------------------------------------------------

def _ssd_scan_inputs(b, s, h, p, g, n, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    st0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, D, st0


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("s,g,init", [(32, 1, False), (29, 2, True), (5, 4, True)])
def test_ssd_chunked_matches_jax(s, g, init, use_kernel):
    """Chunk 8 over s = 32, 29 and 5 (padded with dt = 0 identity rows),
    one to four groups, with and without an initial state; the final state
    as well as y.  The JAX side runs the same use_kernel (interpret mode)."""
    x, dt, A, B, C, D, st0 = _ssd_scan_inputs(2, s, 4, 8, g, 8)
    jy, jst = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C, D)), 8,
                               use_kernel=use_kernel,
                               initial_state=jnp.asarray(st0) if init else None,
                               return_state=True)
    ty, tst = tssm.ssd_chunked(*(_t(a) for a in (x, dt, A, B, C, D)), 8,
                               use_kernel=use_kernel,
                               initial_state=_t(st0) if init else None, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **MODEL_TOL)
    assert torch.equal(tssm.ssd_chunked(*(_t(a) for a in (x, dt, A, B, C, D)), 8,
                                        use_kernel=use_kernel,
                                        initial_state=_t(st0) if init else None), ty)


def test_ssd_decode_step_matches_jax():
    x, dt, A, B, C, D, st0 = _ssd_scan_inputs(3, 1, 4, 8, 2, 8)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, st0)
    jy, jst = jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    ty, tst = tssm.ssd_decode_step(*(_t(a) for a in args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **KERNEL_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **KERNEL_TOL)


@pytest.mark.parametrize("decode", [False, True])
def test_mamba2_block_matches_jax(decode):
    """The full mixer on mamba2-smoke's first layer: prefill over 13 tokens
    from a carried state, and one decode step from (state, conv_state)."""
    jc, tc, _, jp, tp = torch_pair("mamba2-1.3b")
    jb = {k: v[0] for k, v in jp["blocks"].items()}
    tb = tp["blocks"][0]
    rng = np.random.default_rng(8)
    s = 1 if decode else 13
    cfg = tc.ssm
    d_in = cfg.expand * tc.d_model
    h = d_in // cfg.head_dim
    x = rng.normal(size=(2, s, tc.d_model)).astype(np.float32)
    st = rng.normal(size=(2, h, cfg.head_dim, cfg.d_state)).astype(np.float32)
    kw_j = dict(state=jnp.asarray(st))
    kw_t = dict(state=_t(st))
    if decode:
        cv = rng.normal(size=(2, cfg.conv_width, d_in + 2 * cfg.d_state)).astype(np.float32)
        kw_j.update(conv_state=jnp.asarray(cv))
        kw_t.update(conv_state=_t(cv), decode=True)
    jout = jax.jit(partial(jssm.mamba2_block, cfg=jc.ssm, decode=decode))(
        jnp.asarray(x), jb, **kw_j)
    tout = tssm.mamba2_block(_t(x), tb, tc.ssm, use_kernel=not decode, **kw_t)
    for a, j in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), **MODEL_TOL)


# ---------------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------------

def _assert_tree_close(t, j):
    assert set(t) == set(j)
    for key in j:
        assert tuple(t[key].shape) == tuple(j[key].shape), key
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), err_msg=key,
                                   **MODEL_TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_mamba_lm_matches_jax(arch):
    """forward, prefill (attention caches padded to max_len) and three
    decode steps at a scalar position, weights carried across from the JAX
    init: logits and every cache leaf."""
    jc, tc, _, jp, tp = torch_pair(arch)
    toks = np.random.default_rng(9).integers(0, jc.vocab, (2, 13)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jit = jax.jit   # the JAX side compiled: op-by-op dispatch is slower here
    jl, _ = jit(partial(jax_mamba_lm.forward, cfg=jc))(jp, {"tokens": jt})
    tl, aux = mamba_lm.forward(tp, {"tokens": tt}, tc)
    assert aux == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    jlog, jcache = jit(partial(jax_mamba_lm.prefill, cfg=jc, max_len=20))(jp, {"tokens": jt})
    tlog, tcache = mamba_lm.prefill(tp, {"tokens": tt}, tc, max_len=20)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL_TOL)
    _assert_tree_close(tcache, jcache)
    empty = mamba_lm.init_cache(tc, 2, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
           {k: tuple(v.shape) for k, v in jax_mamba_lm.init_cache(jc, 2, 20).items()}
    assert mamba_lm._n_attn_calls(tc) == jax_mamba_lm._n_attn_calls(jc)
    tok = np.random.default_rng(10).integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jdecode = jit(partial(jax_mamba_lm.decode_step, cfg=jc))
    for i in range(3):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok), jnp.int32(13 + i))
        tlog, tcache = mamba_lm.decode_step(tp, tcache, torch.from_numpy(tok), 13 + i, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **MODEL_TOL)
        _assert_tree_close(tcache, jcache)
        tok = np.asarray(jlog[:, 0].argmax(-1))[:, None].astype(np.int32)
        assert np.array_equal(tlog[:, 0].argmax(-1).numpy()[:, None], tok)
    if tc.shared_attn_every:
        with pytest.raises(ValueError, match="one position"):
            mamba_lm.decode_step(tp, tcache, torch.from_numpy(tok), torch.tensor([16, 16]), tc)


def test_mamba_init_params_seeded_with_jax_layout():
    """Random weights: the JAX tree's names and shapes, A_log / D / dt_bias in
    float32 at bf16, and one seed gives one set of weights."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("zamba2-2.7b")
    a = build_model(cfg, device="cpu").init_params(5)
    b = build_model(cfg, device="cpu").init_params(5)
    assert torch.equal(a["blocks"][2]["w_x"], b["blocks"][2]["w_x"])
    shapes = jax.eval_shape(jax_build(jax_smoke_config("zamba2-2.7b")).init_params,
                            jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(k, "key", k)) for k in path]
        node, shape = a, leaf.shape
        if names[0] == "blocks":
            node, names, shape = a["blocks"][0], names[1:], shape[1:]
            assert len(a["blocks"]) == leaf.shape[0]
        for name in names:
            node = node[name]
        assert tuple(node.shape) == shape, names
        assert (node.dtype == torch.float32) == (leaf.dtype == jnp.float32), names
