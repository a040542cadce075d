"""PyTorch port, kernel modules: each plain version against the JAX Pallas
kernel (run in interpret mode) and the JAX plain route, at float32 and the
tolerances of tests/test_kernels.py.  The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import paged_decode_attention_fwd
from repro.kernels.decode_attention.ops import decode_attention_mixed as jax_mixed
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_int8_ref, paged_decode_attention_ref,
)
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.sampling.kernel import greedy_epilogue_fwd, lmhead_epilogue_fwd
from repro.kernels.sampling.ref import greedy_epilogue_ref, lmhead_greedy_ref
from repro.models.attention import sdpa as jax_sdpa
from repro.serving.kvcache import _span_mask as jax_span_mask
from repro.serving.kvcache import paged_gather as jax_gather
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_mixed, decode_attention_paged, paged_decode_attention_plain,
    paged_mixed_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_dyn, flash_attention_plain,
)
from repro_torch.kernels.sampling.ops import (
    fused_lmhead_greedy, greedy_epilogue, greedy_epilogue_plain, lmhead_greedy_plain,
    lmhead_greedy_walk_plain,
)

from _torch_helpers import flash_inputs, lmhead_inputs, logits_inputs, mixed_inputs

ATT_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_mixed_attention_plain_matches_jax(group, window, int8):
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(group, int8)
    j = {k: (None if a is None else jnp.asarray(a))
         for k, a in dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, tbl=tbl, st=starts).items()}
    ref_kernel = np.asarray(jax_mixed(j["q"], j["kp"], j["vp"], j["tbl"], j["st"],
                                      window=window, k_scale=j["ks"], v_scale=j["vs"]))
    kd, vd = jax_gather(j["kp"], j["tbl"]), jax_gather(j["vp"], j["tbl"])
    if int8:
        kd = kd.astype(jnp.float32) * jax_gather(j["ks"], j["tbl"])
        vd = vd.astype(jnp.float32) * jax_gather(j["vs"], j["tbl"])
    mask = jax_span_mask(kd.shape[1], j["st"], q.shape[1], jnp.int32(window))
    ref_plain = np.asarray(jax_sdpa(j["q"], kd, vd, mask))

    t = {k: (None if a is None else torch.from_numpy(a))
         for k, a in dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, tbl=tbl, st=starts).items()}
    out = paged_mixed_attention_plain(t["q"], t["kp"], t["vp"], t["tbl"], t["st"],
                                      window=window, k_scale=t["ks"], v_scale=t["vs"])
    np.testing.assert_allclose(out.numpy(), ref_kernel, **ATT_TOL)
    np.testing.assert_allclose(out.numpy(), ref_plain, **ATT_TOL)
    # the wrapper takes the plain version for CPU tensors, and only there
    wrapped = decode_attention_mixed(t["q"], t["kp"], t["vp"], t["tbl"], t["st"],
                                     window=window, k_scale=t["ks"], v_scale=t["vs"])
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("kind", ["normal", "tie"])
def test_lmhead_plain_matches_jax(kind):
    h, w = lmhead_inputs(kind)
    if kind == "tie":
        logits = h @ w
        assert (logits[0] == logits[0].max()).sum() >= 3      # the forced tie
    tok_ref, lp_ref = (np.asarray(a) for a in lmhead_greedy_ref(jnp.asarray(h), jnp.asarray(w)))
    tok_k, lp_k = (np.asarray(a) for a in lmhead_epilogue_fwd(
        jnp.asarray(h), jnp.asarray(w), block_v=256, interpret=True))
    tok, lp = lmhead_greedy_plain(torch.from_numpy(h), torch.from_numpy(w))
    assert tok.dtype == torch.int32
    for t_ref, l_ref in ((tok_ref, lp_ref), (tok_k, lp_k)):
        np.testing.assert_array_equal(tok.numpy(), t_ref)
        np.testing.assert_allclose(lp.numpy(), l_ref, atol=1e-5)
    if kind == "tie":
        assert tok[0].item() == 3
    # the tied-head layout: w is a transposed view of a (V, d) embedding
    emb = torch.from_numpy(np.ascontiguousarray(w.T))
    tok_t, lp_t = fused_lmhead_greedy(torch.from_numpy(h).reshape(2, 3, -1), emb.T)
    assert tok_t.shape == (2, 3)
    assert torch.equal(tok_t.reshape(-1), tok) and torch.equal(lp_t.reshape(-1), lp)


@pytest.mark.parametrize("window", [-1, 5])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_flash_attention_plain_matches_jax(group, window):
    """(B, S, H, D) plain version against the Pallas kernel (interpret mode,
    two query and key tiles) and the attention_ref oracle, (B, H, S, D)."""
    q, k, v = flash_inputs(group)
    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    ref_kernel = np.asarray(flash_attention_fwd(
        jq, jk, jv, jnp.array([window], jnp.int32), block_q=16, block_k=16,
        interpret=True)).transpose(0, 2, 1, 3)
    ref = np.asarray(attention_ref(jq, jk, jv, window)).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, window)
    np.testing.assert_allclose(out.numpy(), ref_kernel, **ATT_TOL)
    np.testing.assert_allclose(out.numpy(), ref, **ATT_TOL)
    # the wrappers take the plain version for CPU tensors, and only there
    assert torch.equal(flash_attention_dyn(tq, tk, tv, window), out)
    assert torch.equal(flash_attention(tq, tk, tv, window=window if window > 0 else None), out)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_paged_decode_plain_matches_jax(group, window, int8):
    """One query per row over the paged pool: the plain version against the
    Pallas kernel (interpret mode) and the gather oracles; at T = 1 it is
    the mixed plain version with starts = lengths - 1."""
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(group, int8, T=1)
    lengths = starts + 1
    j = {k: (None if a is None else jnp.asarray(a))
         for k, a in dict(q=q[:, 0], kp=kp, vp=vp, ks=ks, vs=vs, tbl=tbl,
                          lens=lengths).items()}
    ref_kernel = np.asarray(paged_decode_attention_fwd(
        j["q"], j["kp"], j["vp"], j["tbl"], j["lens"], jnp.array([window], jnp.int32),
        k_scale=j["ks"], v_scale=j["vs"], interpret=True))
    if int8:
        ref = paged_decode_attention_int8_ref(j["q"], j["kp"], j["vp"], j["ks"], j["vs"],
                                              j["tbl"], j["lens"], window)
    else:
        ref = paged_decode_attention_ref(j["q"], j["kp"], j["vp"], j["tbl"], j["lens"],
                                         window)
    t = {k: (None if a is None else torch.from_numpy(a))
         for k, a in dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, tbl=tbl, lens=lengths).items()}
    args = (t["q"], t["kp"], t["vp"], t["tbl"], t["lens"])
    sc = dict(k_scale=t["ks"], v_scale=t["vs"])
    out = paged_decode_attention_plain(*args, window=window, **sc)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy()[:, 0], ref_kernel, **ATT_TOL)
    np.testing.assert_allclose(out.numpy()[:, 0], np.asarray(ref), **ATT_TOL)
    mixed = paged_mixed_attention_plain(t["q"], t["kp"], t["vp"], t["tbl"],
                                        t["lens"] - 1, window=window, **sc)
    np.testing.assert_allclose(out.numpy(), mixed.numpy(), **ATT_TOL)
    assert torch.equal(decode_attention_paged(*args, window=window, **sc), out)


@pytest.mark.parametrize("kind", ["normal", "tie"])
def test_greedy_epilogue_plain_matches_jax(kind):
    """Existing (B, V) logits with V % block_v != 0: the plain version
    against the Pallas kernel (interpret mode) and the log_softmax oracle,
    first maximal index on exact ties."""
    x = logits_inputs(kind)
    tok_ref, lp_ref = (np.asarray(a) for a in greedy_epilogue_ref(jnp.asarray(x)))
    tok_k, lp_k = (np.asarray(a) for a in greedy_epilogue_fwd(
        jnp.asarray(x), block_v=256, interpret=True))
    tok, lp = greedy_epilogue_plain(torch.from_numpy(x))
    assert tok.dtype == torch.int32 and lp.dtype == torch.float32
    for t_ref, l_ref in ((tok_ref, lp_ref), (tok_k, lp_k)):
        np.testing.assert_array_equal(tok.numpy(), t_ref)
        np.testing.assert_allclose(lp.numpy(), l_ref, atol=1e-5)
    if kind == "tie":
        assert tok[0].item() == 3
    wrapped = greedy_epilogue(torch.from_numpy(x))
    assert torch.equal(wrapped[0], tok) and torch.equal(wrapped[1], lp)


def _lmhead_jax(h, w):
    """The Pallas lm-head kernel in interpret mode, two vocab blocks of 512."""
    return (np.asarray(a) for a in lmhead_epilogue_fwd(jnp.asarray(h), jnp.asarray(w),
                                                       block_v=512, interpret=True))


@pytest.mark.parametrize("tile_v", [64, 128])
@pytest.mark.parametrize("n_blocks", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("kind", ["normal", "tie"])
def test_lmhead_walk_plain_matches_jax(kind, n_blocks, tile_v):
    """The bf16 kernel's order of work -- block j walks vocab tiles j,
    j + n_blocks, ..., one partial per block and row, partials folded with
    equal maxima to the lower index -- against the Pallas kernel: tokens
    equal, logprob within 1e-5.  The "tie" rows hold exact maxima at
    columns 3, 997 and the row's own argmax, in different blocks."""
    h, w = lmhead_inputs(kind)
    tok_k, lp_k = _lmhead_jax(h, w)
    tok, lp = lmhead_greedy_walk_plain(torch.from_numpy(h), torch.from_numpy(w),
                                       n_blocks=n_blocks, tile_v=tile_v)
    assert tok.dtype == torch.int32 and lp.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), tok_k)
    np.testing.assert_allclose(lp.numpy(), lp_k, atol=1e-5)
    if kind == "tie":
        assert tok[0].item() == 3


@pytest.mark.parametrize("n_blocks", [2, 3])
def test_lmhead_walk_ties_go_to_the_lower_index_across_blocks(n_blocks):
    """An exact tie whose lower index sits in a later block than the higher
    one (tiles of 64: column 70 in block 1, column 130 in block 0 or 2):
    the fold must take 70, not the earlier partial's 130."""
    rng = np.random.default_rng(9)
    h = rng.integers(-2, 3, (5, 32)).astype(np.float32)
    h[0, 0] = 2.0                                  # row 0's maximum is sum |h[0]|
    w = rng.integers(-1, 2, (32, 999)).astype(np.float32)
    w[:, 70] = w[:, 130] = w[:, 900] = np.sign(h[0])
    logits = h @ w
    assert int(np.argmax(logits[0])) == 70 and (logits[0] == logits[0, 70]).sum() >= 3
    tok_k, lp_k = _lmhead_jax(h, w)
    tok, lp = lmhead_greedy_walk_plain(torch.from_numpy(h), torch.from_numpy(w),
                                       n_blocks=n_blocks, tile_v=64)
    assert tok[0].item() == 70
    np.testing.assert_array_equal(tok.numpy(), tok_k)
    np.testing.assert_allclose(lp.numpy(), lp_k, atol=1e-5)


@pytest.mark.parametrize("B,V", [(3, 2048), (4, 4099), (2, 6000)])
def test_greedy_epilogue_plain_ties_across_tiles_match_jax(B, V):
    """The greedy epilogue, whose kernel shares the lm-head's fold: exact
    maxima in different 2048-column tiles of the CUDA pass 1 (columns 5,
    2050 when it exists, and V - 1) give the first, as the Pallas kernel
    does with its own 2048-column blocks."""
    x = np.random.default_rng(B).integers(-4, 5, (B, V)).astype(np.float32)
    for col in (5, 2050, V - 1):
        if col < V:
            x[0, col] = 9.0
    x[1, V - 1] = x[1, 0] = 9.0
    tok_k, lp_k = (np.asarray(a) for a in greedy_epilogue_fwd(
        jnp.asarray(x), block_v=2048, interpret=True))
    tok, lp = greedy_epilogue_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(tok.numpy(), tok_k)
    np.testing.assert_allclose(lp.numpy(), lp_k, atol=1e-5)
    assert tok[0].item() == 5 and tok[1].item() == 0


def test_refuse_grad_guards_only_tracked_inputs():
    """The guard every CUDA wrapper runs before its launch: it raises while
    autograd records and an input requires grad, and passes under
    torch.no_grad, for inputs that do not, and for absent (None) ones."""
    from repro_torch.kernels import refuse_grad
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA kernel has no backward"):
        refuse_grad("flash_attention", y, x)
    refuse_grad("flash_attention", y, None)
    with torch.no_grad():
        refuse_grad("flash_attention", x, y)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-4b", "zamba2-2.7b"])
def test_training_route_equals_the_kernel_route_on_cpu(arch):
    """On the CPU, ``forward(..., use_kernel=False)`` (the JAX non-kernel
    branch that ``loss_fn`` takes, on every device) gives the logits of the
    default route through the wrappers' plain versions."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)))
    a, _ = model.forward(params, {"tokens": tokens})
    b, _ = model.forward(params, {"tokens": tokens}, use_kernel=False)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
