"""PyTorch port, kernel modules: each plain version against the JAX Pallas
kernel (run in interpret mode) and the JAX plain route, at float32 and the
tolerances of tests/test_kernels.py.  The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_mixed as jax_mixed
from repro.kernels.sampling.kernel import lmhead_epilogue_fwd
from repro.kernels.sampling.ref import lmhead_greedy_ref
from repro.models.attention import sdpa as jax_sdpa
from repro.serving.kvcache import _span_mask as jax_span_mask
from repro.serving.kvcache import paged_gather as jax_gather
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_mixed, paged_mixed_attention_plain,
)
from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, lmhead_greedy_plain

from _torch_helpers import lmhead_inputs, mixed_inputs

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
