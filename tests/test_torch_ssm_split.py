"""PyTorch port: the plans of the two-pass SSD intra-chunk kernel and of the
bf16 split-K dense decode-attention kernel, against the JAX package on the
CPU at float32.

* :func:`ssd_intra_grouped_plain` (scores C.B^T once per group, then each
  head's decay by select and P x) against ``ssd_intra_ref`` and the Pallas
  kernel (interpret mode), with one group and with two materialised
  groups, q not a multiple of the kernel's 64-row tiles;
* the wrapper finds the groups from the head strides, and the grids it
  launches cover the card at mamba2-1.3b's nc 1;
* :func:`decode_attention_split_plain` (per-split partials over 64-key
  pages, then the log-sum-exp merge) against the JAX
  ``decode_attention`` (Pallas kernel, interpret mode) and
  ``decode_attention_ref``, with and without a window, at pos 0, 1 and S,
  at several split widths;
* the dense split plan covers the visible keys exactly once.

Tolerances: 1e-5 of the output's largest magnitude for the SSD term (f32
sums over up to q * n products in another order); 2e-5 for attention, as
tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.ssd.ops import ssd_intra as jax_ssd_intra
from repro.kernels.ssd.ref import ssd_intra_ref
from repro_torch.kernels.decode_attention.ops import (
    DENSE_SPLIT_KEYS, _dense_span, _split_runs, choose_dense_pages_per_split,
    decode_attention_plain, decode_attention_split_plain, dense_live_pages,
)
from repro_torch.kernels.ssd.ops import (
    _groups, ssd_intra_grids, ssd_intra_grouped_plain, ssd_intra_plain,
)

from _torch_helpers import dense_decode_inputs, ssd_inputs

ATT_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------------
# SSD intra-chunk: scores once per group
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("b,nc,q,h,p,n,groups", [
    (1, 2, 40, 4, 16, 16, 1),        # one group, ragged q
    (2, 3, 40, 4, 16, 16, 2),        # two materialised groups, ragged q
    (1, 1, 70, 6, 8, 12, 2),         # q over one 64-row tile
])
def test_ssd_intra_grouped_plain_matches_jax(b, nc, q, h, p, n, groups):
    xb, acs, Bq, Cq = ssd_inputs(b, nc, q, h, p, n, groups)
    rep = h // groups
    Bh, Ch = np.repeat(Bq, rep, axis=3), np.repeat(Cq, rep, axis=3)
    flat = [jnp.asarray(a.reshape((b * nc,) + a.shape[2:])) for a in (xb, acs, Bh, Ch)]
    ref = np.asarray(ssd_intra_ref(*flat)).reshape(xb.shape)
    ref_kernel = np.asarray(jax_ssd_intra(*(jnp.asarray(a) for a in (xb, acs, Bh, Ch))))
    out = ssd_intra_grouped_plain(_t(xb), _t(acs), _t(Bq), _t(Cq)).numpy()
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)
    np.testing.assert_allclose(out, ref_kernel, atol=tol, rtol=0)
    plain = ssd_intra_plain(_t(xb), _t(acs), _t(Bh), _t(Ch)).numpy()
    np.testing.assert_allclose(out, plain, atol=tol, rtol=0)


def test_ssd_groups_from_head_strides_and_grids():
    """An expand view (zero head stride) is one group of every head; a
    materialised tensor is a group a head.  At mamba2-1.3b's nc 1 (q 256,
    64 heads of 64, one group) the kernel runs 10 score blocks (the causal
    pairs of 4 tiles, once for the group) and 512 head blocks."""
    b, nc, q, h, n = 1, 2, 16, 4, 8
    Bq = torch.randn(b, nc, q, 1, n)
    Bh = Bq.expand(b, nc, q, h, n)
    Bg, Cg, G = _groups(Bh, Bh)
    assert G == 1 and Bg.shape == (b, nc, q, 1, n) and torch.equal(Bg, Bq)
    Bm = Bq.repeat_interleave(h, dim=3)
    assert _groups(Bm, Bm)[2] == h
    assert _groups(Bh, Bm)[2] == h                   # both must share the group
    assert ssd_intra_grids(1, 256, 64, 64, 1) == (10, 512)
    assert ssd_intra_grids(1, 256, 64, 64, 64) == (640, 512)
    assert ssd_intra_grids(8, 256, 80, 64, 1) == (80, 5120)
    assert ssd_intra_grids(6, 40, 4, 16, 4) == (24, 48)


# ---------------------------------------------------------------------------------
# dense decode attention: split-K over 64-key pages
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("pps", [1, 2, 3, 5])
@pytest.mark.parametrize("pos", [0, 1, 200, 320])
@pytest.mark.parametrize("window", [None, 70])
def test_decode_attention_split_plain_matches_jax(window, pos, pps):
    """B 2, S 320, 8 / 2 heads of 16 (the JAX kernel's key tiles of 64 must
    divide S; a ragged S is covered by the plan test below and on the
    card)."""
    B, S, Hq, Hkv, D = 2, 320, 8, 2, 16
    q, k, v = dense_decode_inputs(B, S, Hq, Hkv, D)
    out = decode_attention_split_plain(_t(q), _t(k), _t(v), pos, window=window or -1,
                                       pages_per_split=pps).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_kernel = np.asarray(jax_decode_attention(jq, jk, jv, pos, window=window, block_k=64))
    np.testing.assert_allclose(out, ref_kernel, **ATT_TOL)
    if pos > 0:
        ref = np.asarray(decode_attention_ref(jq[:, 0], jk, jv, pos, window))[:, None]
        np.testing.assert_allclose(out, ref, **ATT_TOL)
    else:
        assert not out.any()
    plain = decode_attention_plain(_t(q), _t(k), _t(v), pos, window=window or -1).numpy()
    np.testing.assert_allclose(out, plain, **ATT_TOL)


@pytest.mark.parametrize("seed", range(6))
def test_dense_split_plan_covers_visible_keys_exactly_once(seed):
    """The keys each split's block reads, [max(split start, span start),
    min(split end, span end)), tile the dense span [max(pos - window, 0),
    min(pos, S)) exactly once, and each run lies in one split."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        S = int(rng.integers(1, 600))
        pos = int(rng.integers(0, S + 80))
        window = int(rng.choice([-1, 1, 5, 64, 100, 1000]))
        pps = int(rng.integers(1, 6))
        klo, khi = _dense_span(S, pos, window)
        keys = []
        for pa, pe in _split_runs(*dense_live_pages(S, pos, window), pps):
            assert pa // pps == (pe - 1) // pps
            keys += range(max(pa * DENSE_SPLIT_KEYS, klo), min(pe * DENSE_SPLIT_KEYS, khi))
        assert len(keys) == len(set(keys))
        assert set(keys) == set(range(klo, khi))


def test_dense_pages_per_split_fills_the_card():
    """zamba2-2.7b's shared attention (B 8, 32 kv heads, pos 3000): 4 pages
    of 64 keys a split, 12 live splits, 3072 blocks for 132 SMs; gemma3-4b's
    local layers (8 rows x 4 kv heads, window 1024): single pages, 17 live
    splits, 544 blocks, where one block a (row, kv head) gave 32."""
    for B, Hkv, pos, window, pps, splits in ((8, 32, 3000, -1, 4, 12),
                                             (8, 4, 3000, 1024, 1, 17)):
        assert choose_dense_pages_per_split(B, Hkv, 4096, pos, window, 132) == pps
        lo, hi = dense_live_pages(4096, pos, window)
        live = (hi - 1) // pps - lo // pps + 1
        assert live == splits and B * Hkv * live >= 4 * 132
    assert choose_dense_pages_per_split(1, 1, 4096, 4000, -1, 132) == 1
