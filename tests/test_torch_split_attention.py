"""PyTorch port: the split-K arithmetic of the bf16 paged mixed-attention
and paged decode-attention kernels, the flash kernel's head dim 80, and
zamba2 at head dim 80, against the JAX package on the CPU at float32.

* :func:`paged_mixed_attention_split_plain` (partials per run of pages,
  then the log-sum-exp merge) against the one-pass plain version and the
  JAX ``decode_attention_mixed`` (Pallas kernel in interpret mode);
* :func:`paged_decode_attention_split_plain` (the same arithmetic at T = 1,
  reached through the decode signature) against the JAX
  ``paged_decode_attention_fwd`` (interpret mode) at every split size;
* :func:`split_plan` covers every live page of a row exactly once and never
  a dead one;
* ``flash_attention_plain`` at D = 80 against the JAX ``flash_attention_fwd``
  (interpret mode) and ``attention_ref``;
* a zamba2 config whose shared attention has head dim 80, at smoke depth:
  model-level prefill and four decode steps give the JAX package's greedy
  tokens.

Tolerances: 2e-5 for the attention functions, as tests/test_kernels.py;
1e-5 for the model's logits."""
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import paged_decode_attention_fwd
from repro.kernels.decode_attention.ops import decode_attention_mixed as jax_mixed
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import mamba_lm as jax_mamba_lm
from repro_torch.kernels.decode_attention.ops import (
    _split_runs, choose_pages_per_split, live_pages, paged_decode_attention_plain,
    paged_decode_attention_split_plain, paged_mixed_attention_plain,
    paged_mixed_attention_split_plain, split_plan,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain
from repro_torch.models import mamba_lm

from _torch_helpers import flash_inputs, jax_tree_from_torch, mixed_inputs

ATT_TOL = dict(atol=2e-5, rtol=2e-5)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax_mixed(q, kp, vp, ks, vs, tbl, starts, window):
    j = [None if a is None else jnp.asarray(a) for a in (q, kp, vp, ks, vs, tbl, starts)]
    return np.asarray(jax_mixed(j[0], j[1], j[2], j[5], j[6], window=window,
                                k_scale=j[3], v_scale=j[4]))


# ---------------------------------------------------------------------------------
# (a) the two-pass arithmetic
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("pps", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_split_plain_matches_plain_and_jax(int8, window, pps):
    """Every split size from one page to the whole table (n = 6): rows start
    at 0 (a single live page of 4 keys), 5 and 13, T = 4, group 3."""
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(3, int8, n=6)
    assert live_pages(int(starts[0]), 4, 4, 6, window) == (0, 1)   # one live page
    t = _torch((q, kp, vp, ks, vs, tbl, starts))
    sc = dict(k_scale=t[3], v_scale=t[4])
    out = paged_mixed_attention_split_plain(t[0], t[1], t[2], t[5], t[6], window=window,
                                            pages_per_split=pps, **sc)
    plain = paged_mixed_attention_plain(t[0], t[1], t[2], t[5], t[6], window=window, **sc)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **ATT_TOL)
    np.testing.assert_allclose(out.numpy(),
                               _jax_mixed(q, kp, vp, ks, vs, tbl, starts, window), **ATT_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_split_with_no_visible_key_adds_nothing(int8):
    """Window 3 over 4-token pages: row 2 (start 13, queries 13..16) has the
    live page of keys 8..11 because query 13 sees key 11, but query 16 sees
    none of it.  With one page per split that query's partial there has
    l = 0 and must leave its result unchanged."""
    T, ps, window = 4, 4, 3
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(2, int8)
    start = int(starts[2])
    lo, hi = live_pages(start, T, ps, 6, window)
    q_last = start + T - 1
    assert lo == 2 and all(not (k > q_last - window) for k in range(8, 12))
    t = _torch((q, kp, vp, ks, vs, tbl, starts))
    sc = dict(k_scale=t[3], v_scale=t[4])
    one = paged_mixed_attention_split_plain(t[0], t[1], t[2], t[5], t[6], window=window,
                                            pages_per_split=1, **sc)
    whole = paged_mixed_attention_split_plain(t[0], t[1], t[2], t[5], t[6], window=window,
                                              pages_per_split=6, **sc)
    assert torch.isfinite(one).all()
    np.testing.assert_allclose(one.numpy(), whole.numpy(), **ATT_TOL)
    np.testing.assert_allclose(one.numpy(),
                               _jax_mixed(q, kp, vp, ks, vs, tbl, starts, window), **ATT_TOL)


@pytest.mark.parametrize("window", [-1, 40])
@pytest.mark.parametrize("group,T", [(3, 16), (8, 1)])
def test_split_plain_at_serving_page_size(group, T, window):
    """16-token pages and a 64-entry table, as the engine keeps them at
    max_len 1024: the wrapper's own split size (4 pages) and the kernel's
    head dims 64 / 128."""
    D = 64 if group == 3 else 128
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(group, False, T=T, D=D, ps=16, n=64,
                                                  starts=[0, 1024 - T, 300, 17])
    pps = choose_pages_per_split(4, 2, 64, 16, 132)
    assert pps == 4
    t = _torch((q, kp, vp, ks, vs, tbl, starts))
    out = paged_mixed_attention_split_plain(t[0], t[1], t[2], t[5], t[6], window=window,
                                            pages_per_split=pps)
    plain = paged_mixed_attention_plain(t[0], t[1], t[2], t[5], t[6], window=window)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **ATT_TOL)


# rows of the decode tests: lengths 1 (one key: every other split of the row
# holds none), 8 and 16 (the live range ends on a page and on a split
# boundary at 2 and 4 pages a split), 14 and 24 (the whole 6-page table)
DECODE_LENGTHS = [1, 8, 14, 16, 24]


@functools.lru_cache(maxsize=None)
def _decode_case(int8: bool, window: int):
    """Inputs (4-token pages, a 6-entry table, group 3) and the JAX Pallas
    decode kernel's output in interpret mode."""
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(3, int8, T=1, n=6,
                                                  starts=[x - 1 for x in DECODE_LENGTHS])
    lengths = starts + 1
    j = [None if a is None else jnp.asarray(a) for a in (q[:, 0], kp, vp, ks, vs, tbl, lengths)]
    ref = np.asarray(paged_decode_attention_fwd(j[0], j[1], j[2], j[5], j[6],
                                                jnp.array([window], jnp.int32),
                                                k_scale=j[3], v_scale=j[4], interpret=True))
    return (q, kp, vp, ks, vs, tbl, lengths), ref


@pytest.mark.parametrize("pps", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("window", [-1, 3, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_split_plain_matches_jax_decode_kernel(int8, window, pps):
    """The bf16 decode kernel's two passes (pass 1 per split of ``pps``
    pages, the mixed kernel's merge) against the Pallas decode kernel, at
    every split size from one page to the whole table: window 3 starts
    inside a page, window 8 on a page boundary."""
    arrays, ref = _decode_case(int8, window)
    q, kp, vp, ks, vs, tbl, lengths = _torch(arrays)
    sc = dict(k_scale=ks, v_scale=vs)
    out = paged_decode_attention_split_plain(q, kp, vp, tbl, lengths, window=window,
                                             pages_per_split=pps, **sc)
    assert out.shape == q.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy()[:, 0], ref, **ATT_TOL)
    plain = paged_decode_attention_plain(q, kp, vp, tbl, lengths, window=window, **sc)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **ATT_TOL)


def test_decode_split_runs_hold_only_live_keys():
    """The decode kernel's live ranges at T = 1 (``starts = lengths - 1``),
    split at 2 pages a split: a row of one key has one live split, so every
    other split of its row exits without reading; a live range ending on a
    split boundary ends there."""
    ps, n, pps = 4, 6, 2
    runs = [_split_runs(*live_pages(x - 1, 1, ps, n, -1), pps) for x in DECODE_LENGTHS]
    assert runs[0] == [(0, 1)]                        # length 1
    assert runs[1] == [(0, 2)]                        # length 8: pages 0-1, split 0
    assert runs[3] == [(0, 2), (2, 4)]                # length 16: ends on split 1's end
    assert [p for lo, hi in runs[4] for p in range(lo, hi)] == list(range(6))
    # window 8 (two pages) at length 16: keys 8..15, pages 2-3, split 1 alone
    assert _split_runs(*live_pages(15, 1, ps, n, 8), pps) == [(2, 4)]
    assert choose_pages_per_split(8, 3, 64, 16, 132) == 4   # the phase-3 decode shape


# ---------------------------------------------------------------------------------
# (b) the split plan
# ---------------------------------------------------------------------------------

def _live_by_rule(start, T, ps, n, window):
    """Pages any query of the span can see, by the TPU kernel's test."""
    live = set()
    for p in range(n):
        k_start = p * ps
        ok = k_start < start + T
        if window > 0:
            ok = ok and k_start + ps - 1 >= start + 1 - window
        if ok:
            live.add(p)
    return live


@pytest.mark.parametrize("seed", range(6))
def test_split_plan_covers_live_pages_exactly_once(seed):
    rng = np.random.default_rng(seed)
    ps = int(rng.choice([4, 8, 16]))
    n = int(rng.integers(1, 80))
    T = int(rng.integers(1, min(17, n * ps) + 1))
    B = int(rng.integers(1, 9))
    starts = rng.integers(0, n * ps - T + 1, B)
    window = int(rng.choice([-1, 1, 3, 17, 100, 5000]))
    sm = int(rng.choice([4, 132]))
    pps, runs = split_plan(starts, T, ps, n, window, sm, n_kv_heads=int(rng.integers(1, 5)))
    assert 1 <= pps <= max(n, 1)
    for start, row in zip(starts, runs):
        pages = [p for lo, hi in row for p in range(lo, hi)]
        assert len(pages) == len(set(pages))                       # exactly once
        assert set(pages) == _live_by_rule(int(start), T, ps, n, window)
        for lo, hi in row:                                         # one split each
            assert lo < hi and lo // pps == (hi - 1) // pps


def test_pages_per_split_fills_the_card_at_the_serving_shape():
    """smollm-135m's chunked path: 8 rows, 3 kv heads, a 64-page table of
    16-token pages -> 4 pages (64 keys) a split, 16 splits, 384 blocks for
    132 SMs; fewer rows or heads never go below 64 keys a split."""
    assert choose_pages_per_split(8, 3, 64, 16, 132) == 4
    assert 8 * 3 * 16 >= 2 * 132
    assert choose_pages_per_split(1, 1, 64, 16, 132) == 4
    assert choose_pages_per_split(64, 8, 64, 16, 132) == 64
    assert choose_pages_per_split(2, 2, 2, 16, 132) == 2


# ---------------------------------------------------------------------------------
# (c) flash attention at head dim 80
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("window", [-1, 5])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_plain_head_dim_80_matches_jax(group, window):
    q, k, v = flash_inputs(group, D=80, S=48)
    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    ref_kernel = np.asarray(flash_attention_fwd(
        jq, jk, jv, jnp.array([window], jnp.int32), block_q=16, block_k=16,
        interpret=True)).transpose(0, 2, 1, 3)
    ref = np.asarray(attention_ref(jq, jk, jv, window)).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, window)
    np.testing.assert_allclose(out.numpy(), ref_kernel, **ATT_TOL)
    np.testing.assert_allclose(out.numpy(), ref, **ATT_TOL)
    assert torch.equal(flash_attention_dyn(tq, tk, tv, window), out)


# ---------------------------------------------------------------------------------
# (d) zamba2 with head dim 80
# ---------------------------------------------------------------------------------

def _zamba80_pair():
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    jc = dataclasses.replace(jax_smoke_config("zamba2-2.7b"), d_model=160, n_heads=2,
                             n_kv_heads=2, dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke_config("zamba2-2.7b"), d_model=160, n_heads=2,
                             n_kv_heads=2, dtype=torch.float32)
    tp = build_model(tc, device="cpu").init_params(0)
    return jc, tc, jax_build(jc), jax_tree_from_torch(tp), tp


@pytest.mark.parametrize("S", [13, 40])
def test_zamba_head_dim_80_prefill_decode_matches_jax(S):
    """Model-level prefill (the shared attention through the flash route)
    and four decode steps at a scalar position: greedy tokens equal, logits
    within 1e-5."""
    jc, tc, _, jp, tp = _zamba80_pair()
    assert tc.resolved_head_dim == 80
    toks = np.random.default_rng(11).integers(0, jc.vocab, (2, S)).astype(np.int32)
    jit = jax.jit
    jlog, jcache = jit(partial(jax_mamba_lm.prefill, cfg=jc, max_len=S + 4))(
        jp, {"tokens": jnp.asarray(toks)})
    tlog, tcache = mamba_lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                                    max_len=S + 4)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=1e-5)
    jdecode = jit(partial(jax_mamba_lm.decode_step, cfg=jc))
    jt, tt = [], []
    jtok = np.asarray(jlog[:, 0].argmax(-1))[:, None].astype(np.int32)
    ttok = tlog[:, 0].argmax(-1)[:, None]
    for i in range(4):
        jt.append(jtok[:, 0].copy())
        tt.append(ttok[:, 0].numpy().copy())
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(jtok), jnp.int32(S + i))
        tlog, tcache = mamba_lm.decode_step(tp, tcache, ttok, S + i, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=1e-5)
        jtok = np.asarray(jlog[:, 0].argmax(-1))[:, None].astype(np.int32)
        ttok = tlog[:, 0].argmax(-1)[:, None]
    jt.append(jtok[:, 0])
    tt.append(ttok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(tt, 1), np.stack(jt, 1))
