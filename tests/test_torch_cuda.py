"""PyTorch port on the card: each CUDA kernel against its plain version, and
the serving engine on the card against the same engine on the CPU.  Every
test here carries the ``cuda`` marker and skips without a CUDA device; on
the GPU machine run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: that machine has none."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import (
    _sm_count, choose_dense_pages_per_split, decode_attention, decode_attention_mixed,
    decode_attention_paged, decode_attention_plain, decode_attention_split_plain,
    dense_live_pages, paged_decode_attention_plain, paged_mixed_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain
from repro_torch.kernels.sampling.ops import (
    _epilogue_kernel, fused_lmhead_greedy, greedy_cluster_plan, greedy_epilogue,
    greedy_epilogue_plain, greedy_epilogue_split_plain, greedy_max_cluster, lmhead_greedy_plain,
    lmhead_greedy_walk_plain,
)
from repro_torch.kernels.ssd.ops import ssd_intra, ssd_intra_grouped_plain, ssd_intra_plain
from repro_torch.models.attention import mha_decode

from _torch_helpers import (
    DENSE_DECODE_SHAPES, dense_decode_inputs, flash_inputs, lmhead_inputs, logits_inputs,
    mixed_inputs, require_cuda, ssd_inputs, tree_to,
)


# ---------------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [-1, 3])
def test_mixed_attention_kernel_matches_plain(dtype, window):
    dev = require_cuda()
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(3, dtype == "int8", D=64, ps=16,
                                                   n=4, T=16)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    args = [torch.from_numpy(q).to(dev, qdt)]
    if dtype == "int8":
        args += [torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)]
        sc = dict(k_scale=torch.from_numpy(ks).to(dev), v_scale=torch.from_numpy(vs).to(dev))
    else:
        args += [torch.from_numpy(kp).to(dev, qdt), torch.from_numpy(vp).to(dev, qdt)]
        sc = {}
    args += [torch.from_numpy(tbl).to(dev), torch.from_numpy(starts).to(dev)]
    before = decode_attention_mixed.launches
    out = decode_attention_mixed(*args, window=window, **sc)
    torch.cuda.synchronize()
    assert decode_attention_mixed.launches == before + 1
    ref = paged_mixed_attention_plain(*args, window=window, **sc)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "tie"])
def test_lmhead_kernel_matches_plain(dtype, kind):
    dev = require_cuda()
    h, w = lmhead_inputs(kind, N=130, d=64, V=4099)
    dt = getattr(torch, dtype)
    ht = torch.from_numpy(h).to(dev, dt)
    emb = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev, dt)
    tok, lp = fused_lmhead_greedy(ht, emb.T)
    torch.cuda.synchronize()
    tok_p, lp_p = lmhead_greedy_plain(ht, emb.T)
    logits = ht.float() @ emb.T.float()
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    if kind == "tie":
        clear = torch.ones_like(clear)       # integer logits: exact, ties included
    assert torch.equal(tok[clear], tok_p[clear])
    torch.testing.assert_close(lp, lp_p, atol=1e-3, rtol=0)


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [-1, 5, 100])
@pytest.mark.parametrize("group,S,D", [(1, 16, 16), (3, 100, 64), (2, 200, 128),
                                       (2, 70, 256)])
def test_flash_attention_kernel_matches_plain(dtype, window, group, S, D):
    """Buckets smaller than the 64-row tile, ragged last tiles, every head
    dim the kernel is built for; q/k/v read through strides (a transposed
    view of (B, H, S, D))."""
    dev = require_cuda()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in flash_inputs(group, S=S, D=D))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)     # (B, S, H, D) strides of (B, H, S, D)
    before = flash_attention_dyn.launches
    out = flash_attention_dyn(qs, k, v, window)
    torch.cuda.synchronize()
    assert flash_attention_dyn.launches == before + 1
    ref = flash_attention_plain(q, k, v, window)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [-1, 5, 100])
@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("group,S", [(1, 100), (3, 200), (8, 513)])
def test_flash_attention_kernel_every_head_dim(dtype, window, D, group, S):
    """Every head dim the kernel is built for (80: zamba2's shared
    attention), S off the 64-row tile, windows inside one tile and across
    several, GQA groups 1 / 3 / 8."""
    dev = require_cuda()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in flash_inputs(group, S=S, D=D))
    before = flash_attention_dyn.launches
    out = flash_attention_dyn(q, k, v, window)
    torch.cuda.synchronize()
    assert flash_attention_dyn.launches == before + 1
    ref = flash_attention_plain(q, k, v, window)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
def test_flash_attention_rejects_unsupported_head_dim():
    dev = require_cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in flash_inputs(1, S=64, D=48))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_dyn(q, k, v, -1)


# (n, starts) of 16-token pages: a 4-entry table (64 keys: one split a
# row) and a 64-entry one (4 pages a split, 16 splits) with rows of 1, 32
# and 64 live pages
SPLIT_TABLES = {"one split": (4, [0, 64 - 16, 30]), "many splits": (64, [0, 1024 - 16, 500])}


def _check_split_kernel(T, group, D, dtype, window, n, starts, one_split):
    """The bf16 split-K kernel against its plain version on a seeded pool
    of 16-token pages, 2 kv heads; ``one_split`` says which plan the
    wrapper must make from the table."""
    from repro_torch.kernels.decode_attention.ops import choose_pages_per_split
    dev = require_cuda()
    pps = choose_pages_per_split(len(starts), 2, n, 16,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (pps >= n) == one_split
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(group, dtype == "int8", T=T, D=D, ps=16,
                                                   n=n, starts=starts)
    args = [torch.from_numpy(q).to(dev, torch.bfloat16)]
    if dtype == "int8":
        args += [torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)]
        sc = dict(k_scale=torch.from_numpy(ks).to(dev), v_scale=torch.from_numpy(vs).to(dev))
    else:
        args += [torch.from_numpy(kp).to(dev, torch.bfloat16),
                 torch.from_numpy(vp).to(dev, torch.bfloat16)]
        sc = {}
    args += [torch.from_numpy(tbl).to(dev), torch.from_numpy(starts).to(dev)]
    before = decode_attention_mixed.launches
    out = decode_attention_mixed(*args, window=window, **sc)
    torch.cuda.synchronize()
    assert decode_attention_mixed.launches == before + 1
    ref = paged_mixed_attention_plain(*args, window=window, **sc)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("table", list(SPLIT_TABLES))
@pytest.mark.parametrize("window", [-1, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("group,D", [(2, 256), (3, 64), (8, 128)])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_mixed_attention_split_kernel_matches_plain(T, group, D, dtype, window, table):
    """The bf16 split-K kernel against its plain version: every split plan
    the wrapper makes from these tables, one split a row and many."""
    n, starts = SPLIT_TABLES[table]
    _check_split_kernel(T, group, D, dtype, window, n, starts, table == "one split")


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["one split", "many splits"])
@pytest.mark.parametrize("window", [-1, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("T,group,D", [(32, 8, 128), (48, 3, 64)])
def test_mixed_attention_split_kernel_row_tiles(T, group, D, dtype, window, table):
    """More than 128 query rows a kv head (T * group 256 and 144: chunk 32
    on qwen2.5-3b's heads, chunk 48 on smollm-135m's), so pass 1 runs two
    row tiles a (row, kv head) and the second is ragged at 144."""
    n = 4 if table == "one split" else 64
    starts = [0, n * 16 - T, (n * 16 - T) // 2]
    _check_split_kernel(T, group, D, dtype, window, n, starts, table == "one split")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("ps", [4, 16])
def test_paged_decode_kernel_matches_plain_and_mixed(dtype, window, ps):
    """One query per row; at T = 1 the decode kernel equals the mixed kernel
    with starts = lengths - 1."""
    dev = require_cuda()
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(3, dtype == "int8", D=64, ps=ps,
                                                   n=8, T=1)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qt = torch.from_numpy(q).to(dev, qdt)
    if dtype == "int8":
        pages = [torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)]
        sc = dict(k_scale=torch.from_numpy(ks).to(dev), v_scale=torch.from_numpy(vs).to(dev))
    else:
        pages = [torch.from_numpy(kp).to(dev, qdt), torch.from_numpy(vp).to(dev, qdt)]
        sc = {}
    tbl_t = torch.from_numpy(tbl).to(dev)
    lengths = torch.from_numpy(starts).to(dev) + 1
    before = decode_attention_paged.launches
    out = decode_attention_paged(qt, *pages, tbl_t, lengths, window=window, **sc)
    torch.cuda.synchronize()
    assert decode_attention_paged.launches == before + 1
    ref = paged_decode_attention_plain(qt, *pages, tbl_t, lengths, window=window, **sc)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))
    mixed = decode_attention_mixed(qt, *pages, tbl_t, lengths - 1, window=window, **sc)
    torch.testing.assert_close(out.float(), mixed.float(), atol=_tol(dtype), rtol=_tol(dtype))


def _decode_args(dev, dtype, group, Hkv, D, ps, n, lengths, seed=0):
    """bf16 q with bf16 or int8 pages of a seeded pool, the table, lengths."""
    q, kp, vp, ks, vs, tbl, starts = mixed_inputs(group, dtype == "int8", T=1, Hkv=Hkv, D=D,
                                                   ps=ps, n=n, starts=[x - 1 for x in lengths],
                                                   seed=seed)
    args = [torch.from_numpy(q).to(dev, torch.bfloat16)]
    if dtype == "int8":
        args += [torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)]
        sc = dict(k_scale=torch.from_numpy(ks).to(dev), v_scale=torch.from_numpy(vs).to(dev))
    else:
        args += [torch.from_numpy(kp).to(dev, torch.bfloat16),
                 torch.from_numpy(vp).to(dev, torch.bfloat16)]
        sc = {}
    args += [torch.from_numpy(tbl).to(dev), torch.from_numpy(starts).to(dev) + 1]
    return args, sc


def _check_decode_split(args, sc, window):
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, choose_pages_per_split, paged_decode_attention_split_plain)
    before = decode_attention_paged.launches
    out = decode_attention_paged(*args, window=window, **sc)
    torch.cuda.synchronize()
    assert decode_attention_paged.launches == before + 1       # both passes: one launch
    assert torch.isfinite(out).all()
    ref = paged_decode_attention_plain(*args, window=window, **sc)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    q, kp, _, tbl, _ = args
    pps = choose_pages_per_split(q.shape[0], kp.shape[2], tbl.shape[1], kp.shape[1],
                                 _sm_count(q.device.index or 0))
    split = paged_decode_attention_split_plain(*args, window=window, pages_per_split=pps, **sc)
    torch.testing.assert_close(out.float(), split.float(), atol=2e-2, rtol=2e-2)


# lengths of the bucketed decode shape: 64 and 128 end on a split boundary
# (4 pages of 16 a split), 1 holds one key, the rest end inside a page
DECODE_LENGTHS = [64, 97, 1, 255, 128, 448, 512, 640]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [-1, 64, 7])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_paged_decode_split_kernel_matches_plain(B, dtype, window):
    """The bf16 split-K decode kernel at smollm-135m's decode shape (9/3
    heads of 64, 16-token pages, a 64-entry table) for the power-of-two
    batches the bucketed engine compacts to; window 7 starts inside a page,
    64 on a page boundary."""
    dev = require_cuda()
    args, sc = _decode_args(dev, dtype, 3, 3, 64, 16, 64, DECODE_LENGTHS[:B], seed=B)
    _check_decode_split(args, sc, window)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [-1, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("Hq,Hkv,D", [(16, 2, 128), (8, 4, 256), (32, 32, 80), (4, 2, 16),
                                      (6, 2, 32), (32, 2, 64), (24, 3, 64)])
def test_paged_decode_split_kernel_head_shapes(Hq, Hkv, D, dtype, window):
    """Every head dim the kernel is built for and groups 1 .. 16: qwen2.5-3b
    (16 / 2 x 128), gemma3-4b (8 / 4 x 256), zamba2-2.7b's attention width
    (32 / 32 x 80); groups 16 and 8 take several query-head tiles (two of 8
    at bf16, four and two of 4 at int8)."""
    dev = require_cuda()
    args, sc = _decode_args(dev, dtype, Hq // Hkv, Hkv, D, 16, 32, [1, 100, 257, 512], seed=D)
    _check_decode_split(args, sc, window)


@pytest.mark.cuda
def test_paged_decode_rejects_unsupported_bf16_inputs():
    dev = require_cuda()
    args, sc = _decode_args(dev, "bfloat16", 2, 2, 48, 16, 4, [5, 17])
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_paged(*args, **sc)
    args, sc = _decode_args(dev, "bfloat16", 2, 2, 64, 16, 4, [5, 17])
    q = args[0]
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    args[0] = flat[1:].view(q.shape).copy_(q)                 # 2 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention_paged(*args, **sc)


def _lmhead_bf16(dev, N, d, V, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((N, d), generator=g, device=dev).bfloat16()
    emb = (torch.randn((V, d), generator=g, device=dev) * 0.02).bfloat16()
    return h, emb


def _check_lmhead(h, w):
    before = fused_lmhead_greedy.launches
    tok, lp = fused_lmhead_greedy(h, w)
    torch.cuda.synchronize()
    assert fused_lmhead_greedy.launches == before + 1
    tok_p, lp_p = lmhead_greedy_plain(h, w)
    top2 = (h.float() @ w.float()).topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4             # summation order differs
    assert clear.float().mean() > 0.9
    assert torch.equal(tok[clear], tok_p[clear])
    torch.testing.assert_close(lp, lp_p, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("N,d,V", [(128, 576, 49152), (130, 576, 4104), (8, 576, 49152),
                                   (128, 2048, 151936), (256, 2048, 151936),
                                   (130, 2560, 4104), (17, 48, 256)])
def test_lmhead_bf16_kernel_widths_and_layouts(N, d, V, tied):
    """The bf16 tensor-core lm-head at smollm-135m's (d 576, V 49152) and
    qwen2.5-3b's widths (d 2048, V 151936; N 128 and 256, two row tiles),
    d 2560, ragged N and V, and the smoke width d 48;
    the tied head (``embed.T``) and the untied (d, V) one."""
    dev = require_cuda()
    h, emb = _lmhead_bf16(dev, N, d, V, seed=N + d)
    _check_lmhead(h, emb.T if tied else emb.T.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", [(130, 4099), (8, 151936)])
def test_lmhead_bf16_ragged_vocab_tied(N, V):
    """V off the 128-column tile and off 8 (tied head only): the last tile's
    missing columns never enter the max or the sum."""
    dev = require_cuda()
    h, emb = _lmhead_bf16(dev, N, 576, V, seed=V)
    _check_lmhead(h, emb.T)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("N", [16, 256])
def test_lmhead_bf16_ties_across_blocks(N, tied):
    """Exact maxima (integer inputs) in the tiles of two different
    persistent blocks: the first maximal index wins, as in the plain
    version and in the plain version of the kernel's walk."""
    from repro_torch.kernels.sampling.ops import _kernel, _sm_count
    dev = require_cuda()
    d, V = 576, 49152
    g = torch.Generator(device=dev).manual_seed(N)
    h = torch.randint(-2, 3, (N, d), generator=g, device=dev).bfloat16()
    emb = torch.randint(-1, 2, (V, d), generator=g, device=dev).bfloat16()
    emb[200] = emb[40000] = torch.sign(h[0].float()).bfloat16()    # tiles 1 and 312
    w = emb.T if tied else emb.T.contiguous()
    tok, lp = fused_lmhead_greedy(h, w)
    torch.cuda.synchronize()
    tok_p, lp_p = lmhead_greedy_plain(h, w)
    blocks = _kernel()[1](1, N, V, _sm_count(dev.index or 0))
    assert (200 // 128) % blocks != (40000 // 128) % blocks      # two different blocks
    tok_w, _ = lmhead_greedy_walk_plain(h, w, n_blocks=blocks)
    assert tok[0].item() == 200
    assert torch.equal(tok, tok_p) and torch.equal(tok, tok_w)
    torch.testing.assert_close(lp, lp_p, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_lmhead_bf16_rejects_unsupported_inputs():
    dev = require_cuda()
    h, emb = _lmhead_bf16(dev, 8, 24, 256, seed=0)
    with pytest.raises(ValueError, match="unsupported"):
        fused_lmhead_greedy(h, emb.T)                          # d % 16
    h, emb = _lmhead_bf16(dev, 8, 64, 4099, seed=0)
    with pytest.raises(ValueError, match="unsupported"):
        fused_lmhead_greedy(h, emb.T.contiguous())             # untied, V % 8
    flat = torch.empty(emb.numel() + 1, dtype=emb.dtype, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fused_lmhead_greedy(h, flat[1:].view(emb.shape).copy_(emb).T)
    with pytest.raises(TypeError):
        fused_lmhead_greedy(h, emb.T.float())


def _greedy_logits(kind, B, V, dtype, layout, dev):
    """(B, V) logits on the card as ``layout`` lays them out: "contiguous";
    "strided", the last of three positions of a (B, 3, V) tensor, as the
    dense-cache engine passes ``logits[:, -1]``; "unaligned", rows that
    start one element past a 16-byte boundary.  (Contiguous rows at V 999
    and 4099 start off the boundary from row 1 on.)"""
    x = torch.from_numpy(logits_inputs(kind, B=B, V=V)).to(dev, dtype)
    if layout == "strided":
        full = torch.zeros((B, 3, V), dtype=dtype, device=dev)
        full[:, -1] = x
        return full[:, -1]
    if layout == "unaligned":
        full = torch.zeros((B, V + 1), dtype=dtype, device=dev)
        full[:, 1:] = x
        return full[:, 1:]
    return x


GREEDY_VOCABS = [999, 4099, 32000, 49152, 50280, 151936, 262144]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 9, 33])
@pytest.mark.parametrize("kind", ["normal", "tie"])
@pytest.mark.parametrize("V", GREEDY_VOCABS)
def test_greedy_epilogue_kernel_matches_plain(kind, V, B, dtype, layout):
    dev = require_cuda()
    x = _greedy_logits(kind, B, V, dtype, layout, dev)
    before = greedy_epilogue.launches
    tok, lp = greedy_epilogue(x)
    torch.cuda.synchronize()
    assert greedy_epilogue.launches == before + 1
    tok_p, lp_p = greedy_epilogue_plain(x)
    assert torch.equal(tok, tok_p)
    torch.testing.assert_close(lp, lp_p, atol=1e-4, rtol=0)
    assert (lp <= 0).all()
    if kind == "tie":
        assert tok[0].item() == 3 and (B == 1 or tok[1].item() == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 9, 33])
@pytest.mark.parametrize("V", GREEDY_VOCABS)
def test_greedy_epilogue_kernel_matches_split_plain(V, B, dtype):
    """The kernel against the plain version of its own order of work at its
    own plan (C ranks a row, slices merged in rank order), with exact maxima
    at the last logit of rank 0, the first of rank 1 and the row's last: the
    first of them wins."""
    dev = require_cuda()
    C, width, _ = greedy_cluster_plan(B, V, _sm_count(dev.index or 0),
                                      greedy_max_cluster(dev.index or 0), dtype.itemsize)
    x = torch.from_numpy(logits_inputs("normal", B=B, V=V)).to(dev, dtype)
    x[0, min(width, V) - 1] = x[0, min(width, V - 1)] = x[0, V - 1] = 40.0
    before = greedy_epilogue.launches
    tok, lp = greedy_epilogue(x)
    torch.cuda.synchronize()
    assert greedy_epilogue.launches == before + 1
    tok_s, lp_s = greedy_epilogue_split_plain(x, C)
    assert torch.equal(tok, tok_s) and tok[0].item() == min(width, V) - 1
    torch.testing.assert_close(lp, lp_s, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("V", GREEDY_VOCABS)
def test_greedy_epilogue_both_cta_sizes_match_plain(V, B, dtype, layout, threads):
    """Both CTA sizes the plan picks from (256 threads, and 512 where half
    the SMs or more would idle), each at every shape through the kernel's C
    entry, at the wrapper's clusters and slices: tokens equal, logprob
    within 1e-4."""
    dev = require_cuda()
    x = _greedy_logits("normal", B, V, dtype, layout, dev)
    C, width, _ = greedy_cluster_plan(B, V, _sm_count(dev.index or 0),
                                      greedy_max_cluster(dev.index or 0), dtype.itemsize)
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    lp = torch.empty((B,), device=dev)
    err = _epilogue_kernel()[0](int(dtype == torch.bfloat16), x.data_ptr(), x.stride(0), B, V,
                                C, width, threads, tok.data_ptr(), lp.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    tok_p, lp_p = greedy_epilogue_plain(x)
    assert torch.equal(tok, tok_p)
    torch.testing.assert_close(lp, lp_p, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_greedy_epilogue_rejects_other_dtypes():
    dev = require_cuda()
    before = greedy_epilogue.launches
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            greedy_epilogue(torch.zeros((2, 64), dtype=dtype, device=dev))
    with pytest.raises(TypeError):
        greedy_epilogue(torch.zeros((2, 3, 64), device=dev))
    assert greedy_epilogue.launches == before


@pytest.mark.cuda
def test_bucketed_engine_on_card_matches_cpu():
    """chunked_prefill=False at float32: identical greedy tokens from the
    flash, paged-decode and greedy-epilogue kernels on the card and the
    plain versions on the CPU, every new kernel launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    require_cuda()
    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), dtype=torch.float32)
    cpu_params = build_model(cfg, device="cpu").init_params(0)
    counters = (flash_attention_dyn, decode_attention_paged, greedy_epilogue)
    outs = {}
    for where in ("cpu", "cuda"):
        eng = ServingEngine(build_model(cfg, device=where), tree_to(cpu_params, where),
                            ServeConfig(max_batch=4, max_len=64, page_size=8,
                                        chunked_prefill=False), device=where)
        rng = np.random.default_rng(1)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 40))),
                               max_new_tokens=int(rng.integers(1, 16))))
        before = [c.launches for c in counters]
        eng.run_until_drained()
        eng.kv.check_invariants()
        if where == "cuda":
            assert all(c.launches > b for c, b in zip(counters, before))
        outs[where] = {r.rid: (r.output, r.score) for r in eng.completed}
    assert {r: o for r, (o, _) in outs["cuda"].items()} == \
           {r: o for r, (o, _) in outs["cpu"].items()}
    for rid, (_, score) in outs["cpu"].items():
        assert abs(outs["cuda"][rid][1] - score) < 1e-4


@pytest.mark.cuda
def test_forward_on_card_matches_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    dev = require_cuda()
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 37)))
    ref, _ = model.forward(params, {"tokens": tokens})
    out, _ = build_model(cfg, device=dev).forward(tree_to(params, dev),
                                                  {"tokens": tokens.to(dev)})
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu():
    """Smoke config at float32: identical greedy tokens from the kernels on
    the card and the plain versions on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    require_cuda()
    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), dtype=torch.float32)
    cpu_params = build_model(cfg, device="cpu").init_params(0)
    outs = {}
    for where in ("cpu", "cuda"):
        eng = ServingEngine(build_model(cfg, device=where), tree_to(cpu_params, where),
                            ServeConfig(max_batch=4, max_len=64, page_size=8,
                                        chunk_size=8, draft_len=4), device=where)
        rng = np.random.default_rng(1)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 24))),
                               max_new_tokens=int(rng.integers(4, 16))))
        eng.run_until_drained()
        eng.kv.check_invariants()
        outs[where] = {r.rid: (r.output, r.score) for r in eng.completed}
    assert {r: o for r, (o, _) in outs["cuda"].items()} == \
           {r: o for r, (o, _) in outs["cpu"].items()}
    for rid, (_, score) in outs["cpu"].items():
        assert abs(outs["cuda"][rid][1] - score) < 1e-4


# ---------------------------------------------------------------------------------
# the ssm path: the SSD intra-chunk kernel and the dense decode-attention kernel
# ---------------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("b,nc,q,h,p,n,groups", [
    (1, 2, 256, 4, 64, 128, 1),      # mamba2-1.3b chunk and state widths
    (1, 1, 256, 64, 64, 128, 1),     # a mamba2-1.3b prefill of <= 256 tokens
    (2, 3, 40, 4, 16, 16, 2),        # ragged tiles, two groups
    (1, 2, 8, 8, 16, 16, 1),         # the smoke configs' chunk
    (1, 1, 130, 2, 96, 40, 1),       # p over one tile, n over one slice
])
def test_ssd_intra_kernel_matches_plain(b, nc, q, h, p, n, groups, view):
    """Against the plain version at f32, with Bh/Ch materialised by
    repeat_interleave or, for one group, an expand view (zero head stride).
    Tolerance: 1e-5 of the output's largest magnitude (f32 sums over up to
    q * n products in another order)."""
    dev = require_cuda()
    xb, acs, Bq, Cq = (torch.from_numpy(a).to(dev)
                       for a in ssd_inputs(b, nc, q, h, p, n, groups))
    rep = h // groups
    if view and groups == 1:
        Bh, Ch = Bq.expand(b, nc, q, h, n), Cq.expand(b, nc, q, h, n)
    else:
        Bh, Ch = Bq.repeat_interleave(rep, dim=3), Cq.repeat_interleave(rep, dim=3)
    before = ssd_intra.launches
    out = ssd_intra(xb, acs, Bh, Ch)
    torch.cuda.synchronize()
    assert ssd_intra.launches == before + 1
    ref = ssd_intra_plain(xb, acs, Bh, Ch)
    assert torch.isfinite(out).all()
    scale = ref.abs().max().item()
    torch.testing.assert_close(out, ref, atol=1e-5 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("view", [True, False])
@pytest.mark.parametrize("b,nc,q,h,p,n,groups", [
    (4, 2, 256, 80, 64, 64, 1),      # zamba2-2.7b's prefill (phase 5e)
    (1, 1, 200, 64, 64, 128, 1),     # mamba2-1.3b, nc 1, q not a multiple of 64
    (2, 3, 40, 4, 16, 16, 2),        # ragged, two materialised groups
])
def test_ssd_intra_kernel_matches_grouped_plain(b, nc, q, h, p, n, groups, view):
    """Against the plain version of its two passes (scores once per group,
    then each head's decay and P x), given the group tensors, and against
    the one-pass plain version, at f32.  Tolerance: 1e-5 of the output's
    largest magnitude (f32 sums in another order than cuBLAS's)."""
    dev = require_cuda()
    xb, acs, Bq, Cq = (torch.from_numpy(a).to(dev)
                       for a in ssd_inputs(b, nc, q, h, p, n, groups))
    rep = h // groups
    if view and groups == 1:
        Bh, Ch = Bq.expand(b, nc, q, h, n), Cq.expand(b, nc, q, h, n)
    else:
        Bh, Ch = Bq.repeat_interleave(rep, dim=3), Cq.repeat_interleave(rep, dim=3)
    out = ssd_intra(xb, acs, Bh, Ch)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for ref in (ssd_intra_grouped_plain(xb, acs, Bq, Cq), ssd_intra_plain(xb, acs, Bh, Ch)):
        scale = ref.abs().max().item()
        torch.testing.assert_close(out, ref, atol=1e-5 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,pos,window", [
    (1, 4096, 2, 1, 64, 4000, None),     # B x Hkv = 1, far fewer than the splits
    (1, 4096, 8, 4, 256, 3000, 1024),    # gemma3's local layers, one row
    (2, 1000, 4, 2, 80, 999, 100),       # S not a multiple of the 64-key page
])
def test_dense_decode_split_kernel_matches_split_plain(B, S, Hq, Hkv, D, pos, window):
    """The bf16 split-K kernel against the plain version of its two passes
    at the split the wrapper picks, and against the one-pass plain version.
    Tolerance: 2e-2, bf16 outputs of f32 sums."""
    dev = require_cuda()
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
               for a in dense_decode_inputs(B, S, Hq, Hkv, D))
    w = window or -1
    pps = choose_dense_pages_per_split(B, Hkv, S, pos, w, _sm_count(0))
    lo, hi = dense_live_pages(S, pos, w)
    if B * Hkv == 1:
        assert -(-hi // pps) - lo // pps > 1     # more splits than (row, kv head) pairs
    out = decode_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    for ref in (decode_attention_split_plain(q, k, v, pos, window=w, pages_per_split=pps),
                decode_attention_plain(q, k, v, pos, window=w)):
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,pos,window", DENSE_DECODE_SHAPES + [
    (2, 300, 32, 32, 80, 200, None),     # zamba2's shared attention: D = 80
    (2, 1500, 8, 4, 256, 1300, 1024),    # gemma3's local layers
    (2, 64, 4, 2, 16, 1, None),          # one visible key
    (2, 64, 4, 2, 16, 0, None),          # none: zeros
    (3, 100, 4, 4, 128, 100, 7),
])
def test_dense_decode_kernel_matches_plain(dtype, B, S, Hq, Hkv, D, pos, window):
    dev = require_cuda()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in dense_decode_inputs(B, S, Hq, Hkv, D))
    before = decode_attention.launches
    out = decode_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, k, v, pos, window=window or -1)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))
    if pos == 0:
        assert not out.any()
    # mha_decode reaches the kernel with use_kernel, the masked sdpa without
    plain = mha_decode(q, k, v, pos, window=window)
    if pos > 0:
        torch.testing.assert_close(mha_decode(q, k, v, pos, window=window, use_kernel=True)
                                   .float(), plain.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("cadence", [1, 8])
def test_mamba_engine_on_card_matches_cpu(cadence):
    """mamba2-smoke at float32 through the dense-cache engine: identical
    tokens, step counts and completion order from the SSD kernel on the
    card and the plain version on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    require_cuda()
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), dtype=torch.float32)
    cpu_params = build_model(cfg, device="cpu").init_params(0)
    runs = {}
    for where in ("cpu", "cuda"):
        eng = ServingEngine(build_model(cfg, device=where), tree_to(cpu_params, where),
                            ServeConfig(max_batch=4, max_len=64), device=where)
        rng = np.random.default_rng(1)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 40))),
                               max_new_tokens=int(rng.integers(1, 16))))
        before = ssd_intra.launches
        while eng.queue or eng.active:
            eng.step(now=0.0, decode_steps=cadence)
        if where == "cuda":
            assert ssd_intra.launches - before == cfg.n_layers * eng._prefill_rows
        runs[where] = ([(r.rid, r.output) for r in eng.completed], eng.step_count,
                       {r.rid: r.score for r in eng.completed})
    assert runs["cuda"][:2] == runs["cpu"][:2]
    for rid, score in runs["cpu"][2].items():
        assert abs(runs["cuda"][2][rid] - score) < 1e-4


@pytest.mark.cuda
def test_zamba_model_on_card_matches_cpu():
    """zamba2-smoke at float32, model level (the engine refuses the hybrid):
    prefill then four decode steps at one scalar position, identical greedy
    tokens on the card and the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    require_cuda()
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), dtype=torch.float32)
    cpu_params = build_model(cfg, device="cpu").init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 21)))
    toks = {}
    for where in ("cpu", "cuda"):
        model = build_model(cfg, device=where)
        params = tree_to(cpu_params, where)
        logits, cache = model.prefill(params, {"tokens": tokens.to(where)}, max_len=32)
        out = [logits[:, 0].argmax(-1)]
        for i in range(4):
            logits, cache = model.decode_step(params, cache, out[-1][:, None], 21 + i)
            out.append(logits[:, 0].argmax(-1))
        toks[where] = torch.stack(out, 1).cpu()
    assert torch.equal(toks["cuda"], toks["cpu"])


@pytest.mark.cuda
def test_zamba_head_dim_80_on_card_matches_cpu():
    """zamba2-smoke widened to head dim 80 (d_model 160, 2 heads), the
    shared attention's width at full size, at float32: prefill through the
    flash kernel, then four decode steps; identical greedy tokens on the
    card and the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    require_cuda()
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), d_model=160, n_heads=2,
                              n_kv_heads=2, dtype=torch.float32)
    assert cfg.resolved_head_dim == 80
    cpu_params = build_model(cfg, device="cpu").init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 70)))
    toks, logits_at = {}, {}
    for where in ("cpu", "cuda"):
        model = build_model(cfg, device=where)
        params = tree_to(cpu_params, where)
        before = flash_attention_dyn.launches
        logits, cache = model.prefill(params, {"tokens": tokens.to(where)}, max_len=80)
        if where == "cuda":
            assert flash_attention_dyn.launches - before == cfg.n_layers // cfg.shared_attn_every
        logits_at[where] = logits.cpu()
        out = [logits[:, 0].argmax(-1)]
        for i in range(4):
            logits, cache = model.decode_step(params, cache, out[-1][:, None], 70 + i)
            out.append(logits[:, 0].argmax(-1))
        toks[where] = torch.stack(out, 1).cpu()
    assert torch.equal(toks["cuda"], toks["cpu"])
    torch.testing.assert_close(logits_at["cuda"], logits_at["cpu"], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------------
# the moe and vlm families: the main-path kernels at their shapes, and the
# float32 references
# ---------------------------------------------------------------------------------

def _pool_args(dev, dtype, T, Hq, Hkv, D, ps, n, starts, seed):
    """q, k/v pages, table and starts of a seeded pool (``mixed_inputs``) on
    the card: bf16 q with f32-cast, bf16 or int8 pages."""
    q, kp, vp, ks, vs, tbl, st = mixed_inputs(Hq // Hkv, dtype == "int8", T=T, Hkv=Hkv, D=D,
                                              ps=ps, n=n, starts=starts, seed=seed)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    args = [torch.from_numpy(q).to(dev, dt)]
    if dtype == "int8":
        args += [torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)]
        sc = dict(k_scale=torch.from_numpy(ks).to(dev), v_scale=torch.from_numpy(vs).to(dev))
    else:
        args += [torch.from_numpy(kp).to(dev, dt), torch.from_numpy(vp).to(dev, dt)]
        sc = {}
    return args + [torch.from_numpy(tbl).to(dev), torch.from_numpy(st).to(dev)], sc


# (config, Hq, Hkv, D, window) of the families' attention
FAMILY_HEADS = [("olmoe-1b-7b", 16, 16, 128, -1), ("mixtral-8x22b", 48, 8, 128, 4096),
                ("mixtral-8x22b short window", 48, 8, 128, 100),
                ("pixtral-12b", 32, 8, 128, -1), ("smollm-360m", 15, 5, 64, -1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch,Hq,Hkv,D,window", FAMILY_HEADS)
def test_mixed_attention_kernel_at_family_shapes(arch, Hq, Hkv, D, window, dtype):
    """The mixed kernel at each new config's heads: 8 rows of 16 queries
    over 16-token pages, a 64-entry table (olmoe: group 1, 16 query rows a
    kv head, the smallest M the split kernel takes)."""
    dev = require_cuda()
    args, sc = _pool_args(dev, dtype, 16, Hq, Hkv, D, 16, 64,
                          [0, 17, 130, 255, 511, 640, 893, 1000], seed=Hq + D)
    before = decode_attention_mixed.launches
    out = decode_attention_mixed(*args, window=window, **sc)
    torch.cuda.synchronize()
    assert decode_attention_mixed.launches == before + 1
    ref = paged_mixed_attention_plain(*args, window=window, **sc)
    assert torch.isfinite(out).all()
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("Hq,Hkv,D", [(9, 3, 64), (16, 16, 128)])
def test_paged_decode_kernel_page_sizes(Hq, Hkv, D, ps, dtype):
    """The split-K decode kernel at the page sizes the autotune sweep times,
    at smollm-135m's and olmoe-1b-7b's heads, 1024 keys a row at most."""
    dev = require_cuda()
    lengths = [1, ps, ps + 1, 255, 512, 1000, 1024, 700]
    args, sc = _decode_args(dev, dtype, Hq // Hkv, Hkv, D, ps, 1024 // ps, lengths, seed=ps)
    for window in (-1, 100):
        _check_decode_split(args, sc, window)


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,V,tied", [(128, 2048, 50304, False), (128, 6144, 32768, False),
                                        (128, 5120, 131072, False), (128, 960, 49152, True),
                                        (8, 2048, 50304, False)])
def test_lmhead_bf16_kernel_at_family_widths(N, d, V, tied):
    """The bf16 lm-head at olmoe-1b-7b's (untied, d 2048, V 50304),
    mixtral-8x22b's (6144, 32768), pixtral-12b's (5120, 131072) and the
    tied smollm-360m's (960, 49152) heads."""
    dev = require_cuda()
    h, emb = _lmhead_bf16(dev, N, d, V, seed=d)
    _check_lmhead(h, emb.T if tied else emb.T.contiguous())


def _moe_engine_tokens(cfg, chunked, where, cpu_params):
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    kw = dict(max_batch=4, max_len=64, page_size=8, chunked_prefill=chunked)
    if chunked:
        kw.update(chunk_size=8, draft_len=4)
    eng = ServingEngine(build_model(cfg, device=where), tree_to(cpu_params, where),
                        ServeConfig(**kw), device=where)
    rng = np.random.default_rng(1)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 30))),
                           max_new_tokens=int(rng.integers(4, 16))))
    eng.run_until_drained()
    eng.kv.check_invariants()
    return {r.rid: (r.output, r.score) for r in eng.completed}, eng.step_count


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "bucketed"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b"])
def test_moe_engine_on_card_matches_cpu(arch, chunked):
    """The MoE smoke configs at float32 and the published capacity factor
    1.25: identical tokens and step counts on the card (kernels) and the
    CPU (plain versions), scores within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.common import MoEConfig
    require_cuda()
    base = get_smoke_config(arch)
    m = base.moe
    cfg = dataclasses.replace(base, dtype=torch.float32,
                              moe=MoEConfig(m.n_experts, m.top_k, m.d_expert, 1.25))
    cpu_params = build_model(cfg, device="cpu").init_params(0)
    cpu, cpu_steps = _moe_engine_tokens(cfg, chunked, "cpu", cpu_params)
    card, card_steps = _moe_engine_tokens(cfg, chunked, "cuda", cpu_params)
    assert card_steps == cpu_steps
    assert {r: o for r, (o, _) in card.items()} == {r: o for r, (o, _) in cpu.items()}
    for rid, (_, score) in cpu.items():
        assert abs(card[rid][1] - score) < 1e-4


@pytest.mark.cuda
def test_vlm_forward_from_embeddings_on_card_matches_cpu():
    """pixtral-smoke at float32: forward and prefill from (B, S, d)
    embeddings, then decode steps from (B, 1, d) embeddings over the dense
    cache, card against CPU within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    dev = require_cuda()
    cfg = dataclasses.replace(get_smoke_config("pixtral-12b"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(4)
    embeds = torch.from_numpy(rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32))
    step = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    outs = {}
    for where, m in (("cpu", model), ("cuda", build_model(cfg, device=dev))):
        p = tree_to(params, where)
        logits, _ = m.forward(p, {"embeds": embeds.to(where)})
        last, cache = m.prefill(p, {"embeds": embeds.to(where)}, max_len=48)
        dec, cache = m.decode_step(p, cache, step.to(where), 37)
        outs[where] = [t.cpu() for t in (logits, last, dec)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_duplicate_trash_writes_resolve_on_card_as_on_cpu():
    """On the card, rows writing the same trash slots leave the bits the
    CPU's sequential scatter leaves, in every run."""
    from repro_torch.serving.kvcache import paged_update_span
    dev = require_cuda()
    rng = np.random.default_rng(4)
    pages = torch.from_numpy(rng.normal(size=(40, 16, 4, 64)).astype(np.float32))
    new = torch.from_numpy(rng.normal(size=(8, 16, 4, 64)).astype(np.float32))
    tbl = torch.zeros((8, 4), dtype=torch.int32)
    tbl[0, :2] = torch.tensor([3, 9])
    pos = torch.tensor([20, 0, 0, 5, 0, 0, 9, 0], dtype=torch.int32)
    ref = paged_update_span(pages.clone(), new, tbl, pos)
    for _ in range(3):
        out = paged_update_span(pages.to(dev), new.to(dev), tbl.to(dev), pos.to(dev))
        assert torch.equal(out.cpu(), ref)


# ---------------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------------

def _grad_inputs(dev):
    """One small call of every CUDA wrapper, each with its first input
    requiring grad: (name, wrapper, args, kwargs)."""
    rng = np.random.default_rng(9)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    q, kp, vp, _, _, tbl, starts = mixed_inputs(3, False, D=64, ps=16, n=4, T=4)
    fq, fk, fv = flash_inputs(2, D=64)
    q1, kc, vc = dense_decode_inputs(2, 64, 4, 2, 64)
    xb, acs, Bq, Cq = ssd_inputs(nc=1, q=64, h=4, p=64, n=64)
    Bh = torch.from_numpy(Bq).to(dev).expand(-1, -1, -1, 4, -1)
    Ch = torch.from_numpy(Cq).to(dev).expand(-1, -1, -1, 4, -1)
    lengths = torch.from_numpy(starts + 1).to(dev)
    tb, st = torch.from_numpy(tbl).to(dev), torch.from_numpy(starts).to(dev)
    return [
        ("flash_attention", flash_attention_dyn, (f32(fq), f32(fk), f32(fv), -1), {}),
        ("decode_attention_mixed", decode_attention_mixed, (f32(q), f32(kp), f32(vp), tb, st), {}),
        ("decode_attention_paged", decode_attention_paged,
         (f32(q[:, :1]), f32(kp), f32(vp), tb, lengths), {}),
        ("decode_attention", decode_attention, (f32(q1), f32(kc), f32(vc), 40), {}),
        ("greedy_epilogue", greedy_epilogue, (f32(rng.normal(size=(4, 999))),), {}),
        ("fused_lmhead_greedy", fused_lmhead_greedy,
         (f32(rng.normal(size=(4, 64))), f32(rng.normal(size=(64, 999)))), {}),
        ("ssd_intra", ssd_intra, (f32(xb), f32(acs), Bh, Ch), {}),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("which", range(7), ids=["flash_attention", "decode_attention_mixed",
                                                 "decode_attention_paged", "decode_attention",
                                                 "greedy_epilogue", "fused_lmhead_greedy",
                                                 "ssd_intra"])
def test_wrapper_raises_when_asked_for_a_gradient(which):
    """Each CUDA wrapper refuses an input that requires grad while autograd
    records (its kernel has no backward), launches nothing then, and runs
    as before under torch.no_grad."""
    dev = require_cuda()
    name, fn, args, kw = _grad_inputs(dev)[which]
    args = (args[0].clone().requires_grad_(True),) + args[1:]
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
        fn(*args, **kw)
    assert fn.launches == before
    with torch.no_grad():
        fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b", "mamba2-1.3b",
                                  "zamba2-2.7b", "whisper-small"])
def test_train_step_on_card_matches_cpu(arch):
    """The smoke config at float32: one train step's loss and every gradient
    leaf (within 1e-4 + 1e-4 * |ref| of the leaf's largest magnitude, as
    ``chip_smoke.py`` phase 10a: f32 sums in the card's orders; zamba2's
    embedding gradient measured 2.5e-5), then a 3-step loss curve (within
    1e-4 relative), card against CPU; no kernel launches during the
    steps."""
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.training.train_step import loss_and_grads
    dev = require_cuda()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32, remat="block")
    params = build_model(cfg, device="cpu").init_params(0)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32))
        b = {"tokens": tokens, "targets": tokens}
        if cfg.family == "audio":
            b["enc_embeds"] = torch.from_numpy(
                rng.normal(size=(4, cfg.enc_len, cfg.d_model)).astype(np.float32))
        batches.append(b)
    counters = (flash_attention_dyn, decode_attention_mixed, decode_attention_paged,
                decode_attention, greedy_epilogue, fused_lmhead_greedy, ssd_intra)
    before = [c.launches for c in counters]
    out = {}
    for where in ("cpu", dev):
        m = build_model(cfg, device=where)
        p = tree_to(params, where)
        loss, _, g = loss_and_grads(m.loss_fn, p, {k: v.to(where) for k, v in batches[0].items()})
        step = make_train_step(m, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3))
        o, losses = adamw_init(p), []
        for b in batches:
            p, o, met = step(p, o, b)
            losses.append(float(met["loss"]))
        out[str(where)] = (float(loss), {k: t.cpu() for k, t in _flatten(g).items()}, losses)
    assert [c.launches for c in counters] == before
    (l_gpu, g_gpu, c_gpu), (l_cpu, g_cpu, c_cpu) = out["cuda"], out["cpu"]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    for key, ref in g_cpu.items():
        scale = max(float(ref.abs().max()), 1e-6)
        torch.testing.assert_close(g_gpu[key] / scale, ref / scale, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, key=key: f"{key}: {m}")
    np.testing.assert_allclose(c_gpu, c_cpu, rtol=1e-4)


# ---------------------------------------------------------------------------------
# on the card: the sharded step at world size 1, and the CLI's resume
# ---------------------------------------------------------------------------------

def _run_child(argv, tmp_path, *, timeout=600, **env_over):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), **env_over}
    env.pop("REPRO_SUPERVISED", None)
    p = subprocess.run([sys.executable] + argv, capture_output=True, text=True, env=env,
                       timeout=timeout, cwd=str(tmp_path))
    assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-6000:]}"
    return p.stdout


@pytest.mark.cuda
def test_nccl_world_size_1_sharded_step_equals_plain_step(tmp_path):
    """NCCL at world size 1 (a ``file://`` store) and a 1x1 ("data",
    "model") mesh, in a child process (no process group in this one):
    three sharded steps of the smollm-135m smoke config equal three plain
    steps from the same state bit for bit (losses, parameters, ``v``); the
    gathers and reductions are identities at one rank, and deterministic
    index backwards fix the embedding gradient's order."""
    import json
    from pathlib import Path
    require_cuda()
    args = {"world": 1, "backend": "nccl", "arch": "smollm-135m",
            "store": str(tmp_path / "store"), "out": str(tmp_path / "out.json")}
    (tmp_path / "args.json").write_text(json.dumps(args))
    ranks = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
    _run_child([str(ranks), "nccl_step", str(tmp_path / "args.json")], tmp_path,
               timeout=300)
    r = json.loads((tmp_path / "out.json").read_text())
    assert r["sharded"] == r["plain"], r
    assert r["params_equal"] and r["v_equal"], r


@pytest.mark.cuda
def test_train_cli_resume_is_bit_exact_on_the_card(tmp_path):
    """``launch/train.py --supervise --simulate-failure 5`` on the card
    (smollm-135m ``CONFIG``, B 4 x S 128, a checkpoint every 2 steps)
    repeats the uninterrupted run's loss at every step, bit for bit
    (``--loss-log``: the last record of each step)."""
    require_cuda()
    common = ["-m", "repro_torch.launch.train", "--arch", "smollm-135m", "--device", "cuda",
              "--steps", "8", "--batch", "4", "--seq", "128", "--ckpt-every", "2",
              "--log-every", "1"]
    logs = {}
    for name, extra in (("plain", []), ("resumed", ["--supervise", "--simulate-failure", "5"])):
        out = _run_child(common + extra + ["--ckpt-dir", str(tmp_path / f"ckpt-{name}"),
                                           "--loss-log", str(tmp_path / f"{name}.log")],
                         tmp_path)
        last = {}
        for line in (tmp_path / f"{name}.log").read_text().split("\n"):
            if line:
                step, loss = line.split()
                last[int(step)] = float.fromhex(loss)
        logs[name] = (last, out)
    (plain, _), (resumed, out) = logs["plain"], logs["resumed"]
    assert "SIMULATED FAILURE at step 5" in out and "resumed from step" in out, out
    assert sorted(plain) == list(range(8)) and resumed == plain, (plain, resumed)


@pytest.mark.cuda
def test_restore_resharded_holds_only_its_blocks_on_the_card(tmp_path):
    """``restore_resharded`` of smollm-135m ``CONFIG`` (bf16, full width)
    onto a (2, 4) mesh on the card, as rank 6 of 8 under the fake backend,
    in a child process: the blocks equal the whole leaves' blocks, and the
    restore's peak device memory is this rank's blocks (within 1% and
    8 MiB), less than half the whole tree: the file is read into host
    memory and cut there."""
    import json
    from pathlib import Path

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    require_cuda()
    path = save_checkpoint(str(tmp_path / "ckpt.npz"),
                           build_model(get_config("smollm-135m"), device="cpu").init_params(0),
                           step=2)
    args = {"arch": "smollm-135m", "smoke": False, "device": "cuda", "ckpt": path,
            "out": str(tmp_path / "out.json")}
    (tmp_path / "args.json").write_text(json.dumps(args))
    ranks = Path(__file__).resolve().parent / "_torch_dist_ranks.py"
    _run_child([str(ranks), "fake_restore", str(tmp_path / "args.json")], tmp_path,
               timeout=300)
    r = json.loads((tmp_path / "out.json").read_text())
    print(r)
    assert r["coordinate"] == [1, 2] and r["equal"] and r["split_leaves"] > 0, r
    assert r["peak_bytes"] <= 1.01 * r["local_bytes"] + 8 * 2**20, r
    assert r["local_bytes"] < r["whole_bytes"] / 2, r
