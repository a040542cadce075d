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
    decode_attention, decode_attention_mixed, decode_attention_paged,
    decode_attention_plain, paged_decode_attention_plain, paged_mixed_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain
from repro_torch.kernels.sampling.ops import (
    fused_lmhead_greedy, greedy_epilogue, greedy_epilogue_plain, lmhead_greedy_plain,
)
from repro_torch.kernels.ssd.ops import ssd_intra, ssd_intra_plain
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "tie"])
@pytest.mark.parametrize("V", [999, 4099, 49152])
def test_greedy_epilogue_kernel_matches_plain(kind, V):
    dev = require_cuda()
    x = torch.from_numpy(logits_inputs(kind, B=9, V=V)).to(dev)
    before = greedy_epilogue.launches
    tok, lp = greedy_epilogue(x[:, :])
    torch.cuda.synchronize()
    assert greedy_epilogue.launches == before + 1
    tok_p, lp_p = greedy_epilogue_plain(x)
    assert torch.equal(tok, tok_p)
    torch.testing.assert_close(lp, lp_p, atol=1e-4, rtol=0)
    if kind == "tie":
        assert tok[0].item() == 3 and tok[1].item() == 0


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
