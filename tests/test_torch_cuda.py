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
    decode_attention_mixed, paged_mixed_attention_plain,
)
from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, lmhead_greedy_plain

from _torch_helpers import lmhead_inputs, mixed_inputs, require_cuda, tree_to


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
