"""PyTorch port, the moe and vlm families and smollm-360m against the JAX
package on the CPU at float32: olmoe-1b-7b, mixtral-8x22b, pixtral-12b
(the embeddings input) and smollm-360m smoke configs through ``forward``,
``prefill``, ``decode_step`` and ``verify_step``, and through the engine on
the chunked and the bucketed paths (identical tokens, step counts, block
tables and speculation stats; scores within 1e-4), the MoE engines also at
the published capacity factor 1.25, where pairs are dropped.

With capacity dropping a token's output depends on the other tokens of its
step, idle rows of the fixed-width mixed step included, so the MoE engines
are held against the JAX engine on the same path and requests, not against
a one-request oracle."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.models.common import MoEConfig as JaxMoEConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, lm, moe
from repro_torch.models.common import MoEConfig
from repro_torch.serving import Request, ServeConfig, ServingEngine

from _torch_helpers import smoke_pair

ARCHS = ["olmoe-1b-7b", "mixtral-8x22b", "pixtral-12b", "smollm-360m"]
TOL = dict(atol=2e-5, rtol=2e-5)          # test_torch_layers.py's forward / prefill


def family_pair(arch, capacity_factor=None):
    """smoke_pair, with the MoE capacity factor replaced in both packages."""
    jc, tc, jm, jp, tp = smoke_pair(arch)
    if capacity_factor is not None:
        m = tc.moe
        jc = dataclasses.replace(jc, moe=JaxMoEConfig(m.n_experts, m.top_k, m.d_expert,
                                                      capacity_factor))
        tc = dataclasses.replace(tc, moe=MoEConfig(m.n_experts, m.top_k, m.d_expert,
                                                   capacity_factor))
        jm = jax_build_model(jc)
    return jc, tc, jm, jp, tp


@pytest.fixture
def dropped(monkeypatch):
    """Counts the (token, expert) pairs the port's MoE layers drop."""
    seen = []
    plain = moe.dispatch

    def counting(experts, C, n_experts):
        plan = plain(experts, C, n_experts)
        seen.append(int((~plan[3]).sum()))
        return plan

    monkeypatch.setattr(moe, "dispatch", counting)
    return seen


def _inputs(tc, B=3, S=16, seed=8):
    """A batch for the config's input mode: tokens, or (B, S, d) embeddings."""
    rng = np.random.default_rng(seed)
    if tc.input_mode == "embeddings":
        e = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch):
    """forward logits and the summed load-balance loss; prefill with a
    per-row last_idx and none, padded to max_len."""
    jc, tc, _, jp, tp = smoke_pair(arch)
    jb, tb = _inputs(tc)
    jl, jaux = jax_lm.forward(jp, jb, jc)
    tl, taux = lm.forward(tp, tb, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    assert (float(taux) > 0) == (tc.moe is not None)
    last_idx = np.array([15, 4, 9], np.int32)
    for li in (last_idx, None):
        jlog, jcache = jax_lm.prefill(jp, jb, jc, max_len=24,
                                      last_idx=None if li is None else jnp.asarray(li))
        tlog, tcache = lm.prefill(tp, tb, tc, max_len=24,
                                  last_idx=None if li is None else torch.from_numpy(li))
        assert tlog.shape == (3, 1, tc.vocab)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for key in jcache:
            np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                       **TOL, err_msg=key)


def _paged(jc, rng, B, ps, n, live_pages):
    P = B * n + 1
    L, Hkv, hd = jc.n_layers, jc.n_kv_heads, jc.resolved_head_dim
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tbl = np.zeros((B, n), np.int32)
    for b in range(B):
        tbl[b, :live_pages[b]] = perm[b * n:b * n + live_pages[b]]
    cache = {"k": rng.normal(size=(L, P, ps, Hkv, hd)).astype(np.float32),
             "v": rng.normal(size=(L, P, ps, Hkv, hd)).astype(np.float32)}
    return cache, tbl


@pytest.mark.parametrize("arch,embeds", [(a, False) for a in ARCHS] + [("pixtral-12b", True)])
def test_decode_step_paged_matches_jax(arch, embeds):
    """One token (or, for pixtral, one (B, 1, d) embedding) per row at
    heterogeneous positions over a paged pool: logits and written pages."""
    jc, tc, _, jp, tp = smoke_pair(arch)
    rng = np.random.default_rng(9)
    B, ps, n = 3, 4, 8
    pos = np.array([0, 6, 27], np.int32)
    cache, tbl = _paged(jc, rng, B, ps, n, pos // ps + 1)
    if embeds:
        token = rng.normal(size=(B, 1, tc.d_model)).astype(np.float32)
    else:
        token = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
    jlog, jcache = jax_lm.decode_step(jp, {k: jnp.asarray(a) for k, a in cache.items()},
                                      jnp.asarray(token), jnp.asarray(pos), jc,
                                      block_table=jnp.asarray(tbl))
    tcache = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    tlog, tcache = lm.decode_step(tp, tcache, torch.from_numpy(token), torch.from_numpy(pos),
                                  tc, block_table=torch.from_numpy(tbl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for k in cache:
        np.testing.assert_allclose(tcache[k].numpy()[:, 1:], np.asarray(jcache[k])[:, 1:],
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_jax(arch):
    """A 5-token span per row (test_torch_serving.py's verify tolerances:
    tokens equal, logprobs within 1e-4, written pages within 1e-5)."""
    jc, tc, _, jp, tp = smoke_pair(arch)
    rng = np.random.default_rng(5)
    B, T, ps, n = 3, 5, 4, 8
    pos = np.array([0, 6, 21], np.int32)
    cache, tbl = _paged(jc, rng, B, ps, n, -(-(pos + T) // ps))
    tokens = rng.integers(0, jc.vocab, (B, T)).astype(np.int32)
    jtok, jlp, jcache = jax_lm.verify_step(
        jp, {k: jnp.asarray(a) for k, a in cache.items()}, jnp.asarray(tokens),
        jnp.asarray(pos), jc, block_table=jnp.asarray(tbl))
    tcache = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    ttok, tlp, tcache = lm.verify_step(tp, tcache, torch.from_numpy(tokens),
                                       torch.from_numpy(pos), tc,
                                       block_table=torch.from_numpy(tbl))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
    for k in cache:
        np.testing.assert_allclose(tcache[k].numpy()[:, 1:], np.asarray(jcache[k])[:, 1:],
                                   atol=1e-5, err_msg=k)


def test_moe_blocks_keep_a_float32_router():
    """The port's init draws the router in float32 at any cfg.dtype, and the
    block's leaves have the JAX tree's names and shapes."""
    from repro.configs import get_smoke_config as jax_smoke_config
    import jax
    from repro_torch.configs import get_smoke_config
    tc = get_smoke_config("olmoe-1b-7b")
    tp = build_model(tc, device="cpu").init_params(0)
    jp = jax_build_model(jax_smoke_config("olmoe-1b-7b")).init_params(jax.random.key(0))
    for name, leaf in tp["blocks"][0]["moe"].items():
        jleaf = jp["blocks"]["moe"][name]
        assert tuple(leaf.shape) == jleaf.shape[1:], name
        assert leaf.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
        assert jleaf.dtype == (jnp.float32 if name == "router" else jnp.bfloat16), name
    assert "mlp" not in tp["blocks"][0]


# ---------------------------------------------------------------------------------
# the engine on both paths
# ---------------------------------------------------------------------------------

def _requests(cls, vocab, seed=12, n=6):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 20))).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 14))) for i in range(n)]


def _bucketed_requests(cls, vocab, seed=12, n=8):
    rng = np.random.default_rng(seed)
    reqs = [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(3, 30))).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 14))) for i in range(n)]
    reqs[3].max_new_tokens = 1
    return reqs


# pixtral's bucketed path fails in both engines (the next test)
ENGINE_CASES = [(arch, factor, chunked)
                for arch, factor in (("olmoe-1b-7b", None), ("olmoe-1b-7b", 1.25),
                                     ("mixtral-8x22b", None), ("mixtral-8x22b", 1.25),
                                     ("pixtral-12b", None), ("smollm-360m", None))
                for chunked in (True, False) if chunked or arch != "pixtral-12b"]


@pytest.mark.parametrize("arch,factor,chunked", ENGINE_CASES)
def test_engine_matches_jax_engine(arch, factor, chunked, dropped):
    """test_torch_serving.py's engine kwargs on the chunked path (the
    bucketed one as its bucketed test runs it): identical outputs,
    completion order, step counts, speculation stats and block tables after
    every step, scores within 1e-4, pages conserved.  At factor 1.25 the
    port's MoE layers drop pairs on the way."""
    jc, tc, jm, jp, tp = family_pair(arch, factor)
    if chunked:
        kw = dict(max_batch=4, max_len=64, page_size=8, chunk_size=8, draft_len=4)
        make = _requests
    else:
        kw = dict(max_batch=4, max_len=64, page_size=8, chunked_prefill=False)
        make = _bucketed_requests
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = ServingEngine(build_model(tc, device="cpu"), tp, ServeConfig(**kw), device="cpu")
    for r in make(JaxRequest, jc.vocab):
        jeng.submit(r)
    for r in make(Request, tc.vocab):
        teng.submit(r)
    while jeng.queue or jeng.active:
        jeng.step(now=0.0, decode_steps=8)
        teng.step(now=0.0, decode_steps=8)
        teng.kv.check_invariants()
        assert sorted(teng.active) == sorted(jeng.active)
        np.testing.assert_array_equal(teng.kv.block_table, jeng.kv.block_table)
        assert teng.step_count == jeng.step_count
    assert not teng.queue and not teng.active
    assert teng.speculation_stats == jeng.speculation_stats
    if not chunked:
        assert teng.prefill_occupancy == jeng.prefill_occupancy
        assert teng.bucket_occupancy == jeng.bucket_occupancy
    jout = {r.rid: r for r in jeng.completed}
    assert [r.rid for r in teng.completed] == [r.rid for r in jeng.completed]
    for r in teng.completed:
        assert r.output == jout[r.rid].output, r.rid
        assert len(r.output) == r.max_new_tokens
        assert abs(r.score - jout[r.rid].score) < 1e-4
    assert teng.kv.n_free == teng.kv.num_pages - 1
    if tc.moe is not None:
        assert dropped and (sum(dropped) > 0) == (factor == 1.25), sum(dropped)


def test_vlm_bucketed_prefill_fails_as_in_jax():
    """Both engines serve vlm prompts as tokens; the bucketed path's prefill
    reads ``batch["embeds"]`` for the embeddings input mode, so both fail
    at the first prefill with the same KeyError (ROADMAP.md Queue 3,
    reference caveats)."""
    jc, tc, jm, jp, tp = smoke_pair("pixtral-12b")
    kw = dict(max_batch=4, max_len=64, page_size=8, chunked_prefill=False)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = ServingEngine(build_model(tc, device="cpu"), tp, ServeConfig(**kw), device="cpu")
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        for r in _bucketed_requests(cls, tc.vocab):
            eng.submit(r)
        with pytest.raises(KeyError, match="embeds"):
            eng.step(now=0.0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "pixtral-12b"])
def test_serve_cli_runs_the_new_archs_on_cpu(arch, capsys):
    assert serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "6", "--horizon", "10", "--policy", "appdata"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"completed (\d+)/\1 requests", out) and "violations" in out


@pytest.mark.parametrize("span", [True, False], ids=["span", "one token"])
def test_duplicate_trash_writes_resolve_to_the_last_writer(span):
    """Rows that share trash slots: the pool, page 0 included, equals the
    JAX package's scatter on the CPU (its last writer in row-major order),
    and an unordered scatter would give the same bits."""
    from repro.serving import kvcache as jkv
    from repro_torch.serving import kvcache as tkv
    rng = np.random.default_rng(4)
    P, ps, n = 6, 4, 3
    T = 5 if span else 1
    pages = rng.normal(size=(P, ps, 2, 3)).astype(np.float32)
    new = rng.normal(size=(4, T, 2, 3)).astype(np.float32)
    tbl = np.array([[3, 1, 0], [0, 0, 0], [5, 0, 0], [0, 0, 0]], np.int32)
    pos = np.array([2, 0, 3, 1], np.int32)
    jfn, tfn = ((jkv.paged_update_span, tkv.paged_update_span) if span
                else (jkv.paged_update, tkv.paged_update))
    ref = np.asarray(jfn(jnp.asarray(pages), jnp.asarray(new), jnp.asarray(tbl),
                         jnp.asarray(pos)))
    out = tfn(torch.from_numpy(pages.copy()), torch.from_numpy(new), torch.from_numpy(tbl),
              torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(out, ref)
    idx = torch.tensor([0, 7, 0, 3, 7, 0])
    assert tkv._last_writer(idx, 8).tolist() == [5, 4, 5, 3, 4, 5]


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
@pytest.mark.parametrize("span", [True, False], ids=["verify_step", "decode_step"])
def test_step_computes_its_write_slots_once(arch, span, monkeypatch):
    """A paged step shares one ``PagedOps`` across its layers: the
    last-writer order is computed once a step, whatever the family, and
    the pool it leaves equals the one of per-write ``paged_update(_span)``
    calls."""
    from repro_torch.serving import kvcache as tkv
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    B, T, ps, n = 3, 4 if span else 1, 8, 4
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, B * n + 1, ps, cfg.n_kv_heads, cfg.resolved_head_dim)
    pool = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for k in "kv"}
    tbl = torch.tensor([[1, 2, 0, 0], [0, 0, 0, 0], [5, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([9, 0, 6], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)))
    calls = []
    real = tkv._last_writer
    monkeypatch.setattr(tkv, "_last_writer", lambda *a: calls.append(1) or real(*a))
    shared = {k: v.clone() for k, v in pool.items()}
    if span:
        model.verify_step(params, shared, toks, pos, block_table=tbl)
    else:
        model.decode_step(params, shared, toks, pos, block_table=tbl)
    assert len(calls) == 1
    monkeypatch.setattr(lm.kvcache, "PagedOps", _PerWriteOps)
    per_write = {k: v.clone() for k, v in pool.items()}
    if span:
        model.verify_step(params, per_write, toks, pos, block_table=tbl)
    else:
        model.decode_step(params, per_write, toks, pos, block_table=tbl)
    assert len(calls) == 1 + 2 * cfg.n_layers
    for k in "kv":
        torch.testing.assert_close(shared[k], per_write[k], rtol=0, atol=0)


class _PerWriteOps:
    """``PagedOps`` without the shared plan: each write computes its own."""

    def __init__(self, block_table):
        self.block_table = block_table

    def write(self, cache, new, pos):
        from repro_torch.serving.kvcache import paged_update
        return paged_update(cache, new, self.block_table, pos)

    def write_span(self, cache, new, pos):
        from repro_torch.serving.kvcache import paged_update_span
        return paged_update_span(cache, new, self.block_table, pos)
