"""PyTorch port, serving path: paged KV cache, proposers, verify_step, the
mixed-step engine and the ServeBackend scaling loop, each held against the
JAX package on the same inputs at float32 (greedy tokens identical)."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scaling import make_policy as jax_make_policy
from repro.data import request_stream as jax_request_stream
from repro.launch.serve import ServeBackend as JaxServeBackend
from repro.models import lm as jax_lm
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxEngine
from repro.serving import kvcache as jkv
from repro.serving.speculate import NGramProposer as JaxNGram
from repro.serving.speculate import prefix_len as jax_prefix_len
from repro_torch.core.scaling import make_policy
from repro_torch.data import request_stream
from repro_torch.launch.serve import ServeBackend, main as serve_main
from repro_torch.models import build_model, lm
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.speculate import NGramProposer, RepeatProposer, prefix_len

from _torch_helpers import smoke_pair


# ---------------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------------

def _script(kv):
    """One scripted reserve / ensure / shrink / release sequence."""
    kv.reserve(0, 40)
    kv.reserve(1, 20)
    kv.ensure_writable_span(0, 0, 34)
    kv.ensure_writable_span(1, 0, 9)
    yield
    kv.shrink_to(0, 17)
    kv.reserve(2, 60)
    kv.ensure_writable_span(2, 0, 50)
    kv.ensure_writable_span(1, 9, 11)
    yield
    kv.release(0)
    kv.shrink_to(2, 33)
    kv.reserve(3, 8)
    kv.ensure_writable_span(3, 0, 1)
    yield
    kv.release(1)
    kv.release(2)
    kv.release(3)
    yield


def test_paged_kv_cache_matches_jax():
    def jinit(b, s):
        return {"k": jnp.zeros((2, b, s, 1, 4))}

    def tinit(b, s):
        return {"k": torch.zeros((2, b, s, 1, 4))}

    jpool = jkv.PagedKVCache(jinit, max_batch=4, max_len=64, page_size=8)
    tpool = tkv.PagedKVCache(tinit, max_batch=4, max_len=64, page_size=8)
    assert tuple(tpool.pages["k"].shape) == tuple(jpool.pages["k"].shape)
    for _ in zip(_script(jpool), _script(tpool)):
        np.testing.assert_array_equal(tpool.block_table, jpool.block_table)
        np.testing.assert_array_equal(tpool.held, jpool.held)
        np.testing.assert_array_equal(tpool.worst, jpool.worst)
        assert tpool._free == jpool._free
        assert tpool._outstanding == jpool._outstanding
        assert tpool.can_admit(60) == jpool.can_admit(60)
        tpool.check_invariants()
    assert tpool.n_free == tpool.num_pages - 1


def test_paged_kv_cache_invariants_catch_a_leak():
    tpool = tkv.PagedKVCache(lambda b, s: {"k": torch.zeros((1, b, s, 1, 4))},
                             max_batch=2, max_len=32, page_size=8)
    tpool.reserve(0, 20)
    tpool.ensure_writable_span(0, 0, 20)
    tpool.block_table[0, 1] = tpool.block_table[0, 0]     # a page owned twice
    with pytest.raises(AssertionError, match="owned by two slots"):
        tpool.check_invariants()


def test_paged_update_span_and_gather_match_jax():
    rng = np.random.default_rng(3)
    P, ps, B, T, n = 9, 4, 2, 5, 4
    pages = rng.normal(size=(P, ps, 2, 3)).astype(np.float32)
    new = rng.normal(size=(B, T, 2, 3)).astype(np.float32)
    tbl = np.array([[3, 1, 0, 0], [7, 2, 5, 8]], np.int32)
    pos = np.array([2, 9], np.int32)
    ref = jkv.paged_update_span(jnp.asarray(pages), jnp.asarray(new),
                                jnp.asarray(tbl), jnp.asarray(pos))
    out = tkv.paged_update_span(torch.from_numpy(pages.copy()), torch.from_numpy(new),
                                torch.from_numpy(tbl), torch.from_numpy(pos))
    # page 0 takes the writes past row 0's pages: compare the real pages
    np.testing.assert_array_equal(out.numpy()[1:], np.asarray(ref)[1:])
    np.testing.assert_array_equal(
        tkv.paged_gather(out, torch.from_numpy(tbl)).numpy()[:, :8],
        np.asarray(jkv.paged_gather(ref, jnp.asarray(tbl)))[:, :8])


# ---------------------------------------------------------------------------------
# proposers
# ---------------------------------------------------------------------------------

def test_proposers_and_prefix_len_match_jax():
    rng = np.random.default_rng(4)
    hist = rng.integers(0, 4, (6, 24)).astype(np.int64)   # small vocab: many matches
    hist[1, :] = 7                                          # all-same history
    ell = np.array([1, 5, 24, 9, 2, 17], np.int64)
    th, tl = torch.from_numpy(hist), torch.from_numpy(ell)
    for n, d in ((2, 3), (3, 5), (1, 2)):
        ref = np.asarray(JaxNGram(draft_len=d, ngram=n)(jnp.asarray(hist, jnp.int32),
                                                        jnp.asarray(ell, jnp.int32)))
        np.testing.assert_array_equal(NGramProposer(draft_len=d, ngram=n)(th, tl).numpy(), ref)
    rep = RepeatProposer(draft_len=2)(th, tl).numpy()
    np.testing.assert_array_equal(rep, np.repeat(hist[np.arange(6), ell - 1][:, None], 2, 1))
    match = rng.random((5, 7)) < 0.7
    np.testing.assert_array_equal(prefix_len(torch.from_numpy(match)).numpy(),
                                  np.asarray(jax_prefix_len(jnp.asarray(match))))


# ---------------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b", "gemma3-4b"])
def test_verify_step_matches_jax(arch, kv):
    jc, tc, _, jp, tp = smoke_pair(arch, kv=kv)
    rng = np.random.default_rng(5)
    B, T, ps, n = 3, 5, 4, 8
    P = B * n + 1
    L, Hkv, hd = jc.n_layers, jc.n_kv_heads, jc.resolved_head_dim
    pos = np.array([0, 6, 21], np.int32)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tbl = np.zeros((B, n), np.int32)
    for b in range(B):
        live = -(-(pos[b] + T) // ps)
        tbl[b, :live] = perm[b * n:b * n + live]
    if kv == "int8":
        cache = {"k": rng.integers(-127, 128, (L, P, ps, Hkv, hd)).astype(np.int8),
                 "v": rng.integers(-127, 128, (L, P, ps, Hkv, hd)).astype(np.int8),
                 "k_scale": rng.uniform(1e-3, 2e-2, (L, P, ps, Hkv, 1)).astype(np.float32),
                 "v_scale": rng.uniform(1e-3, 2e-2, (L, P, ps, Hkv, 1)).astype(np.float32)}
    else:
        cache = {"k": rng.normal(size=(L, P, ps, Hkv, hd)).astype(np.float32),
                 "v": rng.normal(size=(L, P, ps, Hkv, hd)).astype(np.float32)}
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
    for k in cache:     # written pages (page 0 holds the unordered trash writes)
        np.testing.assert_allclose(tcache[k].numpy()[:, 1:].astype(np.float32),
                                   np.asarray(jcache[k])[:, 1:].astype(np.float32),
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------------
# the mixed-step engine
# ---------------------------------------------------------------------------------

def _oracle(model, params, prompt, n):
    toks = list(prompt)
    out = []
    for _ in range(n):
        logits, _ = model.forward(params, {"tokens": torch.tensor([toks])})
        out.append(int(logits[0, -1].argmax()))
        toks.append(out[-1])
    return out


def _requests(cls, vocab, seed=12, n=6):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 20))).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 14))) for i in range(n)]


@pytest.mark.parametrize("arch,cadence,kv", [("smollm-135m", 1, "native"),
                                             ("smollm-135m", 8, "native"),
                                             ("gemma3-4b", 8, "native"),
                                             ("qwen2.5-3b", 8, "int8")])
def test_engine_matches_jax_engine(arch, cadence, kv):
    """Same requests, same parameters: identical outputs and step counts,
    scores within 1e-4; page conservation after every step; greedy outputs
    equal the port's own full-forward argmax oracle."""
    jc, tc, jm, jp, tp = smoke_pair(arch, kv=kv)
    kw = dict(max_batch=4, max_len=64, page_size=8, chunk_size=8, draft_len=4)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    tm = build_model(tc, device="cpu")
    teng = ServingEngine(tm, tp, ServeConfig(**kw), device="cpu")
    for r in _requests(JaxRequest, jc.vocab):
        jeng.submit(r)
    treqs = _requests(Request, tc.vocab)
    for r in treqs:
        teng.submit(r)
    seen_mid = False
    while jeng.queue or jeng.active:
        jeng.step(now=0.0, decode_steps=cadence)
        teng.step(now=0.0, decode_steps=cadence)
        teng.kv.check_invariants()
        seen_mid = seen_mid or bool(teng.active)
        assert sorted(teng.active) == sorted(jeng.active)
        np.testing.assert_array_equal(teng.kv.block_table, jeng.kv.block_table)
    assert not teng.queue and not teng.active
    assert seen_mid or cadence > 1        # a cadence of 8 may drain in one step
    assert teng.step_count == jeng.step_count
    assert teng.speculation_stats == jeng.speculation_stats
    jout = {r.rid: r for r in jeng.completed}
    assert [r.rid for r in teng.completed] == [r.rid for r in jeng.completed]
    for r in teng.completed:
        assert r.output == jout[r.rid].output, r.rid
        assert abs(r.score - jout[r.rid].score) < 1e-4
    assert teng.kv.n_free == teng.kv.num_pages - 1
    if cadence == 1:
        for r in treqs[:3]:
            assert r.output == _oracle(tm, tp, r.prompt, r.max_new_tokens), r.rid


def test_engine_eos_stops_row():
    _, tc, _, _, tp = smoke_pair("smollm-135m")
    tm = build_model(tc, device="cpu")
    prompt = np.random.default_rng(15).integers(0, tc.vocab, 11).astype(np.int32)
    first = _oracle(tm, tp, prompt, 1)[0]
    eng = ServingEngine(tm, tp, ServeConfig(max_batch=2, max_len=64, eos_token=first,
                                            chunk_size=16, draft_len=3), device="cpu")
    req = Request(rid=0, prompt=prompt, max_new_tokens=8)
    eng.submit(req)
    eng.run_until_drained()
    assert req.output == [first]
    assert eng.kv.n_free == eng.kv.num_pages - 1


def test_engine_device_rule_and_unported_paths(monkeypatch):
    _, tc, _, _, tp = smoke_pair("smollm-135m")
    tm = build_model(tc, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked"):
        ServingEngine(tm, tp, ServeConfig(chunked_prefill=False), device="cpu")
    eng = ServingEngine(tm, tp, ServeConfig(max_len=64), device="cpu")
    with pytest.raises(NotImplementedError, match="migration"):
        eng.export_request(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tm, tp, ServeConfig(max_len=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "smollm-135m", "--smoke"])


# ---------------------------------------------------------------------------------
# the scaling loop on the live engine
# ---------------------------------------------------------------------------------

def _backend_requests(cls, stream, vocab, max_len):
    return [cls(rid=i, arrival_s=t,
                prompt=np.random.default_rng(i).integers(0, vocab, min(p, max_len // 2)).astype(np.int32),
                max_new_tokens=max(min(d, max_len // 4), 1))
            for i, (t, p, d) in enumerate(stream)]


@pytest.mark.parametrize("policy", ["target", "appdata"])
def test_serve_backend_matches_jax(policy):
    """The paper's loop on the port: the same policy and requests give the
    same completions, slot trajectory and decision log as the JAX stack."""
    jc, tc, jm, jp, tp = smoke_pair("smollm-135m")
    skw = dict(n_requests=15, seed=0, mean_prompt=16, mean_decode=8,
               burst_times=(10.0,), horizon_s=20.0)
    stream = request_stream(**skw)
    assert stream == jax_request_stream(**skw)
    kw = dict(max_batch=4, max_len=128, decode_steps=1)
    bkw = dict(sla_s=20.0, horizon_s=20.0, stall_steps=50.0, decode_steps=1)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    jrep = JaxServeBackend(jeng, _backend_requests(JaxRequest, stream, jc.vocab, 128),
                           policy=jax_make_policy(policy), **bkw).run()
    teng = ServingEngine(build_model(tc, device="cpu"), tp, ServeConfig(**kw), device="cpu")
    trep = ServeBackend(teng, _backend_requests(Request, stream, tc.vocab, 128),
                        policy=make_policy(policy), **bkw).run()
    assert trep.n_done == jrep.n_done == len(stream)
    assert {r.rid: r.output for r in teng.completed} == \
           {r.rid: r.output for r in jeng.completed}
    np.testing.assert_array_equal(trep.units_t, jrep.units_t)
    np.testing.assert_array_equal(trep.latencies, jrep.latencies)
    assert [dataclasses.asdict(d) for d in trep.decisions] == \
           [dataclasses.asdict(d) for d in jrep.decisions]
    assert trep.extra["engine_steps"] == jrep.extra["engine_steps"]


def test_serve_cli_runs_on_cpu(capsys):
    assert serve_main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--requests", "6", "--horizon", "10", "--policy", "appdata"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"completed (\d+)/\1 requests", out) and "violations" in out
    assert serve_main(["--smoke", "--device", "cpu", "--policy", "load"]) == 2
