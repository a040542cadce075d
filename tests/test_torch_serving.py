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


def test_prefill_pages_and_slot_migration_match_jax():
    """alloc_prefill + write_prefill_pages (one batched scatter, bucket
    overhang into the trash page), then export_slot / import_slot, scripted
    on both pools: block tables, free lists, reservations and page contents
    equal (page 0 takes unordered garbage writes and is not compared)."""
    rng = np.random.default_rng(13)
    L, ps, pb = 2, 8, 32
    shapes = {"k": (L, 4, 64, 2, 4), "v": (L, 4, 64, 2, 4)}
    jpool = jkv.PagedKVCache(lambda b, s: {k: jnp.zeros((L, b, s, 2, 4)) for k in shapes},
                             max_batch=4, max_len=64, page_size=ps)
    tpool = tkv.PagedKVCache(lambda b, s: {k: torch.zeros((L, b, s, 2, 4)) for k in shapes},
                             max_batch=4, max_len=64, page_size=ps)
    cache = {k: rng.normal(size=(L, 3, pb, 2, 4)).astype(np.float32) for k in shapes}

    def same():
        np.testing.assert_array_equal(tpool.block_table, jpool.block_table)
        np.testing.assert_array_equal(tpool.held, jpool.held)
        np.testing.assert_array_equal(tpool.worst, jpool.worst)
        assert tpool._free == jpool._free and tpool._outstanding == jpool._outstanding
        for k in shapes:
            np.testing.assert_array_equal(tpool.pages[k].numpy()[:, 1:],
                                          np.asarray(jpool.pages[k])[:, 1:])
        tpool.check_invariants()

    for pool in (jpool, tpool):
        pool.reserve(3, 10)
        ids = np.stack([pool.alloc_prefill(0, 20, 40, pb // ps),
                        pool.alloc_prefill(1, 9, 9, pb // ps),
                        np.zeros(pb // ps, np.int32)])         # a padding row
        if pool is jpool:
            jpool.pages = jkv.write_prefill_pages(
                jpool.pages, {k: jnp.asarray(c) for k, c in cache.items()}, jnp.asarray(ids))
        else:
            tkv.write_prefill_pages(tpool.pages, {k: torch.from_numpy(c) for k, c in
                                                  cache.items()}, torch.from_numpy(ids))
        pool.ensure_writable(0, 24)
    same()
    jchunks, tchunks = jpool.export_slot(0), tpool.export_slot(0)
    assert jpool.export_slot(2) is None and tpool.export_slot(2) is None
    for k in shapes:
        assert tchunks[k].device.type == "cpu"
        np.testing.assert_array_equal(tchunks[k].numpy(), np.asarray(jchunks[k]))
    jpool.release(0)
    tpool.release(0)
    jpool.import_slot(2, jchunks, 50)
    tpool.import_slot(2, tchunks, 50)
    same()


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
                                             ("gemma3-4b", 8, "int8"),
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
    """The device rule, and what each path refuses.  ``paged=False`` was
    refused until the dense-cache fallback was ported; now it builds and
    drains (its parity with the JAX engine is in test_torch_dense_cache.py)."""
    _, tc, _, _, tp = smoke_pair("smollm-135m")
    tm = build_model(tc, device="cpu")
    dense = ServingEngine(tm, tp, ServeConfig(max_len=64, paged=False), device="cpu")
    assert dense.kv is None and not dense.chunked
    dense.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4))
    dense.run_until_drained()
    assert len(dense.completed[0].output) == 4
    bucketed = ServingEngine(tm, tp, ServeConfig(max_len=64, chunked_prefill=False),
                             device="cpu")
    with pytest.raises(RuntimeError, match="migration"):
        bucketed.export_request(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tm, tp, ServeConfig(max_len=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "smollm-135m", "--smoke"])


# ---------------------------------------------------------------------------------
# the bucketed-prefill engine
# ---------------------------------------------------------------------------------

def _bucketed_requests(cls, vocab, seed=12, n=8):
    """Prompts in the 16 and 32 buckets; one single-token budget (finished
    at fill time by the prefill argmax)."""
    rng = np.random.default_rng(seed)
    reqs = [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(3, 30))).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 14))) for i in range(n)]
    reqs[3].max_new_tokens = 1
    return reqs


@pytest.mark.parametrize("wait", [0, 4])
@pytest.mark.parametrize("cadence", [1, 8])
@pytest.mark.parametrize("arch,kv", [("smollm-135m", "native"), ("gemma3-4b", "native"),
                                     ("gemma3-4b", "int8"), ("qwen2.5-3b", "int8")])
def test_bucketed_engine_matches_jax_engine(arch, kv, cadence, wait):
    """chunked_prefill=False on the same requests and parameters: identical
    outputs, step counts, block tables after every step, prefill and bucket
    occupancy; scores within 1e-4; pages conserved after every step."""
    jc, tc, jm, jp, tp = smoke_pair(arch, kv=kv)
    kw = dict(max_batch=4, max_len=64, page_size=8, chunked_prefill=False,
              bucket_max_wait=wait)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    tm = build_model(tc, device="cpu")
    teng = ServingEngine(tm, tp, ServeConfig(**kw), device="cpu")
    for r in _bucketed_requests(JaxRequest, jc.vocab):
        jeng.submit(r)
    treqs = _bucketed_requests(Request, tc.vocab)
    for r in treqs:
        teng.submit(r)
    while jeng.queue or jeng.active:
        jeng.step(now=0.0, decode_steps=cadence)
        teng.step(now=0.0, decode_steps=cadence)
        teng.kv.check_invariants()
        assert sorted(teng.active) == sorted(jeng.active)
        np.testing.assert_array_equal(teng.kv.block_table, jeng.kv.block_table)
        assert teng.step_count == jeng.step_count
    assert not teng.queue and not teng.active
    assert teng.prefill_occupancy == jeng.prefill_occupancy
    assert teng.bucket_occupancy == jeng.bucket_occupancy
    jout = {r.rid: r for r in jeng.completed}
    assert [r.rid for r in teng.completed] == [r.rid for r in jeng.completed]
    for r in teng.completed:
        assert r.output == jout[r.rid].output, r.rid
        assert len(r.output) == r.max_new_tokens
        assert abs(r.score - jout[r.rid].score) < 1e-4
    assert teng.kv.n_free == teng.kv.num_pages - 1
    if cadence == 1 and wait == 0:
        for r in treqs[:3]:
            assert r.output == _oracle(tm, tp, r.prompt, r.max_new_tokens), r.rid


def _long_requests(cls, vocab, seed=21, n=6):
    """Prompts of 20 .. 40 tokens, 8 .. 20 new: every row passes the smoke
    gemma3's 8-token window several times over."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(20, 41))).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 21))) for i in range(n)]


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("chunked", [True, False])
def test_gemma3_engine_past_the_window_matches_jax(chunked, kv, monkeypatch):
    """gemma3-smoke (window 8, a global layer every 3) at ``max_len`` 8 x
    the window, prompts past it, on both paths: every attention call of
    the port's run takes the window ``repro.models.lm.layer_windows`` gives
    its layer; outputs, step counts and block tables equal the JAX
    engine's, scores within 1e-4 (int8: 2e-3, below); and the same engine
    with the windows dropped scores differently, so the windows act at
    this size.

    The int8 tolerance: where a K or V value in f32 sits within an ulp of
    a rounding midpoint of its int8 step, the two packages' prefills
    (equal within 3e-6) may round it to neighbouring steps; with an
    8-token window one such value moves a token's logprob by up to 1.3e-3
    (the port decoding from the JAX package's own int8 cache agrees with
    it within 1.2e-6).  The bucketed int8 drain differs by 3.3e-4 at most."""
    jc, tc, jm, jp, tp = smoke_pair("gemma3-4b", kv=kv)
    want = tuple(int(w) for w in jax_lm.layer_windows(jc))
    assert lm.layer_windows(tc) == want and 8 in want and -1 in want
    kw = dict(max_batch=4, max_len=8 * tc.window, page_size=8, chunk_size=8, draft_len=4,
              chunked_prefill=chunked)
    seen = []
    for name in ("block_verify", "block_decode", "block_forward"):
        def recording(x, bp, window, *a, _f=getattr(lm, name), **k):
            seen.append(window)
            return _f(x, bp, window, *a, **k)
        monkeypatch.setattr(lm, name, recording)

    def drain(cfg):
        eng = ServingEngine(build_model(cfg, device="cpu"), tp, ServeConfig(**kw), device="cpu")
        for r in _long_requests(Request, cfg.vocab):
            eng.submit(r)
        tables = []
        while eng.queue or eng.active:
            eng.step(now=0.0, decode_steps=4)
            eng.kv.check_invariants()
            tables.append(eng.kv.block_table.copy())
        return eng, tables

    teng, ttables = drain(tc)
    L = tc.n_layers
    assert seen and len(seen) % L == 0
    assert all(tuple(seen[i:i + L]) == want for i in range(0, len(seen), L))
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    for r in _long_requests(JaxRequest, jc.vocab):
        jeng.submit(r)
    for tbl in ttables:
        jeng.step(now=0.0, decode_steps=4)
        np.testing.assert_array_equal(tbl, jeng.kv.block_table)
    assert not jeng.queue and not jeng.active
    assert teng.step_count == jeng.step_count
    jout = {r.rid: r for r in jeng.completed}
    assert [r.rid for r in teng.completed] == [r.rid for r in jeng.completed]
    for r in teng.completed:
        assert len(r.prompt) + len(r.output) > 2 * tc.window
        assert r.output == jout[r.rid].output, r.rid
        assert abs(r.score - jout[r.rid].score) < (2e-3 if kv == "int8" else 1e-4)
    assert teng.kv.n_free == teng.kv.num_pages - 1
    flat, _ = drain(dataclasses.replace(tc, window=None, global_every=None))
    nowin = {r.rid: r.score for r in flat.completed}
    assert max(abs(r.score - nowin[r.rid]) for r in teng.completed) > 1e-3


def test_migration_matches_undisturbed_run_and_jax():
    """export_request mid-flight from one chunked engine, import_request into
    another: the migrated request's tokens equal an undisturbed run's, and
    both engines conserve pages; the JAX engines do the same."""
    jc, tc, jm, jp, tp = smoke_pair("smollm-135m")
    kw = dict(max_batch=4, max_len=64, page_size=8, chunk_size=8, draft_len=4)
    tm = build_model(tc, device="cpu")
    runs = {}
    for name, make_eng, make_req in (
            ("torch", lambda: ServingEngine(tm, tp, ServeConfig(**kw), device="cpu"), Request),
            ("jax", lambda: JaxEngine(jm, jp, JaxServeConfig(**kw)), JaxRequest)):
        ref = make_eng()
        for r in _requests(make_req, tc.vocab, n=4):
            ref.submit(r)
        ref.run_until_drained()
        src, dst = make_eng(), make_eng()
        for r in _requests(make_req, tc.vocab, n=4):
            src.submit(r)
        src.step(now=0.0, decode_steps=1)
        src.step(now=0.0, decode_steps=1)
        slots = sorted(src.active)
        moved = [src.export_request(s) for s in slots[:2]]
        assert moved[0].pos > 0 and moved[0].kv_chunks is not None
        for m in moved:
            dst.import_request(m)
        src.run_until_drained()
        dst.run_until_drained()
        for eng in (src, dst):
            eng.kv.check_invariants()
            assert eng.kv.n_free == eng.kv.num_pages - 1
        got = {r.rid: r.output for r in src.completed + dst.completed}
        assert got == {r.rid: r.output for r in ref.completed}
        runs[name] = got
    assert runs["torch"] == runs["jax"]


# ---------------------------------------------------------------------------------
# the scaling loop on the live engine
# ---------------------------------------------------------------------------------

def _backend_requests(cls, stream, vocab, max_len):
    return [cls(rid=i, arrival_s=t,
                prompt=np.random.default_rng(i).integers(0, vocab, min(p, max_len // 2)).astype(np.int32),
                max_new_tokens=max(min(d, max_len // 4), 1))
            for i, (t, p, d) in enumerate(stream)]


def _backend_parity(policy, chunked):
    jc, tc, jm, jp, tp = smoke_pair("smollm-135m")
    skw = dict(n_requests=15, seed=0, mean_prompt=16, mean_decode=8,
               burst_times=(10.0,), horizon_s=20.0)
    stream = request_stream(**skw)
    assert stream == jax_request_stream(**skw)
    kw = dict(max_batch=4, max_len=128, decode_steps=1, chunked_prefill=chunked)
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
    assert trep.extra == jrep.extra


@pytest.mark.parametrize("policy", ["target", "appdata"])
def test_serve_backend_matches_jax(policy):
    """The paper's loop on the port: the same policy and requests give the
    same completions, slot trajectory and decision log as the JAX stack."""
    _backend_parity(policy, chunked=True)


@pytest.mark.parametrize("policy", ["target", "appdata"])
def test_bucketed_serve_backend_matches_jax(policy):
    """The same loop over the bucketed-prefill engine."""
    _backend_parity(policy, chunked=False)


def test_serve_cli_runs_on_cpu(capsys):
    assert serve_main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--requests", "6", "--horizon", "10", "--policy", "appdata"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"completed (\d+)/\1 requests", out) and "violations" in out
    assert serve_main(["--smoke", "--device", "cpu", "--policy", "load"]) == 2


def test_serve_cli_bucketed_runs_on_cpu(capsys):
    assert serve_main(["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--bucketed",
                       "--requests", "6", "--horizon", "10", "--decode-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"completed (\d+)/\1 requests", out) and "prefill occupancy" in out
