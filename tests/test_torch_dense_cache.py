"""PyTorch port, the engine's dense-cache fallback (``paged=False``, and the
ssm family, which has no paged decode path) and the scaling loop on it, held
against the JAX engine on the same requests at float32 (greedy tokens
identical)."""
import dataclasses
import re

import numpy as np
import pytest

from _torch_helpers import torch_pair


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("vector", [False, True])
def test_lm_decode_step_dense_cache_matches_jax(vector, kv):
    """lm.decode_step with block_table=None over the dense (L, B, S, ...) cache:
    one scalar position for every row (DenseScalarOps) or one per row
    (DenseVectorOps); logits and every cache leaf against the JAX route, on
    gemma3-smoke (local and global layers) and int8 KV."""
    import jax.numpy as jnp
    import torch
    from repro.models import lm as jax_lm
    from repro_torch.models import lm
    jc, tc, _, jp, tp = torch_pair("gemma3-4b", kv=kv)
    rng = np.random.default_rng(11)
    B, S, L = 3, 24, jc.n_layers
    shape = (L, B, S, jc.n_kv_heads, jc.resolved_head_dim)
    if kv == "int8":
        cache = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": rng.uniform(1e-3, 2e-2, shape[:-1] + (1,)).astype(np.float32),
                 "v_scale": rng.uniform(1e-3, 2e-2, shape[:-1] + (1,)).astype(np.float32)}
    else:
        cache = {k: rng.normal(size=shape).astype(np.float32) for k in ("k", "v")}
    token = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
    pos = np.array([3, 11, 23], np.int32) if vector else 13
    jlog, jcache = jax_lm.decode_step(jp, {k: jnp.asarray(a) for k, a in cache.items()},
                                      jnp.asarray(token), jnp.asarray(pos), jc)
    tcache = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    tlog, tcache = lm.decode_step(tp, tcache, torch.from_numpy(token),
                                  torch.from_numpy(pos) if vector else pos, tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5, rtol=2e-5)
    for k in cache:
        t, j = tcache[k].numpy(), np.asarray(jcache[k])
        if t.dtype == np.int8:          # a rounding tie may land one step apart
            assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1, k
        else:
            np.testing.assert_allclose(t, j, atol=2e-5, rtol=2e-5, err_msg=k)


def _requests(cls, vocab, seed=12, n=6):
    """Mixed prompt lengths; one single-token budget (finished at fill time)."""
    rng = np.random.default_rng(seed)
    reqs = [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 20))).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 14))) for i in range(n)]
    reqs[3].max_new_tokens = 1
    return reqs


@pytest.mark.parametrize("arch,cadence", [("mamba2-1.3b", 1), ("mamba2-1.3b", 8),
                                          ("smollm-135m", 1)])
def test_dense_cache_engine_matches_jax_engine(arch, cadence):
    """The dense-cache fallback (mamba2 always; smollm with paged=False):
    identical outputs, step counts after every step, completion order and
    prefill occupancy; scores within 1e-4."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServeConfig as JaxServeConfig
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    jc, tc, jm, jp, tp = torch_pair(arch)
    kw = dict(max_batch=4, max_len=64, paged=False)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = ServingEngine(build_model(tc, device="cpu"), tp, ServeConfig(**kw), device="cpu")
    assert not teng.paged and not teng.chunked and teng.kv is None
    for r in _requests(JaxRequest, jc.vocab):
        jeng.submit(r)
    for r in _requests(Request, tc.vocab):
        teng.submit(r)
    while jeng.queue or jeng.active:
        jeng.step(now=0.0, decode_steps=cadence)
        teng.step(now=0.0, decode_steps=cadence)
        assert sorted(teng.active) == sorted(jeng.active)
        assert teng.step_count == jeng.step_count
        np.testing.assert_array_equal(teng.pos, jeng.pos)
    assert not teng.queue and not teng.active
    assert teng.prefill_occupancy == jeng.prefill_occupancy == 1.0
    assert [r.rid for r in teng.completed] == [r.rid for r in jeng.completed]
    jout = {r.rid: r for r in jeng.completed}
    for r in teng.completed:
        assert r.output == jout[r.rid].output, r.rid
        assert len(r.output) == r.max_new_tokens
        assert abs(r.score - jout[r.rid].score) < 1e-4
    with pytest.raises(RuntimeError, match="migration"):
        teng.export_request(0)


def test_dense_cache_engine_empty_active_guard():
    """As tests/test_decode_loop.py's guard: decoding with an empty active
    set returns (0 served, 0 iters) untouched; a step with nothing queued is
    a no-op."""
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServingEngine
    for arch in ("smollm-135m", "mamba2-1.3b"):
        _, tc, _, _, tp = torch_pair(arch)
        eng = ServingEngine(build_model(tc, device="cpu"), tp,
                            ServeConfig(max_batch=2, max_len=32, paged=False), device="cpu")
        assert eng._decode_all_dense(now=0.0) == (0, 0)
        assert eng.step(now=0.0) == 0 and eng.step_count == 0
        with pytest.raises(ValueError):
            eng.step(now=0.0, decode_steps=eng.decode_steps + 1)


def test_hybrid_engine_is_refused():
    """The reference engine cannot serve the hybrid (its decode_step takes one
    position for all rows); the port refuses it up front."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServingEngine
    model = build_model(get_smoke_config("zamba2-2.7b"), device="cpu")
    with pytest.raises(NotImplementedError, match="one position for all rows"):
        ServingEngine(model, model.init_params(0), ServeConfig(max_len=64), device="cpu")


def test_mamba_serve_backend_matches_jax():
    """The paper's loop on the dense-cache engine: appdata over the same
    requests gives the same completions, slot trajectory and decision log
    as the JAX stack."""
    from repro.core.scaling import make_policy as jax_make_policy
    from repro.launch.serve import ServeBackend as JaxServeBackend
    from repro.serving import Request as JaxRequest
    from repro.serving import ServeConfig as JaxServeConfig
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.core.scaling import make_policy
    from repro_torch.data import request_stream
    from repro_torch.launch.serve import ServeBackend
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    jc, tc, jm, jp, tp = torch_pair("mamba2-1.3b")
    stream = request_stream(n_requests=8, seed=0, mean_prompt=8, mean_decode=8,
                            burst_times=(10.0,), horizon_s=20.0)

    def reqs(cls):      # short prompts: each new length costs a JAX prefill compile
        return [cls(rid=i, arrival_s=t,
                    prompt=np.random.default_rng(i).integers(0, jc.vocab, min(p, 12)).astype(np.int32),
                    max_new_tokens=max(min(d, 16), 1)) for i, (t, p, d) in enumerate(stream)]

    kw = dict(max_batch=4, max_len=64, decode_steps=1)
    bkw = dict(sla_s=20.0, horizon_s=20.0, stall_steps=50.0, decode_steps=1)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    jrep = JaxServeBackend(jeng, reqs(JaxRequest), policy=jax_make_policy("appdata"),
                           **bkw).run()
    teng = ServingEngine(build_model(tc, device="cpu"), tp, ServeConfig(**kw), device="cpu")
    trep = ServeBackend(teng, reqs(Request), policy=make_policy("appdata"), **bkw).run()
    assert trep.n_done == jrep.n_done == len(stream)
    assert {r.rid: r.output for r in teng.completed} == \
           {r.rid: r.output for r in jeng.completed}
    np.testing.assert_array_equal(trep.units_t, jrep.units_t)
    np.testing.assert_array_equal(trep.latencies, jrep.latencies)
    assert [dataclasses.asdict(d) for d in trep.decisions] == \
           [dataclasses.asdict(d) for d in jrep.decisions]
    assert trep.extra == jrep.extra


def test_serve_cli_mamba_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve_main
    assert serve_main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                       "--requests", "6", "--horizon", "10", "--policy", "appdata"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"completed (\d+)/\1 requests", out) and "page size -" in out
