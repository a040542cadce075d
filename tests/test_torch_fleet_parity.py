"""The port's checkpoints, remesh stand-in and replica fleet against the JAX
package on the CPU (float32 for the fleet; f32 and bf16 for checkpoints).

* checkpoints go both ways bit for bit, ``.ok`` marker and torn-file skip
  included;
* ``repro_torch.core.elastic.remesh`` keeps the JAX module's plan and
  refuses what would need sharding;
* one scenario -- two replicas spawned from one JAX-written checkpoint, a
  hold policy, configured delays (``calibrate=False``), a kill at t = 3 --
  gives the same completions, tokens, ``done_s``, replica trajectory,
  decision log and migrated backlog in both fleets;
* a mid-decode drain migrates to the same per-request tokens in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.autoscaler.base import Decision as JaxDecision
from repro.core.autoscaler.base import Policy as JaxPolicy
from repro.core.chaos import ChaosAction as JaxChaosAction
from repro.core.chaos import ChaosScript as JaxChaosScript
from repro.core.elastic.remesh import elastic_remesh_plan as jax_remesh_plan
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.fleet import FleetBackend as JaxFleetBackend
from repro.serving.fleet import FleetRouter as JaxFleetRouter
from repro.serving.fleet import ReplicaPool as JaxReplicaPool

from repro_torch.checkpoint import (
    OK_SUFFIX,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_smoke_config
from repro_torch.core.autoscaler.base import Decision, Policy
from repro_torch.core.chaos import ChaosAction, ChaosScript
from repro_torch.core.elastic import elastic_remesh_plan
from repro_torch.core.elastic.remesh import (
    measure_provision_delay,
    remesh_params,
    scale_replicas,
)
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeConfig
from repro_torch.serving.fleet import FleetBackend, FleetRouter, ReplicaPool

ARCH = "smollm-135m"


def _port_leaves(params) -> dict[str, torch.Tensor]:
    """{tree path: tensor}, block leaves stacked on a leading layer dim (the
    layout the JAX tree and the checkpoint file share)."""
    def walk(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/", out)
            else:
                out[prefix + k] = v
        return out

    flat = walk({k: v for k, v in params.items() if k != "blocks"}, "", {})
    layers = [walk(layer, "", {}) for layer in params["blocks"]]
    for key in layers[0]:
        flat["blocks/" + key] = torch.stack([layer[key] for layer in layers])
    return flat


def _jax_leaves(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits_t(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _bits_j(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(port_params, jax_tree):
    tl, jl = _port_leaves(port_params), _jax_leaves(jax_tree)
    assert sorted(tl) == sorted(jl)
    for key, a in jl.items():
        t = tl[key]
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, key
        np.testing.assert_array_equal(_bits_t(t), _bits_j(a), err_msg=key)


def _configs(dtype: str):
    jc, tc = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    if dtype == "float32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


# ---------------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_bit_exact_in_the_port(tmp_path, dtype):
    jc, tc = _configs(dtype)
    jp = jax_build_model(jc).init_params(jax.random.key(3))
    mgr = JaxCheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(jp, step=1)
    mgr.save(jp, step=2, extra={"note": "torn"})
    torn = tmp_path / "ckpt_00000002.npz"
    (tmp_path / ("ckpt_00000002.npz" + OK_SUFFIX)).unlink()   # torn mid-save
    port_mgr = CheckpointManager(str(tmp_path))
    assert port_mgr.latest() == str(tmp_path / "ckpt_00000001.npz")
    params, meta = port_mgr.restore_latest(device="cpu")
    assert meta == {"step": 1}
    _assert_bit_equal(params, jp)
    # the torn file itself is intact here: it is skipped for its marker alone
    params2, meta2 = load_checkpoint(str(torn), device="cpu")
    assert meta2 == {"step": 2, "note": "torn"}
    _assert_bit_equal(params2, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_bit_exact_in_jax(tmp_path, dtype):
    jc, tc = _configs(dtype)
    tp = build_model(tc, device="cpu").init_params(5)
    path = save_checkpoint(str(tmp_path / "ckpt_00000007.npz"), tp, step=7,
                           extra={"by": "port"})
    assert (tmp_path / ("ckpt_00000007.npz" + OK_SUFFIX)).exists()
    assert JaxCheckpointManager(str(tmp_path)).latest() == path
    jtree, meta = jax_load_checkpoint(path, jax_build_model(jc).abstract_params())
    assert meta == {"step": 7, "by": "port"}
    _assert_bit_equal(tp, jtree)
    # a torn port file is skipped by the JAX manager too
    CheckpointManager(str(tmp_path), async_save=False).save(tp, step=8)
    (tmp_path / ("ckpt_00000008.npz" + OK_SUFFIX)).unlink()
    assert JaxCheckpointManager(str(tmp_path)).latest() == path


def test_load_checkpoint_checks_the_expected_shapes(tmp_path):
    _, tc = _configs("float32")
    tp = build_model(tc, device="cpu").init_params(0)
    path = save_checkpoint(str(tmp_path / "c.npz"), tp)
    params, _ = load_checkpoint(path, tp, device="cpu")
    got = _port_leaves(params)
    assert all(torch.equal(got[k], t) for k, t in _port_leaves(tp).items())
    wide = build_model(dataclasses.replace(tc, d_model=2 * tc.d_model),
                       device="cpu").init_params(0)
    with pytest.raises(ValueError, match="shape mismatch for embed"):
        load_checkpoint(path, wide, device="cpu")


# ---------------------------------------------------------------------------------
# remesh
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("n,tp", [(1, 1), (8, 1), (8, 2), (8, 4), (6, 3)])
def test_elastic_remesh_plan_matches_jax(n, tp):
    assert elastic_remesh_plan(n, model_parallel=tp) == jax_remesh_plan(n, model_parallel=tp)


def test_elastic_remesh_plan_rejects_what_jax_rejects():
    for fn in (elastic_remesh_plan, jax_remesh_plan):
        with pytest.raises(ValueError, match="not divisible"):
            fn(6, model_parallel=4)


def test_scale_replicas_places_a_copy_and_refuses_sharding():
    _, tc = _configs("float32")
    model = build_model(tc, device="cpu")
    tp = model.init_params(0)
    devices, placed = scale_replicas(tp, devices=[torch.device("cpu")])
    assert devices == [torch.device("cpu")]
    src, dst = _port_leaves(tp), _port_leaves(placed)
    for key, t in src.items():
        assert dst[key].device == torch.device("cpu")
        assert torch.equal(dst[key], t)
    for layer_src, layer_dst in zip(tp["blocks"], placed["blocks"]):
        assert layer_dst["wq"].data_ptr() != layer_src["wq"].data_ptr()   # a copy
    assert remesh_params(tp, "cpu")["embed"].data_ptr() != tp["embed"].data_ptr()
    with pytest.raises(NotImplementedError, match="item 8"):
        scale_replicas(tp, devices=["cpu"], model_parallel=2)
    with pytest.raises(NotImplementedError, match="item 8"):
        scale_replicas(tp, devices=["cpu", "cpu"])
    secs, devices, placed = measure_provision_delay(
        model, tp, devices=["cpu"], model_parallel=1)
    assert secs > 0.0 and torch.equal(placed["ln_f"], tp["ln_f"])


# ---------------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------------

class _Hold(Policy):
    name = "hold"

    def reset(self):
        pass

    def decide(self, obs):
        return Decision(0, "hold")

    def describe(self):
        return "hold"


class _JaxHold(JaxPolicy):
    name = "hold"

    def reset(self):
        pass

    def decide(self, obs):
        return JaxDecision(0, "hold")

    def describe(self):
        return "hold"


@pytest.fixture(scope="module")
def fleet_pair(tmp_path_factory):
    """(jax model, port model, one JAX-written float32 checkpoint)."""
    jc, tc = _configs("float32")
    jm = jax_build_model(jc)
    path = str(tmp_path_factory.mktemp("fleet-parity") / "ckpt_00000001.npz")
    jax_save_checkpoint(path, jm.init_params(jax.random.key(0)), step=1)
    return jm, build_model(tc, device="cpu"), path


def _requests(cls, vocab, n, *, arrival, decode, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, arrival_s=arrival(i),
                prompt=rng.integers(0, vocab, 8 + (i % 3) * 8).astype(np.int32),
                max_new_tokens=decode(i)) for i in range(n)]


SERVE_KW = dict(max_batch=4, max_len=128, decode_steps=4)


def test_fleet_under_a_kill_matches_jax(fleet_pair):
    jm, tm, path = fleet_pair
    runs = {}
    for name, pool_cls, cfg_cls, req_cls, be_cls, policy, action, script_cls, model in (
            ("jax", JaxReplicaPool, JaxServeConfig, JaxRequest, JaxFleetBackend,
             _JaxHold(), JaxChaosAction, JaxChaosScript, jm),
            ("torch", ReplicaPool, ServeConfig, Request, FleetBackend,
             _Hold(), ChaosAction, ChaosScript, tm)):
        script = script_cls([action(3.0, "kill", count=1)], seed=5)
        pool = pool_cls(model, path, cfg_cls(**SERVE_KW))
        reqs = _requests(req_cls, tm.cfg.vocab, 10, arrival=lambda i: float(i // 2),
                         decode=lambda i: 4 + i % 3, seed=21)
        be = be_cls(pool, reqs, sla_s=60.0, horizon_s=8.0, policy=policy,
                    starting_replicas=2, max_replicas=3, adapt_period_s=2.0,
                    app_window_s=4.0, decode_steps=2, calibrate=False,
                    on_step=script.on_step)
        rep = be.run()
        assert script.fired and script.fired[0]["kind"] == "kill"
        assert pool._next_rix >= 3, "no respawn after the kill"
        runs[name] = (rep, be, pool)
    (jrep, jbe, jpool), (trep, tbe, tpool) = runs["jax"], runs["torch"]
    assert trep.n_done == jrep.n_done == 10
    np.testing.assert_array_equal(trep.units_t, jrep.units_t)
    assert [dataclasses.asdict(d) for d in trep.decisions] == \
           [dataclasses.asdict(d) for d in jrep.decisions]
    assert [(r.rid, r.output, r.done_s) for r in tbe.completed] == \
           [(r.rid, r.output, r.done_s) for r in jbe.completed]
    np.testing.assert_array_equal(trep.latencies, jrep.latencies)
    assert trep.extra["migrated_backlog_peak"] == jrep.extra["migrated_backlog_peak"]
    assert sorted(trep.extra["per_replica"]) == sorted(jrep.extra["per_replica"])
    for name in jrep.extra["per_replica"]:
        assert trep.extra["per_replica"][name]["tokens"] == \
               jrep.extra["per_replica"][name]["tokens"], name
    assert [r.eng.step_count for r in tpool.serving + tpool.retired] == \
           [r.eng.step_count for r in jpool.serving + jpool.retired]


def test_drain_migration_matches_jax(fleet_pair):
    jm, tm, path = fleet_pair
    outs = {}
    for name, pool_cls, cfg_cls, req_cls, router_cls, model in (
            ("jax", JaxReplicaPool, JaxServeConfig, JaxRequest, JaxFleetRouter, jm),
            ("torch", ReplicaPool, ServeConfig, Request, FleetRouter, tm)):
        pool = pool_cls(model, path, cfg_cls(**SERVE_KW))
        for _ in range(2):
            rep, _ = pool.spawn()
            pool.serving.append(rep)
        router = router_cls(pool)
        for r in _requests(req_cls, tm.cfg.vocab, 8, arrival=lambda i: 0.0,
                           decode=lambda i: 6 + i % 4, seed=3):
            router.submit(r)
        for t in range(3):
            router.dispatch(float(t))
            for rep in pool.serving:
                rep.step(float(t), decode_steps=2)
        victim = pool.serving[-1]
        moved = sorted(r.rid for r in victim.eng.active.values())
        assert moved and any(victim.eng.pos[s] > 0 for s in victim.eng.active)
        pool.drain(victim)
        for t in range(3, 300):
            router.dispatch(float(t))
            for rep in pool.serving:
                rep.step(float(t), decode_steps=2)
            if not router.backlog and not any(r.eng.n_in_system for r in pool.serving):
                break
        for rep in pool.serving + pool.retired:
            rep.eng.kv.check_invariants()
            assert rep.eng.kv.n_free == rep.eng.kv.num_pages - 1
        outs[name] = (moved, {r.rid: (list(r.output), r.done_s)
                              for rep in pool.serving + pool.retired
                              for r in rep.eng.completed})
    assert outs["torch"] == outs["jax"]
