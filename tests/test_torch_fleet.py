"""The port's replica fleet on the CPU (plain versions, float32): the eight
scenarios of tests/test_fleet.py run on ``repro_torch.serving.fleet``, and
the six checks of tests/test_chaos.py run on the port's copy of
``core/chaos``.  Port only: no JAX here (tests/test_torch_fleet_parity.py
holds the port against the JAX package).  The heal test and the chaos
drill book configured provisioning delays (``calibrate=False``), so their
plan clocks do not follow the machine's load."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.autoscaler.base import Decision, Policy
from repro_torch.core.chaos import (
    ChaosAction,
    ChaosDrill,
    ChaosScript,
    Violation,
    check_audit,
    check_exactly_once,
    check_kv_conservation,
    check_outputs_match,
)
from repro_torch.core.convergence import (
    AuditLog,
    Converger,
    ConvergerConfig,
    DesiredGroup,
    PoolTarget,
    ScriptedFault,
    ScriptedFaults,
)
from repro_torch.core.scaling import CapacityPlan, Sla, UnitPool
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.fleet import (
    FLEET_POOL,
    FleetBackend,
    FleetExecutor,
    FleetRouter,
    ReplicaPool,
)


@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    """One model + checkpoint shared by every spawn in this module."""
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    mgr = CheckpointManager(str(tmp_path_factory.mktemp("fleet-ckpt")), keep=2,
                            async_save=False)
    mgr.save(params, step=1)
    return cfg, model, mgr


def _make_pool(fleet_env, n_replicas, **cfg_kw):
    cfg, model, mgr = fleet_env
    serve_cfg = ServeConfig(max_batch=cfg_kw.pop("max_batch", 4),
                            max_len=cfg_kw.pop("max_len", 128),
                            decode_steps=4, **cfg_kw)
    pool = ReplicaPool(model, mgr, serve_cfg)
    for _ in range(n_replicas):
        rep, _ = pool.spawn()
        pool.serving.append(rep)
    return cfg, pool


def _requests(cfg, rng, n, *, arrival=lambda i: 0.0, decode=lambda i: 6):
    return [Request(rid=i, arrival_s=arrival(i),
                    prompt=rng.integers(0, cfg.vocab,
                                        8 + (i % 3) * 8).astype(np.int32),
                    max_new_tokens=decode(i)) for i in range(n)]


class _Hold(Policy):
    """Votes zero delta forever: the only scaling left is fault healing."""

    name = "hold"

    def reset(self):
        pass

    def decide(self, obs):
        return Decision(0, "hold")

    def describe(self):
        return "hold"


def test_spawn_places_the_checkpoint_and_splits_its_time(fleet_env):
    """A spawn loads the manager's latest checkpoint onto the model's device
    at the model's dtype, runs its two probe waves, and its measured seconds
    split into load, place, build and probe."""
    cfg, pool = _make_pool(fleet_env, 1)
    rep = pool.serving[0]
    assert rep.spawn_s > 0.0
    assert set(rep.spawn_parts) == {"load_s", "place_s", "build_s", "probe_s"}
    assert abs(sum(rep.spawn_parts.values()) - rep.spawn_s) < 1e-6
    ref = pool.model.init_params(0)
    assert torch.equal(rep.eng.params["embed"], ref["embed"])
    assert rep.eng.params["embed"].dtype == torch.float32
    assert not rep.eng.completed and not rep.eng.n_in_system
    rep.eng.kv.check_invariants()


def test_single_replica_fleet_matches_bare_engine(fleet_env):
    """The router + one replica admits and emits exactly what the bare
    engine does under the same virtual-time stepping."""
    cfg, pool = _make_pool(fleet_env, 1)
    bare = ServingEngine(pool.model, pool.serving[0].eng.params, pool.serve_cfg,
                         device="cpu")
    rng = np.random.default_rng(7)
    reqs_fleet = _requests(cfg, rng, 10, arrival=lambda i: float(i // 3),
                           decode=lambda i: 4 + i % 5)
    rng = np.random.default_rng(7)
    reqs_bare = _requests(cfg, rng, 10, arrival=lambda i: float(i // 3),
                          decode=lambda i: 4 + i % 5)

    router = FleetRouter(pool)
    replica = pool.serving[0]
    probe_steps = replica.eng.step_count          # the spawn's two probe waves
    assert probe_steps > 0
    heads = [0, 0]
    for t in range(200):
        while heads[0] < len(reqs_fleet) and reqs_fleet[heads[0]].arrival_s <= t:
            router.submit(reqs_fleet[heads[0]])
            heads[0] += 1
        router.dispatch(float(t))
        replica.step(float(t), decode_steps=2)
        while heads[1] < len(reqs_bare) and reqs_bare[heads[1]].arrival_s <= t:
            bare.submit(reqs_bare[heads[1]])
            heads[1] += 1
        bare.step(now=float(t), decode_steps=2)
        if not router.backlog and not replica.eng.n_in_system and not bare.n_in_system:
            break
    else:
        raise AssertionError("fleet or bare engine failed to drain")

    fleet_done = [(r.rid, list(r.output), r.done_s) for r in replica.eng.completed]
    bare_done = [(r.rid, list(r.output), r.done_s) for r in bare.completed]
    assert fleet_done == bare_done               # tokens, done_s, completion order
    assert replica.eng.step_count - probe_steps == bare.step_count
    replica.eng.kv.check_invariants()


def test_drain_migration_bit_identical_and_conserves_pages(fleet_env):
    """Mid-decode drain: every in-flight request resumes on the survivor
    with bit-identical tokens, and page free-lists conserve on BOTH sides."""
    cfg, pool = _make_pool(fleet_env, 2)
    rng = np.random.default_rng(3)
    reqs = _requests(cfg, rng, 8, decode=lambda i: 6 + i % 4)
    rng = np.random.default_rng(3)
    ref_reqs = _requests(cfg, rng, 8, decode=lambda i: 6 + i % 4)

    ref = ServingEngine(pool.model, pool.serving[0].eng.params, pool.serve_cfg,
                        device="cpu")
    for r in ref_reqs:
        ref.submit(r)
    ref.run_until_drained()
    reference = {r.rid: list(r.output) for r in ref.completed}

    router = FleetRouter(pool)
    for r in reqs:
        router.submit(r)
    for t in range(3):
        router.dispatch(float(t))
        for rep in pool.serving:
            rep.step(float(t), decode_steps=2)
    victim = pool.serving[-1]
    assert victim.eng.active, "nothing mid-decode: the drill is vacuous"
    assert any(victim.eng.pos[s] > 0 for s in victim.eng.active), \
        "no committed KV to migrate"
    free_before = int(victim.eng.kv.n_free)
    held_before = int(victim.eng.kv.held.sum())
    pool.drain(victim)
    assert int(victim.eng.kv.held.sum()) == 0
    assert int(victim.eng.kv.worst.sum()) == 0
    assert victim.eng.kv.n_free == free_before + held_before
    victim.eng.kv.check_invariants()

    for t in range(3, 300):
        router.dispatch(float(t))
        for rep in pool.serving:
            rep.step(float(t), decode_steps=2)
        if not router.backlog and not any(r.eng.n_in_system for r in pool.serving):
            break
    pool.serving[0].eng.kv.check_invariants()
    done = {r.rid: list(r.output)
            for rep in pool.serving + pool.retired for r in rep.eng.completed}
    assert done == reference


def test_measured_delay_lands_in_run_report(fleet_env):
    """The RunReport's provisioning delay is measured at spawn, not the
    configured guess."""
    cfg, pool = _make_pool(fleet_env, 0)
    rng = np.random.default_rng(5)
    reqs = _requests(cfg, rng, 8, arrival=lambda i: float(i // 4), decode=lambda i: 4)
    be = FleetBackend(pool, reqs, sla_s=30.0, horizon_s=10.0,
                      starting_replicas=1, max_replicas=2,
                      provision_delay_s=123.0, adapt_period_s=2.0,
                      app_window_s=4.0, decode_steps=2)
    rep = be.run()
    assert rep.n_done == len(reqs)
    measured = rep.pool_provision_delay_s.get(FLEET_POOL)
    assert measured is not None and 0.0 < measured < 123.0
    assert rep.summary()["measured_delay_s.replica"] == measured


def test_router_sheds_cheapest_class_first(fleet_env):
    """Under pressure the queue serves strictest absolute deadline first, so
    the cheapest class (longest deadline) is the one that waits."""
    cfg, pool = _make_pool(fleet_env, 1, max_batch=2)
    sla = Sla(default_s=100.0, per_class={"p32d16": 5.0})
    router = FleetRouter(pool, sla=sla)
    rng = np.random.default_rng(9)
    blockers = [
        Request(rid=0, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                max_new_tokens=2),
        Request(rid=1, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                max_new_tokens=40),
    ]
    for b in blockers:
        router.submit(b)
    router.dispatch(0.0)
    pool.serving[0].step(0.0, decode_steps=1)
    assert len(pool.serving[0].eng.active) == 2
    cheap = Request(rid=2, arrival_s=1.0,
                    prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    max_new_tokens=4)
    premium = Request(rid=3, arrival_s=1.0,
                      prompt=rng.integers(0, cfg.vocab, 24).astype(np.int32),
                      max_new_tokens=4)
    router.submit(cheap)
    router.submit(premium)
    router.dispatch(1.0)
    assert [r.rid for r in router.queue] == [3, 2], "queue is not deadline-ordered"
    for t in range(2, 20):     # rid 0 finishes, freeing exactly one slot
        pool.serving[0].step(float(t), decode_steps=2)
        if 0 in {r.rid for r in pool.serving[0].eng.completed}:
            break
    router.dispatch(float(t))
    pool.serving[0].step(float(t), decode_steps=1)
    active_rids = {r.rid for r in pool.serving[0].eng.active.values()}
    assert 3 in active_rids, "premium class did not preempt the cheap one"
    assert [r.rid for r in router.queue] == [2], "cheap class should shed"


def test_kill_requeues_at_original_deadline(fleet_env):
    """A killed replica's restarted requests re-enter the deadline queue at
    their ORIGINAL deadline: re-admission must not jump a premium request
    that arrived later with a tighter absolute deadline."""
    cfg, pool = _make_pool(fleet_env, 2, max_batch=1)
    sla = Sla(default_s=100.0, per_class={"p32d16": 5.0})
    router = FleetRouter(pool, sla=sla)
    rng = np.random.default_rng(13)
    blocker = Request(rid=0, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                      max_new_tokens=40)
    cheap = Request(rid=1, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    max_new_tokens=16)           # p16d16 -> 100 s deadline
    router.submit(blocker)
    router.submit(cheap)
    router.dispatch(0.0)
    for rep in pool.serving:
        rep.step(0.0, decode_steps=1)
    victim = next(r for r in pool.serving
                  if 1 in {q.rid for q in r.eng.active.values()})
    pool.kill(victim)                            # cheap restarts from scratch
    assert pool.migrated and pool.migrated[0].req.rid == 1
    premium = Request(rid=2, arrival_s=1.0,
                      prompt=rng.integers(0, cfg.vocab, 24).astype(np.int32),
                      max_new_tokens=16)         # p32d16 -> deadline 6 s
    router.submit(premium)
    router.dispatch(1.0)
    assert not pool.migrated
    assert [r.rid for r in router.queue] == [2, 1]
    for t in range(2, 60):                       # blocker frees the only slot
        pool.serving[0].step(float(t), decode_steps=2)
        if 0 in {r.rid for r in pool.serving[0].eng.completed}:
            break
    router.dispatch(float(t))
    pool.serving[0].step(float(t), decode_steps=1)
    active_rids = {r.rid for r in pool.serving[0].eng.active.values()}
    assert 2 in active_rids, "crash restart outranked the premium class"
    assert [r.rid for r in router.queue] == [1]


def test_converger_heals_killed_replica(fleet_env):
    """Abrupt replica loss mid-run: the plan records the unit loss and the
    converger heals it with a REAL respawn; every request (including the
    killed replica's restarted in-flights) still completes."""
    cfg, pool = _make_pool(fleet_env, 0)
    rng = np.random.default_rng(11)
    reqs = _requests(cfg, rng, 14, arrival=lambda i: float(i // 2),
                     decode=lambda i: 5 + i % 4)
    killed = []

    def kill_once(be, t):
        if t == 3.0 and not killed:
            victim = be.pool.serving[-1]
            killed.append(victim.rix)
            be.kill_replica(victim, t)

    be = FleetBackend(pool, reqs, sla_s=60.0, horizon_s=10.0,
                      policy=_Hold(), starting_replicas=2, max_replicas=3,
                      adapt_period_s=2.0, app_window_s=4.0, decode_steps=2,
                      calibrate=False, on_step=kill_once)
    rep = be.run()
    assert killed, "the drill never fired"
    assert rep.n_done == len(reqs)
    assert len(pool.serving) == 2, "fleet did not heal back to desired size"
    assert pool._next_rix >= 3, "healing never spawned a replacement"
    assert be.controller.plan.meters()[FLEET_POOL].lost == 1
    for r in pool.serving:
        r.eng.kv.check_invariants()


def test_executor_books_stuck_spawn_and_cancels_it_first(fleet_env):
    """A spawn that raises becomes a measured stuck build; cancel takes the
    stuck book entry before discarding healthy provisioning replicas."""
    cfg, pool = _make_pool(fleet_env, 0)
    outcomes = iter([True, False])      # first spawn fails, second succeeds
    pool.spawn_fault = lambda: next(outcomes, False)
    plan = CapacityPlan((UnitPool(FLEET_POOL, provision_delay_s=5.0,
                                  max_units=4),), starting_units=0)
    ex = FleetExecutor(pool, plan)
    assert ex.launch(FLEET_POOL, 2, now=0.0) == 2
    assert ex._stuck == 1 and len(pool.provisioning) == 1
    assert plan.report_kwargs()["pool_provision_delay_s"][FLEET_POOL] > 0.0
    assert ex.cancel_pending(FLEET_POOL, 1, now=1.0) == 1
    assert ex._stuck == 0 and len(pool.provisioning) == 1
    assert ex.cancel_pending(FLEET_POOL, 1, now=2.0) == 1
    assert not pool.provisioning and len(pool.retired) == 1


def test_chaos_drill_kill_under_load_is_observationally_equivalent(fleet_env, tmp_path):
    """End-to-end ChaosDrill over real port engines: a replica killed under
    burst load heals, and exactly-once, bit-identical outputs against the
    fault-free reference, KV page conservation and the sealed audit replay
    all hold."""
    def make_backend(*, on_step, audit_path):
        cfg, pool = _make_pool(fleet_env, 0)
        rng = np.random.default_rng(21)
        reqs = _requests(cfg, rng, 10, arrival=lambda i: float(i // 2),
                         decode=lambda i: 4 + i % 3)
        return FleetBackend(pool, reqs, sla_s=60.0, horizon_s=8.0,
                            policy=_Hold(), starting_replicas=2,
                            max_replicas=3, adapt_period_s=2.0,
                            app_window_s=4.0, decode_steps=2,
                            calibrate=False, on_step=on_step,
                            audit_path=audit_path)

    script = ChaosScript([ChaosAction(3.0, "kill", count=1)], seed=5)
    drill = ChaosDrill("kill-under-load", make_backend, script,
                       audit_path=str(tmp_path / "drill.jsonl"))
    report = drill.run()
    assert report.fired and report.fired[0]["kind"] == "kill"
    assert report.n_completed == 10 == report.n_reference
    assert report.ok, report.summary()


def test_latest_skips_torn_checkpoints_and_gc_keeps_the_newest(tmp_path, fleet_env):
    """The manager restores the newest checkpoint that has its ``.ok``
    marker, and rotation keeps ``keep`` of them."""
    cfg, model, _ = fleet_env
    params = model.init_params(1)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for step in (1, 2, 3):
        mgr.save(params, step=step)
    mgr.wait()
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "ckpt_00000002.npz", "ckpt_00000003.npz"]
    (tmp_path / "ckpt_00000003.npz.ok").unlink()          # torn mid-save
    assert mgr.latest().endswith("ckpt_00000002.npz")
    restored, meta = mgr.restore_latest(device="cpu")
    assert meta == {"step": 2}
    assert torch.equal(restored["blocks"][1]["mlp"]["w_up"],
                       params["blocks"][1]["mlp"]["w_up"])
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(device="cpu") == (None, {})


def test_serve_cli_fleet_mode_runs_on_cpu(capsys):
    """``--replicas N`` serves through the fleet on the plain versions when
    the caller asks for the CPU; the bucketed path cannot migrate, so the
    CLI refuses the pair."""
    assert serve_main(["--smoke", "--device", "cpu", "--replicas", "3",
                       "--requests", "12", "--horizon", "12"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"fleet completed (\d+)/\1 requests .* on cpu", out)
    delay = float(re.search(r"measured provisioning delay ([0-9.]+)s", out).group(1))
    assert delay > 0.0 and "replicas peak" in out
    assert serve_main(["--smoke", "--device", "cpu", "--replicas", "2", "--bucketed"]) == 2


# ---------------------------------------------------------------------------------
# tests/test_chaos.py's checks on the port's copy of core/chaos
# ---------------------------------------------------------------------------------

class _FakeReplica:
    def __init__(self, rix):
        self.rix = rix


class _FakePool:
    def __init__(self, n):
        self.serving = [_FakeReplica(i) for i in range(n)]


class _FakeTarget:
    """Duck-typed drill target: records every actuation in order."""

    def __init__(self, n_replicas):
        self.pool = _FakePool(n_replicas)
        self.calls = []

    def kill_replica(self, rep, now):
        self.pool.serving.remove(rep)
        self.calls.append(("kill", rep.rix, now))

    def fire_webhook(self, name, now):
        self.calls.append(("webhook", name, now))


class _Req:
    def __init__(self, rid, output=(1, 2, 3), done_s=5.0):
        self.rid = rid
        self.output = list(output)
        self.done_s = done_s


def test_chaos_action_validation():
    with pytest.raises(ValueError, match="unknown action kind"):
        ChaosAction(0.0, "explode")
    with pytest.raises(ValueError, match="needs a name"):
        ChaosAction(0.0, "webhook")
    with pytest.raises(ValueError, match="frac"):
        ChaosAction(0.0, "corr_kill", frac=0.0)
    with pytest.raises(ValueError, match="at_s"):
        ChaosAction(-1.0, "kill")
    with pytest.raises(TypeError):
        ChaosScript([object()])


def test_script_fires_in_order_and_replays_identically():
    script = ChaosScript([
        ChaosAction(4.0, "webhook", name="surge"),
        ChaosAction(4.0, "kill", count=1),
        ChaosAction(7.5, "corr_kill", frac=0.5),
    ], seed=11)
    assert [a.kind for a in script.actions] == ["kill", "webhook", "corr_kill"]

    def run():
        target = _FakeTarget(5)
        for t in range(10):
            script.on_step(target, float(t))
        return target.calls

    first = run()
    assert script.done
    assert [c[0] for c in first][:2] == ["kill", "webhook"]
    assert len([c for c in first if c[0] == "kill" and c[2] == 4.0]) == 1
    corr = [c for c in first if c[2] == 8.0]
    assert len(corr) == 2 and all(c[0] == "kill" for c in corr)
    fired = list(script.fired)
    script.reset()
    assert run() == first
    assert script.fired == fired


def test_exactly_once_checker_catches_loss_dupes_phantoms():
    ok = [_Req(0), _Req(1)]
    assert check_exactly_once([0, 1], ok) == []
    assert check_exactly_once([0, 1, 2], ok, final=False) == []
    lost = check_exactly_once([0, 1, 2], ok)
    assert len(lost) == 1 and "never completed" in lost[0].detail
    dup = check_exactly_once([0, 1], ok + [_Req(1)])
    assert any("2 times" in v.detail for v in dup)
    phantom = check_exactly_once([0], ok)
    assert any("never admitted" in v.detail for v in phantom)
    hollow = check_exactly_once([0], [_Req(0, output=())])
    assert any("without output" in v.detail for v in hollow)


def test_outputs_match_checker_reports_first_divergence():
    ref = [_Req(0, output=(1, 2, 3)), _Req(1, output=(4, 5))]
    assert check_outputs_match([_Req(0), _Req(1, output=(4, 5))], ref) == []
    bad = check_outputs_match([_Req(0, output=(1, 9, 3))], ref)
    assert len(bad) == 1 and "token 1" in bad[0].detail
    trunc = check_outputs_match([_Req(1, output=(4,))], ref)
    assert len(trunc) == 1 and "token 1" in trunc[0].detail
    orphan = check_outputs_match([_Req(7)], ref)
    assert len(orphan) == 1 and "no fault-free reference" in orphan[0].detail
    assert str(bad[0]).startswith("bit_identical:")
    assert isinstance(bad[0], Violation)


def test_check_audit_layers(tmp_path):
    path = str(tmp_path / "a.jsonl")
    plan = CapacityPlan(
        (UnitPool("od", provision_delay_s=2.0, max_units=8),),
        starting_units=1,
        faults=ScriptedFaults((ScriptedFault(3.0, "lose", pool="od"),)))
    conv = Converger(plan, ConvergerConfig(build_timeout_s=10.0), audit=AuditLog(path))
    conv.audit.append(0.0, "init", pools={"od": 1})
    conv.set_desired(DesiredGroup({"od": PoolTarget(3, 1, 8)}), 0.0)
    t = 0.0
    for _ in range(20):
        plan.land(t)
        conv.converge(t)
        t += 1.0
    conv.audit.seal(t)
    conv.audit.close()
    final = {"od": {"live": plan.live_of("od"), "pending": plan.pending_of("od")}}
    assert check_audit(path, final) == []
    drifted = {"od": {"live": final["od"]["live"] + 1, "pending": 0}}
    assert any("replay gives" in v.detail for v in check_audit(path, drifted))
    with open(path) as fh:
        lines = fh.read().splitlines()
    p2 = str(tmp_path / "torn.jsonl")
    with open(p2, "w") as fh:
        fh.write("\n".join(lines[:-1]) + "\n")
    broken = check_audit(p2)
    assert len(broken) == 1 and broken[0].invariant == "audit_replay"
    assert "seal" in broken[0].detail


def test_kv_conservation_checker_skips_killed_replicas():
    class _KV:
        def __init__(self, n_free, num_pages, fail=False):
            self.n_free = n_free
            self.num_pages = num_pages
            self.fail = fail

        def check_invariants(self):
            assert not self.fail, "page leak"

    class _Eng:
        def __init__(self, kv):
            self.kv = kv

    class _Rep:
        def __init__(self, rix, kv, draining=False):
            self.rix = rix
            self.eng = _Eng(kv)
            self.draining = draining

    class _Pool:
        def __init__(self, serving, retired):
            self.serving = serving
            self.retired = retired

    healthy = _Pool([_Rep(0, _KV(9, 10))], [])
    assert check_kv_conservation(healthy, drained=True) == []
    leaky = _Pool([_Rep(0, _KV(5, 10, fail=True))], [])
    assert any("page leak" in v.detail for v in check_kv_conservation(leaky))
    held = _Pool([_Rep(0, _KV(7, 10))], [])
    assert check_kv_conservation(held) == []
    assert any("still held" in v.detail for v in check_kv_conservation(held, drained=True))
    stranded = _Pool([], [_Rep(1, _KV(6, 10), draining=True),
                          _Rep(2, _KV(0, 10), draining=False)])
    out = check_kv_conservation(stranded)
    assert len(out) == 1 and "stranded 3 pages" in out[0].detail
