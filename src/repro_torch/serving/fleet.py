"""The replica fleet: an elastic pool of real ServingEngines actuated by the
convergence plane.

Counterpart of ``repro.serving.fleet``, with the same logic in the same
order.  Scale-up means a NEW engine spawned from a checkpoint with a
*measured* provisioning delay, and scale-down drains without dropping a
token.  Three parts:

* :class:`ReplicaPool` -- owns the lifecycle.  ``spawn`` loads the latest
  checkpoint (:mod:`repro_torch.checkpoint`), places the params on the
  model's device (:func:`repro_torch.core.elastic.remesh.scale_replicas`:
  on one card the replicas share it), builds a
  :class:`~repro_torch.serving.ServingEngine`, and warms it with two probe
  waves -- the wall clock of all of that, ended by a device synchronise,
  IS the provisioning delay the plan prices (`CapacityPlan.calibrate_delay`).
  ``drain`` stops admitting and migrates every in-flight request by
  exporting its committed KV pages + positions
  (:meth:`~repro_torch.serving.ServingEngine.export_request`) and
  re-admitting on a surviving replica -- the emitted tokens are
  bit-identical to an unmigrated run because the mixed loop's per-row
  arithmetic is independent of batch composition at fixed width.  ``kill``
  models abrupt unit loss: a dead host's KV cannot be exported, so its
  requests restart from scratch.  Migration needs the chunked paged engine,
  so every replica runs the mixed step.
* :class:`FleetRouter` -- the front door.  Admission is gated per replica
  (free slot under the cap AND page admission), least-loaded first; with an
  :class:`~repro_torch.core.scaling.capacity.Sla` the queue is served
  strictest deadline first, so the cheapest class (longest deadline) sheds
  -- waits -- first under page pressure.  Fleet-aggregated occupancy and
  queue depth feed SignalBus channels so the controller sees application
  data across replicas.
* :class:`FleetExecutor` -- the convergence binding.  ``LaunchUnit`` /
  ``DrainUnit`` / ``ReplaceUnhealthy`` steps actuate the ReplicaPool; the
  CapacityPlan ledger is kept in sync as a side effect, so step timeouts,
  stuck builds (a spawn that raises), and provisioning delays are MEASURED
  at the engine level, not injected.

:class:`FleetBackend` drives it all as a
:class:`~repro_torch.core.scaling.backend.ScalableBackend` (unit = replica)
over the same virtual-time step protocol as
:class:`repro_torch.launch.serve.ServeBackend`.  A single-replica fleet is
behaviorally identical to the bare engine (tests/test_torch_fleet.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.core.elastic.remesh import scale_replicas
from repro_torch.core.scaling import (
    ControllerConfig,
    RunReport,
    ScalingController,
    SignalBus,
    UnitPool,
    make_policy,
)
from repro_torch.serving.engine import (
    MigratedRequest, Request, ServeConfig, ServingEngine,
)

FLEET_POOL = "replica"

#: SignalBus channels a fleet backend records every virtual second
FLEET_CHANNELS = ("output_score", "fleet_occupancy", "fleet_queue_depth")


class Replica:
    """One live ServingEngine plus fleet bookkeeping (identity, health,
    and per-replica warm-throughput counters for the bench)."""

    def __init__(self, rix: int, eng: ServingEngine, spawn_s: float):
        self.rix = rix
        self.eng = eng
        self.spawn_s = spawn_s        # measured provisioning wall time
        self.healthy = True
        self.draining = False
        self.spawn_parts: dict[str, float] = {}   # spawn_s by phase
        self.busy_s = 0.0             # wall time spent inside step()
        self.tokens = 0               # tokens THIS replica emitted

    def step(self, now: float, decode_steps: int = 1) -> int:
        # no synchronise here: the engine's loop reads ``live.any()`` on the
        # host every iteration, so eng.step returns only after the device
        # finished its work and busy_s covers the device time
        t0 = time.perf_counter()
        before = self._emitted()
        served = self.eng.step(now=now, decode_steps=decode_steps)
        self.busy_s += time.perf_counter() - t0
        self.tokens += self._emitted() - before
        return served

    def _emitted(self) -> int:
        return (sum(len(r.output) for r in self.eng.completed)
                + sum(len(r.output) for r in self.eng.active.values()))

    @property
    def free_slots(self) -> int:
        return (min(self.eng.slot_limit, self.eng.cfg.max_batch)
                - len(self.eng.active))

    @property
    def tokens_per_busy_s(self) -> float:
        """This replica's warm throughput over its own stepping wall time --
        on a time-sliced single-core runner this is the per-host rate, so
        the fleet aggregate is the sum across replicas."""
        return self.tokens / max(self.busy_s, 1e-9)


class ReplicaPool:
    """Owns the replica lifecycle: spawn from the checkpoint store, warm,
    drain-with-migration, replace-unhealthy, abrupt kill.

    ``ckpt`` is either a :class:`~repro_torch.checkpoint.CheckpointManager`
    (``latest()`` picks the newest complete checkpoint) or a direct ``.npz``
    path.  ``spawn_fault`` is a test hook: a callable returning True makes
    the next spawn raise -- the executor books it as a measured stuck build.
    """

    def __init__(self, model, ckpt, serve_cfg: ServeConfig, *,
                 model_parallel: int = 1, spawn_fault=None):
        self.model = model
        self.ckpt = ckpt
        self.serve_cfg = serve_cfg
        self.model_parallel = model_parallel
        self.spawn_fault = spawn_fault
        self.serving: list[Replica] = []
        self.provisioning: list[tuple[float, Replica]] = []  # (ready_at, r)
        self.retired: list[Replica] = []
        self.migrated: list[MigratedRequest] = []  # awaiting re-admission
        self._next_rix = 0

    # -- lifecycle --------------------------------------------------------------
    def _ckpt_path(self) -> str:
        if hasattr(self.ckpt, "latest"):
            path = self.ckpt.latest()
            if path is None:
                raise RuntimeError("no complete checkpoint to spawn from")
            return path
        return self.ckpt

    def spawn(self) -> tuple[Replica, float]:
        """Bring up one replica: checkpoint load -> placement on the model's
        device -> engine build -> probe decode (two waves through the
        serving path, so the replica serves warm).  Returns ``(replica,
        measured wall seconds)``; raises on failure -- the caller books that
        as a stuck build.  ``Replica.spawn_parts`` splits the seconds into
        load, place, build and probe."""
        t0 = time.perf_counter()
        if self.spawn_fault is not None and self.spawn_fault():
            raise RuntimeError("spawn failed (injected)")
        device = self.model.device
        # the file is read into host memory, then placed, as the JAX package
        # reads it with numpy and then device_puts it: one copy on the device
        params, _ = load_checkpoint(self._ckpt_path(), device="cpu",
                                    dtype=self.model.cfg.dtype)
        t_load = time.perf_counter()
        _, params = scale_replicas(params, devices=[device],
                                   model_parallel=self.model_parallel)
        _sync(device)
        t_place = time.perf_counter()
        eng = ServingEngine(self.model, params, self.serve_cfg, device=device)
        _sync(device)
        t_build = time.perf_counter()
        rix = self._next_rix
        self._next_rix += 1
        # probe decode, two waves through the real serving path (the JAX
        # package needs the second wave to compile its steady-state
        # executable; the port keeps both so step counts match)
        for wave in range(2):
            eng.submit(Request(rid=-1 - rix, prompt=np.ones(4, np.int32),
                               max_new_tokens=2))
            eng.run_until_drained()
        eng.completed.clear()
        _sync(device)       # the delay ends when the device is done
        t_end = time.perf_counter()
        rep = Replica(rix, eng, t_end - t0)
        rep.spawn_parts = {"load_s": t_load - t0, "place_s": t_place - t_load,
                           "build_s": t_build - t_place, "probe_s": t_end - t_build}
        return rep, rep.spawn_s

    def activate_to(self, n_live: int) -> None:
        """Plan-led activation: promote provisioning replicas (earliest
        ready first) until ``serving`` matches the plan's live count.  The
        plan's landing clock is the source of truth -- it was calibrated
        from the measured spawn time, so ready order == landing order."""
        self.provisioning.sort(key=lambda e: e[0])
        while len(self.serving) < n_live and self.provisioning:
            _, rep = self.provisioning.pop(0)
            self.serving.append(rep)

    # -- drain / loss -----------------------------------------------------------
    def drain(self, replica: Replica) -> int:
        """Stop admitting on ``replica`` and migrate every in-flight request
        off it: committed KV pages + positions export to a surviving replica
        (or the migrated backlog when none fits right now).  The request
        resumes with its decode budget intact -- not from scratch."""
        replica.draining = True
        self.serving.remove(replica)
        self.retired.append(replica)
        for slot in sorted(replica.eng.active):
            self.place_migrated(replica.eng.export_request(slot))
        for req in replica.eng.queue:     # queued-but-unadmitted: no KV yet
            self.migrated.append(MigratedRequest(
                req=req, pos=0, remaining=req.max_new_tokens, kv_chunks=None))
        replica.eng.queue.clear()
        replica.eng.kv.check_invariants()  # all pages back on the free list
        return 1

    def kill(self, replica: Replica) -> list[Request]:
        """Abrupt unit loss: the host is gone, so in-flight KV cannot be
        exported -- its requests restart from scratch through the migrated
        backlog (progress cleared, same semantics as an eviction)."""
        self.serving.remove(replica)
        self.retired.append(replica)
        lost = []
        for slot in sorted(replica.eng.active):
            req = replica.eng.active.pop(slot)
            req.output.clear()
            req.score = 0.0
            req.first_token_s = None
            lost.append(req)
        lost.extend(replica.eng.queue)
        replica.eng.queue.clear()
        for req in lost:
            self.migrated.append(MigratedRequest(
                req=req, pos=0, remaining=req.max_new_tokens, kv_chunks=None))
        return lost

    def place_migrated(self, m: MigratedRequest) -> bool:
        """Re-admit a migrated request on the most-free surviving replica
        that can take it NOW (slot + pages); otherwise park it in the
        migrated backlog for the router to retry each step."""
        total = len(m.req.prompt) + m.req.max_new_tokens - 1
        for r in sorted(self.serving, key=lambda r: (-r.free_slots, r.rix)):
            if r.draining or not r.healthy:
                continue
            if r.eng.can_import() and r.eng.kv.can_admit(total):
                r.eng.import_request(m)
                return True
        self.migrated.append(m)
        return False

    # -- fleet-wide views -------------------------------------------------------
    @property
    def n_unhealthy(self) -> int:
        return sum(not r.healthy for r in self.serving)

    @property
    def n_in_system(self) -> int:
        return (len(self.migrated)
                + sum(r.eng.n_in_system for r in self.serving))

    def total_slots(self) -> int:
        return sum(min(r.eng.slot_limit, r.eng.cfg.max_batch)
                   for r in self.serving)

    def occupancy(self) -> float:
        return (sum(len(r.eng.active) for r in self.serving)
                / max(self.total_slots(), 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _restartable(m: MigratedRequest) -> bool:
    """True when a migrated entry holds NO decode progress -- a fresh submit
    is exactly equivalent (kill-path restarts and drained queued-but-
    unadmitted requests).  Entries holding committed KV or emitted tokens
    must go through priority re-admission to keep their progress."""
    return (m.pos == 0 and m.kv_chunks is None
            and m.remaining == m.req.max_new_tokens and not m.req.output)


class FleetRouter:
    """SLA-class-aware front door over a :class:`ReplicaPool`.

    Admission order: migrated entries holding decode progress first (their
    committed KV must land on a survivor), then the queue -- FIFO by
    default; with an ``sla``, strictest absolute deadline (arrival + class
    deadline) first, so under page pressure the cheapest class (longest
    deadline) is the one left waiting.  Requests restarting from scratch
    after a ``kill`` hold NO progress, so they re-enter the queue at their
    ORIGINAL deadline (``arrival_s`` survives the kill) -- a crash must not
    launder a cheap class past premium queued work, nor reset the victim's
    own SLA clock.  A request is handed to a replica only when it can be
    admitted THERE right now: a free slot under the cap and worst-case page
    admission -- the same test the engine's own scheduler applies, so a
    single-replica fleet admits on exactly the bare engine's schedule.
    """

    def __init__(self, pool: ReplicaPool, sla=None):
        self.pool = pool
        self.sla = sla
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @property
    def backlog(self) -> int:
        return len(self.queue) + len(self.pool.migrated)

    def _deadline(self, req: Request) -> float:
        pb, db = req.request_class
        return req.arrival_s + self.sla.deadline_s(f"p{pb}d{db}")

    def dispatch(self, now: float) -> int:
        """One admission pass; returns requests placed on a replica."""
        del now
        pool = self.pool
        placed = 0
        folded = False
        backlog, pool.migrated = pool.migrated, []
        for m in backlog:
            if _restartable(m):            # no progress: back through the
                self.queue.append(m.req)   # queue at the original deadline
                folded = True
            else:                          # re-admission keeps progress
                placed += bool(pool.place_migrated(m))
        if self.sla is not None and len(self.queue) > 1:
            self.queue.sort(key=self._deadline)   # stable: FIFO within ties
        elif folded and len(self.queue) > 1:
            # no SLA classes: restore global arrival order (stable, so
            # same-arrival submits keep their relative order)
            self.queue.sort(key=lambda r: r.arrival_s)
        # per-replica pages/slots promised in THIS pass (reservations only
        # execute inside the engine's next step)
        planned: dict[int, int] = {}
        taken: dict[int, int] = {}
        while self.queue:
            req = self.queue[0]
            if req.max_new_tokens <= 0:    # completes at fill time, no slot
                target = next((r for r in self.pool.serving
                               if not r.draining and r.healthy), None)
                if target is None:
                    break
                self.queue.pop(0)
                target.eng.submit(req)
                placed += 1
                continue
            total = len(req.prompt) + req.max_new_tokens - 1
            target = None
            for r in sorted(self.pool.serving,
                            key=lambda r: (-(r.free_slots
                                             - taken.get(r.rix, 0)), r.rix)):
                if r.draining or not r.healthy:
                    continue
                if (r.free_slots - taken.get(r.rix, 0) > 0
                        and r.eng.kv.can_admit(total,
                                               planned.get(r.rix, 0))):
                    target = r
                    break
            if target is None:
                break                      # head-of-line: shed = wait
            self.queue.pop(0)
            target.eng.submit(req)
            taken[target.rix] = taken.get(target.rix, 0) + 1
            planned[target.rix] = (planned.get(target.rix, 0)
                                   + target.eng.kv.pages_needed(total))
            placed += 1
        return placed


class FleetExecutor:
    """Convergence :class:`~repro_torch.core.convergence.StepExecutor` that
    actuates the ReplicaPool and keeps the CapacityPlan ledger in sync.

    ``launch`` spawns for real and calibrates the pool's provisioning delay
    from the measured wall time BEFORE booking the unit, so the plan's
    landing clock equals the replica's readiness; a spawn that raises is
    booked as a measured stuck build, which the converger's existing
    timeout / cancel / backoff machinery then handles."""

    def __init__(self, pool: ReplicaPool, plan, name: str = FLEET_POOL, *,
                 calibrate: bool = True):
        self.pool = pool
        self.plan = plan
        self.name = name
        # calibrate=False books the CONFIGURED provisioning delay instead of
        # the measured spawn wall time: chaos drills need the plan's landing
        # clock -- and therefore the audit log -- byte-identical across
        # same-seed re-runs, which measured wall time can never be
        self.calibrate = calibrate
        self._stuck = 0      # measured stuck builds currently on the books

    def launch(self, pool: str, count: int, now: float) -> int:
        applied = 0
        for _ in range(int(count)):
            try:
                rep, dt = self.pool.spawn()
            except RuntimeError:
                applied += self.plan.queue_stuck(pool, 1, now)
                self._stuck += 1
                continue
            if self.calibrate:
                self.plan.calibrate_delay(pool, dt)
            queued = self.plan.request(pool, 1, now)
            if queued:
                self.pool.provisioning.append((now + dt, rep))
                applied += queued
            else:                          # ceiling refused: discard the spawn
                self.pool.retired.append(rep)
        return applied

    def cancel_pending(self, pool: str, count: int, now: float) -> int:
        del now
        applied = self.plan.cancel_pending(pool, count)
        # the plan cancels stuck builds first; only the rest correspond to
        # provisioning replicas we must discard (newest first, matching the
        # plan's pending cancel order)
        from_stuck = min(applied, self._stuck)
        self._stuck -= from_stuck
        for _ in range(min(applied - from_stuck, len(self.pool.provisioning))):
            self.pool.provisioning.sort(key=lambda e: e[0])
            _, rep = self.pool.provisioning.pop()
            self.pool.retired.append(rep)
        return applied

    def drain(self, pool: str, count: int, now: float) -> int:
        del now
        take = self.plan.drain(pool, count)    # ledger first: floor applies
        order = sorted(self.pool.serving,
                       key=lambda r: (r.healthy, -r.rix))  # sick, then newest
        for r in order[:min(take, len(self.pool.serving))]:
            self.pool.drain(r)
        return take

    def replace_unhealthy(self, pool: str, count: int,
                          now: float) -> tuple[int, int]:
        sick = [r for r in self.pool.serving if not r.healthy]
        k = min(int(count), len(sick))
        if k <= 0:
            return 0, 0
        drained, _ = self.plan.replace_unhealthy(pool, k, now,
                                                 queue_replacements=False)
        queued = 0
        for r in sick[:drained]:
            self.pool.drain(r)             # migrate its work off first
            queued += self.launch(pool, 1, now)   # measured respawn
        return drained, queued


class FleetBackend:
    """ScalableBackend over a ReplicaPool (unit = replica), driven by the
    convergence plane through a :class:`FleetExecutor`.

    Mirrors the :class:`~repro_torch.launch.serve.ServeBackend` virtual-time step
    protocol; ``on_step(backend, t)`` is a fault-drill hook called after
    capacity convergence and before admission each step."""

    def __init__(self, pool: ReplicaPool, requests, *, sla_s: float,
                 horizon_s: float, policy=None, adapt_period_s: float = 5.0,
                 app_window_s: float = 10.0, starting_replicas: int = 1,
                 max_replicas: int = 4, min_replicas: int = 1,
                 provision_delay_s: float = 3.0, cost_rate: float = 1.0,
                 decode_steps: int = 1, sla=None, converge=None,
                 convergence: bool = True, group=None, calibrate: bool = True,
                 audit_path=None, on_step=None):
        self.pool = pool
        self.router = FleetRouter(pool, sla=sla)
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        self.sla_s = sla_s
        self.sla = sla
        self.horizon_s = horizon_s
        self.decode_steps = max(int(decode_steps), 1)
        self.on_step = on_step
        self.completed: list[Request] = []
        self._reported: dict[int, int] = {}    # replica rix -> completions seen
        if policy is None:
            policy = make_policy("target")
        unit_pool = UnitPool(FLEET_POOL, provision_delay_s=provision_delay_s,
                             cost_rate=cost_rate, min_units=min_replicas,
                             max_units=max_replicas)
        # convergence=False is the imperative baseline the chaos drills
        # compare against: same real spawns/drains through the same
        # FleetExecutor (the controller's actuation seam), but no desired
        # state, no healing, no retry machinery -- faults are only repaired
        # if the policy happens to vote capacity back.  calibrate=False
        # books configured (not measured) provisioning delays so a scripted
        # drill's audit log is byte-identical across same-seed re-runs.
        self.controller = ScalingController(
            policy,
            ControllerConfig(
                adapt_period_s=adapt_period_s,
                step_s=1.0,
                app_window_s=app_window_s,
                signal_channel="output_score",
                pools=(unit_pool,),
                convergence=convergence,
                converge=converge,
                group=group,
                audit_path=audit_path,
            ),
            SignalBus(FLEET_CHANNELS, bin_s=1.0),
            starting_units=starting_replicas,
            executor_factory=lambda plan: FleetExecutor(
                pool, plan, FLEET_POOL, calibrate=calibrate),
        )
        # the starting fleet spawns for real, NOW: the measured wall time
        # calibrates the pool's provisioning delay from step zero
        for _ in range(starting_replicas):
            rep, dt = pool.spawn()
            if calibrate:
                self.controller.plan.calibrate_delay(FLEET_POOL, dt)
            pool.serving.append(rep)

    def fire_webhook(self, name: str, now: float):
        """Mid-incident operator intent: arm the scaling group's webhook
        ``name`` (convergence mode applies its floors to the desired state
        immediately -- see ``ScalingController.fire_webhook``)."""
        return self.controller.fire_webhook(name, now)

    def _collect_completions(self) -> list[Request]:
        fresh = []
        for r in self.pool.serving + self.pool.retired:
            seen = self._reported.get(r.rix, 0)
            if len(r.eng.completed) > seen:
                fresh.extend(r.eng.completed[seen:])
                self._reported[r.rix] = len(r.eng.completed)
        self.completed.extend(fresh)
        return fresh

    def kill_replica(self, replica: Replica, now: float) -> None:
        """Fault drill: abrupt replica loss.  The plan ledger records a
        measured unit loss; the converger heals by launching -- a real
        spawn -- at its next pass."""
        self.pool.kill(replica)
        self.controller.plan.mark_lost(FLEET_POOL, 1, now)

    def run(self) -> RunReport:
        ctrl, pool, router = self.controller, self.pool, self.router
        bus = ctrl.bus
        t = 0.0
        head = 0
        units_hist: list[int] = []
        backlog_peak = 0
        while (head < len(self.requests) or router.backlog
               or any(r.eng.n_in_system for r in pool.serving)):
            units = ctrl.on_step_start(t)   # land + converge (spawns happen
            pool.activate_to(units)         # inside, measured)
            if self.on_step is not None:
                self.on_step(self, t)
            new_arr = 0
            while (head < len(self.requests)
                   and self.requests[head].arrival_s <= t):
                router.submit(self.requests[head])
                head += 1
                new_arr += 1
            router.dispatch(t)
            served = sum(r.step(t, self.decode_steps) for r in pool.serving)
            fresh = self._collect_completions()
            if fresh:
                bus.record("output_score",
                           np.array([r.arrival_s for r in fresh]),
                           np.array([r.score for r in fresh]))
            now_arr = np.array([t])
            bus.record("fleet_occupancy", now_arr,
                       np.array([pool.occupancy()]))
            bus.record("fleet_queue_depth", now_arr,
                       np.array([float(router.backlog)]))
            ctrl.plan.set_unhealthy(FLEET_POOL, pool.n_unhealthy)
            units_hist.append(len(pool.serving))
            backlog_peak = max(backlog_peak, len(pool.migrated))
            ctrl.note_step(min(1.0, served / max(pool.total_slots(), 1)),
                           new_arr)
            ctrl.maybe_adapt(time=t + 1.0,
                             n_in_system=router.backlog + pool.n_in_system)
            t += 1.0
            if t > self.horizon_s + 10_000:
                raise RuntimeError("fleet backend failed to drain")

        if ctrl.audit is not None:
            ctrl.audit.seal(t)
            ctrl.audit.close()
        units_arr = np.asarray(units_hist, dtype=np.int64)
        lat = np.array([r.done_s - r.arrival_s for r in self.completed])
        classes = np.array([f"p{r.request_class[0]}d{r.request_class[1]}"
                            for r in self.completed])
        per_replica = {
            f"replica{r.rix}": {"tokens": r.tokens, "busy_s": r.busy_s,
                                "spawn_s": r.spawn_s, **r.spawn_parts}
            for r in pool.serving + pool.retired}
        return RunReport(
            backend="fleet",
            workload=f"{len(self.requests)} requests",
            policy=ctrl.policy.describe(),
            sla_s=self.sla_s,
            latencies=lat,
            unit_seconds=float(units_arr.sum()),
            units_t=units_arr,
            n_decisions_up=ctrl.n_up,
            n_decisions_down=ctrl.n_down,
            unit_name="replica",
            decisions=ctrl.decision_log,
            sla=self.sla,
            classes=classes,
            extra={"per_replica": per_replica,
                   "migrated_backlog_peak": backlog_peak},
            **ctrl.plan.report_kwargs(),
        )


__all__ = ["FLEET_CHANNELS", "FLEET_POOL", "FleetBackend", "FleetExecutor",
           "FleetRouter", "Replica", "ReplicaPool"]
