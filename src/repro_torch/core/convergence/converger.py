"""The converger loop: reconcile observed capacity toward the desired state.

Runs once per controller step (not just per adapt tick), so healing starts
the step after a fault is observable.  Each call:

1. audits witnessed meter deltas since the last call (landings, revocations,
   losses) so the audit log stays a complete account;
2. observes ``plan.stats()`` and queries the build-status API for overdue
   builds (pending whose expected landing is more than ``build_timeout_s``
   ago -- the observable symptom of a stuck build);
3. asks the pure planner for steps, withholding launches from pools that are
   in retry backoff or have exhausted their retry budget, and replacements
   from pools inside the flap-damping window;
4. executes the steps against the capacity plane, recording per-step
   outcomes.

Retry discipline: cancelling a stuck build counts as a failed launch
attempt; the relaunch waits ``backoff_base_s * 2**(attempt-1)`` (capped at
``backoff_max_s``).  A landing in the pool resets the attempt counter; after
``max_retries`` failed attempts the pool is parked (audited as ``gave_up``)
until the policy next changes its target.  Partial failures need no special
handling -- an under-applied step is just diff the next call re-plans.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Iterable, Protocol, runtime_checkable

from repro_torch.core.scaling.capacity import CapacityPlan

from .audit import AuditLog
from .desired import DesiredGroup
from .planner import (
    CancelPending, DrainUnit, LaunchUnit, ReplaceUnhealthy, Step, plan_steps,
    step_record,
)


@runtime_checkable
class StepExecutor(Protocol):
    """What a converger actuates steps against.

    The default :class:`PlanExecutor` mutates CapacityPlan counters (the
    virtual capacity model); ``repro_torch.serving.fleet.FleetExecutor`` spawns and
    drains real ServingEngine replicas and keeps the plan's ledger in sync as
    a side effect.  Each method returns the count actually applied (for
    ``replace_unhealthy``: ``(drained, queued)``)."""

    def launch(self, pool: str, count: int, now: float) -> int: ...
    def cancel_pending(self, pool: str, count: int, now: float) -> int: ...
    def drain(self, pool: str, count: int, now: float) -> int: ...
    def replace_unhealthy(self, pool: str, count: int,
                          now: float) -> tuple[int, int]: ...


class PlanExecutor:
    """Default executor: steps mutate the CapacityPlan's virtual counters
    (exactly the pre-fleet behavior, which keeps the golden parity tests)."""

    def __init__(self, plan: CapacityPlan):
        self.plan = plan

    def launch(self, pool: str, count: int, now: float) -> int:
        return self.plan.request(pool, count, now)

    def cancel_pending(self, pool: str, count: int, now: float) -> int:
        return self.plan.cancel_pending(pool, count)

    def drain(self, pool: str, count: int, now: float) -> int:
        return self.plan.drain(pool, count)

    def replace_unhealthy(self, pool: str, count: int,
                          now: float) -> tuple[int, int]:
        return self.plan.replace_unhealthy(pool, count, now)


@dataclass(frozen=True)
class ConvergerConfig:
    """Timeout / retry / backoff knobs for the converger loop."""

    build_timeout_s: float = 30.0    # pending overdue by this much => stuck
    max_retries: int = 5             # failed launch attempts before parking
    backoff_base_s: float = 5.0      # first retry delay; doubles per attempt
    backoff_max_s: float = 120.0
    replace_backoff_s: float = 30.0  # min gap between replacements per pool

    def __post_init__(self):
        if self.build_timeout_s < 0.0:
            raise ValueError(f"build_timeout_s must be >= 0, got "
                             f"{self.build_timeout_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_base_s <= 0.0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError(f"need 0 < backoff_base_s <= backoff_max_s, got "
                             f"[{self.backoff_base_s}, {self.backoff_max_s}]")

    def backoff_s(self, attempt: int) -> float:
        return min(self.backoff_base_s * 2.0 ** max(attempt - 1, 0),
                   self.backoff_max_s)


@dataclass(frozen=True)
class StepOutcome:
    """One executed step: ``applied`` units actuated of ``step.count`` asked;
    ``queued`` is the replacement count for ReplaceUnhealthy steps."""

    time: float
    step: Step
    applied: int
    queued: int = 0

    @property
    def ok(self) -> bool:
        return self.applied >= self.step.count


class Converger:
    """Executes convergence steps against a :class:`CapacityPlan`."""

    def __init__(self, plan: CapacityPlan, cfg: ConvergerConfig | None = None,
                 audit: AuditLog | None = None,
                 executor: StepExecutor | None = None):
        self.plan = plan
        self.cfg = cfg or ConvergerConfig()
        self.audit = audit
        self.executor: StepExecutor = executor or PlanExecutor(plan)
        self.desired: DesiredGroup | None = None
        self.generation = 0                     # desired-state epoch counter
        self._attempts: dict[str, int] = {}     # failed launch attempts
        self._gate: dict[str, float] = {}       # no launches before this time
        self._gate_gen: dict[str, int] = {}     # epoch each gate was armed in
        self._pool_gen: dict[str, int] = {}     # epoch of last intent change
        self._replace_gate: dict[str, float] = {}
        self._last_meters = plan.meters()

    # -- desired state ----------------------------------------------------------
    def set_desired(self, desired: DesiredGroup, now: float,
                    reason: str = "", refresh: Iterable[str] = ()) -> None:
        """Install a new desired state.

        A pool whose target changed -- or that is named in ``refresh``
        (webhook floors renew intent even when the numeric target is
        unchanged, e.g. an operator re-asserting a floor on a parked pool)
        -- gets its retry budget and backoff gate DISCARDED, not resumed:
        the backoff belonged to the superseded intent, and waiting it out
        would let a stale retry outrank the operator.  Any intent change
        bumps the desired-state ``generation``, which is stamped onto the
        planned steps and every audit record so the log can prove no step
        contradicted the latest desired state.
        """
        refresh = set(refresh)
        superseding = set()
        if self.desired is None:
            superseding = set(desired.targets) | refresh
        else:
            for name in desired.targets:
                if (desired.target_of(name) != self.desired.target_of(name)
                        or name in refresh):
                    superseding.add(name)
        if superseding:
            self.generation += 1
        desired = _dc_replace(desired, generation=self.generation)
        for name in superseding:
            self._pool_gen[name] = self.generation
            # new intent un-parks the pool and restarts its budget
            attempts = self._attempts.pop(name, None)
            gate = self._gate.pop(name, None)
            self._gate_gen.pop(name, None)
            stale = ((gate is not None and gate > now)
                     or (attempts is not None
                         and attempts > self.cfg.max_retries))
            if stale and self.audit is not None:
                # a live backoff / parked pool was superseded mid-retry
                self.audit.append(now, "superseded", pool=name,
                                  gen=self.generation,
                                  gate=gate if gate is not None else 0.0,
                                  attempts=attempts or 0)
        self.desired = desired
        if self.audit is not None and superseding:
            self.audit.append(now, "desired", reason=reason,
                              gen=self.generation,
                              targets={n: t.target
                                       for n, t in desired.targets.items()},
                              bounds={n: [t.min_units, t.max_units]
                                      for n, t in desired.targets.items()})

    # -- the loop ---------------------------------------------------------------
    def converge(self, now: float) -> list[StepOutcome]:
        if self.desired is None:
            return []
        prev_meters = self._last_meters
        self._audit_events(now)
        # a landing proves the build path works again: reset retry budgets
        for name in list(self._attempts):
            last = prev_meters.get(name)
            cur = self._last_meters.get(name)
            if last is not None and cur is not None and cur.landed > last.landed:
                self._attempts.pop(name, None)
                self._gate.pop(name, None)
                self._gate_gen.pop(name, None)
        # defense in depth: a gate armed under an older epoch than the pool's
        # latest intent change is stale and must not withhold launches --
        # set_desired discards these eagerly, so firing here means desired
        # state was mutated behind its back; still audited, never honored
        for name in list(self._gate):
            if self._gate_gen.get(name, 0) < self._pool_gen.get(name, 0):
                gate = self._gate.pop(name)
                self._gate_gen.pop(name, None)
                self._attempts.pop(name, None)
                if self.audit is not None:
                    self.audit.append(now, "superseded", pool=name,
                                      gen=self._pool_gen.get(name, 0),
                                      gate=gate, attempts=0)
        stats = self.plan.stats()
        overdue: dict[str, int] = {}
        for name in stats:
            od = self.plan.overdue_pending(name, now, self.cfg.build_timeout_s)
            if od > 0:
                overdue[name] = od
                self._note_failed_attempt(name, now)
        blocked = set()
        for name in stats:
            attempts = self._attempts.get(name, 0)
            if attempts > self.cfg.max_retries:
                blocked.add(name)
            elif now < self._gate.get(name, -1.0):
                blocked.add(name)
        replace_blocked = {name for name, until in self._replace_gate.items()
                           if now < until}
        steps = plan_steps(self.desired, stats, overdue=overdue,
                           launch_blocked=blocked,
                           replace_blocked=replace_blocked)
        if steps and self.audit is not None:
            # the planner's full inputs ride along so a replay can re-run the
            # pure planner and reproduce these exact steps (audit.verify_plan_replay)
            self.audit.append(now, "plan", gen=self.desired.generation,
                steps=[step_record(s) for s in steps],
                inputs={
                    "stats": {n: {"units": ps.units, "pending": ps.pending,
                                  "unhealthy": ps.unhealthy,
                                  "min_units": ps.min_units}
                              for n, ps in stats.items()},
                    "overdue": dict(overdue),
                    "launch_blocked": sorted(blocked),
                    "replace_blocked": sorted(replace_blocked)})
        return [self._execute(s, now) for s in steps]

    # -- internals --------------------------------------------------------------
    def _execute(self, step: Step, now: float) -> StepOutcome:
        queued = 0
        if isinstance(step, LaunchUnit):
            applied = self.executor.launch(step.pool, step.count, now)
        elif isinstance(step, CancelPending):
            applied = self.executor.cancel_pending(step.pool, step.count, now)
        elif isinstance(step, DrainUnit):
            applied = self.executor.drain(step.pool, step.count, now)
        elif isinstance(step, ReplaceUnhealthy):
            applied, queued = self.executor.replace_unhealthy(
                step.pool, step.count, now)
            self._replace_gate[step.pool] = now + self.cfg.replace_backoff_s
        else:  # pragma: no cover - the planner only emits the four kinds
            raise TypeError(f"unknown step {step!r}")
        out = StepOutcome(time=now, step=step, applied=applied, queued=queued)
        if self.audit is not None:
            rec = {"step": type(step).__name__, "pool": step.pool,
                   "asked": step.count, "applied": applied, "gen": step.gen}
            if isinstance(step, CancelPending):
                rec["reason"] = step.reason
            if isinstance(step, ReplaceUnhealthy):
                rec["queued"] = queued
            self.audit.append(now, "step", **rec)
        return out

    def _note_failed_attempt(self, name: str, now: float) -> None:
        attempts = self._attempts.get(name, 0) + 1
        self._attempts[name] = attempts
        if attempts > self.cfg.max_retries:
            if self.audit is not None:
                self.audit.append(now, "gave_up", pool=name, attempts=attempts)
            return
        delay = self.cfg.backoff_s(attempts)
        self._gate[name] = now + delay
        self._gate_gen[name] = self._pool_gen.get(name, 0)
        if self.audit is not None:
            self.audit.append(now, "backoff", pool=name, attempts=attempts,
                              until=now + delay)

    def _audit_events(self, now: float) -> None:
        meters = self.plan.meters()
        if self.audit is not None:
            for name, m in meters.items():
                last = self._last_meters.get(name)
                if last is None:
                    continue
                deltas = {
                    "landed": m.landed - last.landed,
                    "revoked": m.revoked - last.revoked,
                    "lost": m.lost - last.lost,
                    "overflow_landed": m.overflow_landed - last.overflow_landed,
                }
                if any(deltas.values()):
                    self.audit.append(now, "events", pool=name, **deltas)
        self._last_meters = meters


__all__ = ["Converger", "ConvergerConfig", "PlanExecutor", "StepExecutor",
           "StepOutcome"]
