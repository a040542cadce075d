"""ScalingController: the decision/actuation tier of the scaling control plane.

Owns, exactly once, the controller mechanics the paper fixes in Table III --
the adaptation cadence, the resource-provisioning delay queue, the
1-unit-at-a-time downscale cap, and the unit floor/ceiling -- plus the window
accounting (busy fraction, arrival rate) that backs each Observation.  Both
simulation backends (`repro_torch.core.simulator.Engine`,
`repro_torch.core.elastic.ElasticCluster`) and the live serving driver
(`repro_torch.launch.serve`) drive their step loop through this object; policies
never see anything but an :class:`Observation`.

Capacity is a typed :class:`~repro_torch.core.scaling.capacity.CapacityPlan`: an
ordered set of :class:`UnitPool`\\ s, each with its own provisioning delay,
price, floor/ceiling, and (for preemptible pools) a seeded revocation
process.  A config without explicit ``pools`` gets a single on-demand pool
synthesized from the legacy scalar knobs -- mechanically identical to the
pre-redesign controller, which the golden parity tests pin bit-for-bit.
Table III mechanics apply per pool; voluntary downscale releases the most
expensive capacity first and cancels still-pending allocations (newest-first)
before touching live units.

Per-step protocol (one call each, in order):

    units = ctrl.on_step_start(now)        # provisioned units arriving <= now
    ... backend serves one step with `units` ...
    ctrl.note_step(busy_fraction, new_arrivals)
    rec = ctrl.maybe_adapt(time=.., n_in_system=..)   # None off-cadence
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Mapping

import numpy as np

from repro_torch.core.scaling.capacity import DEFAULT_POOL, CapacityPlan, UnitPool
from repro_torch.core.scaling.signals import DEFAULT_CHANNEL, SignalBus

if TYPE_CHECKING:  # runtime import is deferred: autoscaler imports this package
    from repro_torch.core.autoscaler.base import Decision, Observation, Policy
    from repro_torch.core.convergence.audit import AuditLog
    from repro_torch.core.convergence.converger import Converger, ConvergerConfig
    from repro_torch.core.convergence.faults import FaultSpec
    from repro_torch.core.convergence.groups import ScalingGroup


@dataclass(frozen=True)
class ControllerConfig:
    """Table III knobs, backend-agnostic (a 'unit' is a CPU, a replica, or a
    decode slot -- whatever the backend scales).

    ``pools`` types out the capacity: an ordered tuple of :class:`UnitPool`.
    When None, a single on-demand pool is synthesized from the scalar
    ``provision_delay_s`` / ``min_units`` / ``max_units`` knobs (the legacy
    configuration every existing backend uses).
    """

    adapt_period_s: float = 60.0
    provision_delay_s: float = 60.0
    min_units: int = 1
    max_units: int = 4096
    downscale_cap: int = 1           # "Downscaling is limited to a single CPU"
    step_s: float = 1.0
    app_window_s: float = 120.0      # window for the application-signal tier
    signal_channel: str = DEFAULT_CHANNEL   # channel mirrored into the legacy
                                            # Observation.app_* fields
    pools: tuple[UnitPool, ...] | None = None
    # -- convergence plane (see repro_torch.core.convergence) -------------------------
    convergence: bool = False        # reconcile toward desired state instead of
                                     # actuating imperative deltas directly
    converge: "ConvergerConfig | None" = None   # timeouts/retries/backoff knobs
    faults: "tuple[FaultSpec, ...] | None" = None   # seeded fault injection
                                                    # threaded through the plan,
                                                    # or a pre-built duck-typed
                                                    # injector (ScriptedFaults)
    group: "ScalingGroup | None" = None   # scaling-group pools + scheduled and
                                          # webhook desired-state floors
    audit_path: str | None = None    # mirror the audit log to a JSONL file

    def __post_init__(self):
        if self.step_s <= 0.0:
            raise ValueError(f"step_s must be positive, got {self.step_s}")
        for name in ("adapt_period_s", "app_window_s"):
            value = getattr(self, name)
            n = value / self.step_s
            if n < 1.0 or abs(n - round(n)) > 1e-9:
                raise ValueError(
                    f"{name}={value} must be a positive integer multiple of "
                    f"step_s={self.step_s} (got {n} steps); fractional periods "
                    f"would silently truncate the adaptation cadence")

    @property
    def period_steps(self) -> int:
        return int(round(self.adapt_period_s / self.step_s))

    @property
    def window_bins(self) -> int:
        return int(round(self.app_window_s / self.step_s))

    def make_plan(self, starting_units: int) -> CapacityPlan:
        pools = self.pools
        if pools is None and self.group is not None:
            pools = self.group.pools
        if pools is None:
            pools = (UnitPool(DEFAULT_POOL,
                              provision_delay_s=self.provision_delay_s,
                              min_units=self.min_units,
                              max_units=self.max_units),)
        injector = None
        if self.faults:
            if hasattr(self.faults, "step_draws"):
                # a pre-built duck-typed injector (e.g. ScriptedFaults for
                # deterministic chaos drills) passes through as-is
                injector = self.faults
            else:
                from repro_torch.core.convergence.faults import FaultInjector
                injector = FaultInjector(self.faults)
        return CapacityPlan(pools, starting_units=starting_units,
                            faults=injector)


@dataclass(frozen=True)
class DecisionRecord:
    """One adaptation tick: what the policy asked for and what was actuated."""

    time: float
    requested: int        # raw policy delta (net, over all pools)
    applied: int          # queued (if > 0) or released/cancelled now (if < 0)
    reason: str
    units: int            # usable units right after the tick
    pending: int          # units still inside the provisioning delay
    pool_deltas: Mapping[str, int] = field(default_factory=dict)
    # per-pool applied breakdown (queued > 0, released/cancelled < 0)


class ScalingController:
    """Single control plane shared by every ScalableBackend."""

    def __init__(
        self,
        policy: Policy,
        cfg: ControllerConfig,
        bus: SignalBus | None = None,
        *,
        starting_units: int = 1,
        executor_factory=None,
    ):
        self.policy = policy
        self.cfg = cfg
        self.bus = bus if bus is not None else SignalBus((cfg.signal_channel,),
                                                         bin_s=cfg.step_s)
        # convergence-mode step executor: called as executor_factory(plan)
        # on every reset (reset() rebuilds the plan, so the executor must be
        # rebound to the new one).  None = the converger's default
        # PlanExecutor, i.e. steps mutate plan counters (pre-fleet behavior).
        self._executor_factory = executor_factory
        self.reset(starting_units)

    # -- lifecycle ------------------------------------------------------------------
    def reset(self, starting_units: int | None = None) -> None:
        if starting_units is not None:
            self._start_units = starting_units
        self.plan: CapacityPlan = self.cfg.make_plan(self._start_units)
        self.decision_log: list[DecisionRecord] = []
        self.n_up = 0
        self.n_down = 0
        self._steps = 0
        self._win_busy: list[float] = []
        self._win_arrivals = 0
        self.audit: AuditLog | None = None
        self._converger: Converger | None = None
        # the actuation seam: BOTH modes actuate through a StepExecutor, so
        # an engine-backed executor (real replica spawns/drains) serves as
        # the imperative baseline too.  The default PlanExecutor mutates plan
        # counters exactly as the pre-seam controller did (golden-pinned).
        from repro_torch.core.convergence.converger import PlanExecutor
        self._executor = (self._executor_factory(self.plan)
                          if self._executor_factory is not None
                          else PlanExecutor(self.plan))
        if self.cfg.convergence:
            # deferred: repro_torch.core.convergence imports this package
            from repro_torch.core.convergence.audit import AuditLog
            from repro_torch.core.convergence.converger import Converger
            self.audit = AuditLog(self.cfg.audit_path)
            self.audit.append(0.0, "init",
                              pools={p.name: self.plan.live_of(p.name)
                                     for p in self.plan.pools})
            self._converger = Converger(self.plan, self.cfg.converge,
                                        audit=self.audit,
                                        executor=self._executor)
        if self.cfg.group is not None:
            self.cfg.group.reset()
        self.policy.reset()

    @property
    def units(self) -> int:
        return self.plan.total_live

    @property
    def n_pending(self) -> int:
        return self.plan.total_pending

    # -- per-step protocol ----------------------------------------------------------
    def on_step_start(self, now: float) -> int:
        """Land provisioned units whose delay has elapsed, apply revocations
        for preemptible pools, meter per-pool unit-seconds; return usable
        units.  In convergence mode the converger then reconciles toward the
        desired state, so healing (relaunching lost units, cancelling stuck
        builds) starts the step a fault becomes observable -- on a converged
        fleet it plans zero steps and this is the imperative path exactly."""
        units = self.plan.land(now, self.cfg.step_s)
        if self._converger is not None and self._converger.desired is not None:
            outcomes = self._converger.converge(now)
            if outcomes:
                self._absorb(outcomes)
                units = self.plan.total_live
        return units

    def note_step(self, busy_fraction: float, new_arrivals: int) -> None:
        """Accumulate the infrastructure/system window for the next Observation."""
        self._win_busy.append(float(busy_fraction))
        self._win_arrivals += int(new_arrivals)
        self._steps += 1

    def should_adapt(self) -> bool:
        return self._steps % self.cfg.period_steps == 0

    def observe(self, *, time: float, n_in_system: int) -> Observation:
        """Build the three-tier Observation at the current window edge."""
        from repro_torch.core.autoscaler.base import Observation
        signals = self.bus.snapshot(self._steps, self.cfg.window_bins)
        primary = signals.get(self.cfg.signal_channel)
        return Observation(
            time=time,
            n_units=self.units,
            n_pending=self.n_pending,
            utilization=float(np.mean(self._win_busy)) if self._win_busy else 0.0,
            n_in_system=int(n_in_system),
            input_rate=self._win_arrivals / self.cfg.adapt_period_s,
            app_window_mean=primary.mean if primary else 0.0,
            app_prev_window_mean=primary.prev_mean if primary else 0.0,
            app_window_count=primary.count if primary else 0,
            signals=signals,
            pools=self.plan.stats(),
        )

    def maybe_adapt(self, *, time: float, n_in_system: int) -> DecisionRecord | None:
        """On-cadence: observe -> decide -> actuate under Table III mechanics.

        Upscale queues into each targeted pool behind its provisioning delay.
        Downscale is capped at ``downscale_cap`` units per tick (net, over all
        pools) and released by the plan: most expensive capacity first,
        cancelling still-pending allocations before live units -- releasing a
        live unit while a pending one lands a step later would actuate the
        opposite of what the policy asked for.
        """
        if not self.should_adapt():
            return None
        obs = self.observe(time=time, n_in_system=n_in_system)
        d: Decision = self.policy.decide(obs)
        deltas = d.pool_deltas(self.plan.default_pool)
        if self._converger is not None:
            return self._adapt_convergence(d, deltas, time)
        applied_pools: dict[str, int] = {}
        # release BEFORE queueing this tick's upscales: a mixed per-pool
        # decision (e.g. {"spot": +3, "od": -1}) must never have its release
        # pass cancel the allocation it queued a moment earlier (a scalar
        # decision is never both signs, so ordering cannot affect the legacy
        # single-pool behavior)
        down_req = -sum(dd for dd in deltas.values() if dd < 0)
        if down_req > 0 and self.plan.releasable() > 0:
            self.n_down += 1
            want = min(self.cfg.downscale_cap, down_req)
            # the plan decomposes the release (expensive-first, cancel before
            # drain); the executor actuates each op -- identical to the old
            # plan.release() with the default executor, real teardowns with
            # an engine-backed one
            for op, name, cnt in self.plan.release_plan(want):
                c = (self._executor.cancel_pending(name, cnt, time)
                     if op == "cancel" else
                     self._executor.drain(name, cnt, time))
                if c:
                    applied_pools[name] = applied_pools.get(name, 0) - c
        for name, dd in deltas.items():
            if dd > 0:
                queued = self._executor.launch(name, dd, time)
                if queued:
                    applied_pools[name] = applied_pools.get(name, 0) + queued
        if any(dd > 0 for dd in applied_pools.values()):
            self.n_up += 1
        rec = DecisionRecord(time=time, requested=int(d.total),
                             applied=sum(applied_pools.values()),
                             reason=d.reason, units=self.units,
                             pending=self.n_pending,
                             pool_deltas=applied_pools)
        self.decision_log.append(rec)
        self._win_busy = []
        self._win_arrivals = 0
        return rec

    # -- convergence mode -----------------------------------------------------------
    def _adapt_convergence(self, d: Decision, deltas: Mapping[str, int],
                           time: float) -> DecisionRecord:
        """Fold the policy decision into the desired state and converge.

        `derive_desired` applies the imperative actuation semantics (ceiling
        clamp, per-tick downscale cap, expensive-first distribution) to the
        *targets*, so with no faults the emitted steps are exactly what the
        imperative path would have done -- the golden parity tests pin this.
        """
        from repro_torch.core.convergence.desired import derive_desired
        desired = derive_desired(self._converger.desired, self.plan.stats(),
                                 deltas, downscale_cap=self.cfg.downscale_cap)
        if self.cfg.group is not None:
            desired = self.cfg.group.overlay(desired, time)
        self._converger.set_desired(desired, time, reason=d.reason)
        applied_pools = self._absorb(self._converger.converge(time))
        rec = DecisionRecord(time=time, requested=int(d.total),
                             applied=sum(applied_pools.values()),
                             reason=d.reason, units=self.units,
                             pending=self.n_pending,
                             pool_deltas=applied_pools)
        self.decision_log.append(rec)
        self._win_busy = []
        self._win_arrivals = 0
        return rec

    def _absorb(self, outcomes) -> dict[str, int]:
        """Fold converger step outcomes into the up/down counters and a
        per-pool applied breakdown (launches positive, cancels and drains
        negative; replacements are capacity-neutral).  Cancellations of
        *stuck* builds are fault cleanup, not policy downscale, so they do
        not count as a down decision."""
        applied_pools: dict[str, int] = {}
        queued_any = released_any = False
        for o in outcomes:
            kind = type(o.step).__name__
            pool = o.step.pool
            if kind == "LaunchUnit":
                applied_pools[pool] = applied_pools.get(pool, 0) + o.applied
                queued_any |= o.applied > 0
            elif kind == "CancelPending":
                applied_pools[pool] = applied_pools.get(pool, 0) - o.applied
                if o.step.reason != "stuck":
                    released_any |= o.applied > 0
            elif kind == "DrainUnit":
                applied_pools[pool] = applied_pools.get(pool, 0) - o.applied
                released_any |= o.applied > 0
            elif kind == "ReplaceUnhealthy":
                applied_pools[pool] = (applied_pools.get(pool, 0)
                                       - o.applied + o.queued)
        if queued_any:
            self.n_up += 1
        if released_any:
            self.n_down += 1
        return applied_pools

    def fire_webhook(self, name: str, now: float):
        """Arm a scaling-group webhook.  Its floors hold for the trigger's
        window; in convergence mode they land on the desired state NOW --
        bumping the generation and superseding any in-flight retry backoff
        on the targeted pools -- so an operator floor raised mid-incident is
        honored at the next converge pass, not the next adaptation tick.
        (Imperative mode keeps the legacy semantics: floors apply from the
        next tick via the group overlay / webhook policy.)"""
        if self.cfg.group is None:
            raise ValueError("no scaling group configured on this controller")
        trig = self.cfg.group.fire(name, now)
        if self.audit is not None:
            self.audit.append(now, "webhook", name=name,
                              targets=dict(trig.targets), hold_s=trig.hold_s)
        if self._converger is not None and self._converger.desired is not None:
            desired = self.cfg.group.overlay(self._converger.desired, now)
            self._converger.set_desired(desired, now,
                                        reason=f"webhook:{name}",
                                        refresh=trig.targets.keys())
        return trig


__all__ = ["ControllerConfig", "DecisionRecord", "ScalingController"]
