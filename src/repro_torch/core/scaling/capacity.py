"""The typed capacity model behind the actuation tier.

The paper's headline result is economic -- fewer SLA violations at fewer
resources -- but a scalar ``units: int`` cannot express the economics: real
fleets mix unit *kinds* with different prices, provisioning delays, and
reliability (on-demand vs spot/preemptible), and real SLAs are per request
class, not global.  This module types that out:

* :class:`UnitPool` -- one kind of capacity: a name, its provisioning delay,
  its price per unit-hour, floor/ceiling, and (for preemptible pools) a
  seeded revocation process (each live unit survives a step with probability
  ``exp(-revoke_rate * step_s)``; revocations land at step start, the DEPAS
  node-churn scenario).
* :class:`CapacityPlan` -- the live state over an *ordered* sequence of
  pools: per-pool live counts, per-pool pending queues (allocations inside
  their provisioning delay), per-pool unit-second meters, and the revocation
  log.  Downscale releases the most expensive capacity first, and within a
  pool cancels still-pending allocations (newest-first) before touching live
  units -- releasing a live unit while a pending one lands moments later is
  pure waste.
* :class:`Sla` -- the service-level spec: a default completion deadline plus
  per-request-class overrides, so a report can price violations per class.

A plan with a single on-demand pool is mechanically identical to the
pre-redesign scalar controller state (same landing, clamping and floor
behavior), which is what keeps the golden parity tests bit-for-bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Iterator, Mapping, Sequence

import numpy as np

#: pool name used when a config does not say otherwise
DEFAULT_POOL = "on-demand"


@dataclass(frozen=True)
class UnitPool:
    """One kind of capacity ('unit' stays backend-defined: CPU / replica / slot)."""

    name: str
    provision_delay_s: float = 60.0
    cost_rate: float = 1.0            # price per unit-hour
    min_units: int = 0                # floor for *voluntary* release (revocation
                                      # is involuntary and ignores it)
    max_units: int = 4096
    starting_units: int | None = None  # None: plan-level default (first pool
                                       # gets the controller's starting_units)
    preemptible: bool = False
    revoke_rate: float = 0.0          # per-unit hazard, 1/s (0 = never revoked)
    revoke_seed: int = 0

    def __post_init__(self):
        if not self.name:
            raise ValueError("UnitPool needs a non-empty name")
        if self.provision_delay_s < 0.0:
            raise ValueError(f"provision_delay_s must be >= 0, got "
                             f"{self.provision_delay_s}")
        if self.cost_rate < 0.0:
            raise ValueError(f"cost_rate must be >= 0, got {self.cost_rate}")
        if not 0 <= self.min_units <= self.max_units:
            raise ValueError(f"need 0 <= min_units <= max_units, got "
                             f"[{self.min_units}, {self.max_units}]")
        if self.revoke_rate < 0.0:
            raise ValueError(f"revoke_rate must be >= 0, got {self.revoke_rate}")
        if self.revoke_rate > 0.0 and not self.preemptible:
            raise ValueError(f"pool {self.name!r} has revoke_rate > 0 but is "
                             f"not marked preemptible")


@dataclass(frozen=True)
class PoolStats:
    """Per-pool view a policy sees in ``Observation.pools``."""

    units: int
    pending: int
    cost_rate: float
    min_units: int = 0
    max_units: int = 4096
    preemptible: bool = False
    revoked: int = 0                  # cumulative revocations so far
    unhealthy: int = 0                # live units currently failing health checks
    lost: int = 0                     # cumulative units lost to injected faults
    overflow: int = 0                 # cumulative units refused by the ceiling

    @property
    def headroom(self) -> int:
        """Units this pool can still take (live + pending below the ceiling)."""
        return max(self.max_units - self.units - self.pending, 0)


@dataclass
class PoolMeters:
    """Cumulative per-pool accounting, the plan's conservation ledger.

    Two invariants hold under ANY interleaving of request/land/release/
    cancel/drain and injected faults (pinned by the property tests):

    * ``live  == starting + landed - released - revoked - lost``
    * ``pending == queued - landed - cancelled - overflow_landed``
    """

    queued: int = 0            # units actually queued by request()
    landed: int = 0            # pending units that became live
    cancelled: int = 0         # pending units cancelled before landing
    released: int = 0          # live units voluntarily released (incl. drains)
    revoked: int = 0           # preemptible revocations
    lost: int = 0              # injected unit-loss faults
    overflow_request: int = 0  # units refused at request() (no ceiling headroom)
    overflow_landed: int = 0   # units discarded at landing (ceiling clamp)

    @property
    def overflow(self) -> int:
        """Total units the ceiling turned away, at either end of the queue."""
        return self.overflow_request + self.overflow_landed


@dataclass(frozen=True)
class RevocationEvent:
    """``count`` preemptible units of ``pool`` revoked at step start ``time``."""

    time: float
    pool: str
    count: int


@dataclass(frozen=True)
class FaultEvent:
    """One injected-fault occurrence (``kind``: unit_loss / stuck_build /
    flap / heal) of ``count`` units in ``pool`` at ``time``."""

    time: float
    pool: str
    kind: str
    count: int


@dataclass(frozen=True)
class Sla:
    """Completion-deadline spec: a default plus per-request-class overrides."""

    default_s: float
    per_class: Mapping[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if self.default_s <= 0.0:
            raise ValueError(f"default_s must be positive, got {self.default_s}")
        for cls, d in self.per_class.items():
            if d <= 0.0:
                raise ValueError(f"deadline for class {cls!r} must be positive, "
                                 f"got {d}")

    def deadline_s(self, request_class: str) -> float:
        return self.per_class.get(request_class, self.default_s)

    def deadlines(self, classes: np.ndarray) -> np.ndarray:
        """Vectorized per-item deadlines for an array of class labels."""
        if not self.per_class:
            return np.full(len(classes), self.default_s)
        lut = {c: self.deadline_s(c) for c in np.unique(classes)}
        return np.array([lut[c] for c in np.asarray(classes)], dtype=np.float64)


class _PoolState:
    """Mutable runtime state of one pool inside a CapacityPlan."""

    __slots__ = ("pool", "live", "pending", "stuck", "slow", "unhealthy",
                 "unit_seconds", "meters", "rng", "delay_override")

    def __init__(self, pool: UnitPool, live: int):
        self.pool = pool
        self.live = int(live)
        self.pending: list[tuple[float, int]] = []   # (available_at, count)
        # builds that will never land (injected stuck_build faults); they
        # occupy pending capacity -- and ceiling headroom -- until cancelled
        self.stuck: list[tuple[float, int]] = []     # (expected_at, count)
        # builds landing later than promised (provisioning brownouts):
        # (expected_at, ready_at, count) -- overdue relative to expected_at,
        # so the converger can observe the brownout, but they DO land
        self.slow: list[tuple[float, float, int]] = []
        self.unhealthy = 0
        self.unit_seconds = 0.0
        self.meters = PoolMeters()
        self.rng = np.random.default_rng(pool.revoke_seed)
        # measured provisioning delay (engine-backed pools calibrate this
        # from real spawn wall time); None means the configured value rules
        self.delay_override: float | None = None

    @property
    def delay_s(self) -> float:
        """Effective provisioning delay: measured when calibrated, else the
        configured ``UnitPool.provision_delay_s``."""
        return (self.delay_override if self.delay_override is not None
                else self.pool.provision_delay_s)

    @property
    def n_pending(self) -> int:
        return (sum(c for _, c in self.pending)
                + sum(c for _, c in self.stuck)
                + sum(c for _, _, c in self.slow))

    @property
    def revoked(self) -> int:
        return self.meters.revoked

    def cancel(self, count: int) -> int:
        """Cancel up to ``count`` pending builds: stuck ones first (they are
        worthless, oldest first so the most-overdue go), then browned-out
        builds newest-first (they land latest), then healthy pending
        newest-first (same order release() always used)."""
        left = int(count)
        while left > 0 and self.stuck:
            at, c = self.stuck[0]
            take = min(c, left)
            left -= take
            if take == c:
                self.stuck.pop(0)
            else:
                self.stuck[0] = (at, c - take)
        while left > 0 and self.slow:
            exp, rdy, c = self.slow[-1]
            take = min(c, left)
            left -= take
            if take == c:
                self.slow.pop()
            else:
                self.slow[-1] = (exp, rdy, c - take)
        while left > 0 and self.pending:
            at, c = self.pending[-1]
            take = min(c, left)
            left -= take
            if take == c:
                self.pending.pop()
            else:
                self.pending[-1] = (at, c - take)
        done = int(count) - left
        self.meters.cancelled += done
        return done


class CapacityPlan:
    """Live capacity across an ordered sequence of typed unit pools.

    The first pool is the *default* pool: scalar policy decisions map onto it,
    and it receives the controller's ``starting_units`` unless its
    ``starting_units`` field says otherwise.
    """

    def __init__(self, pools: Sequence[UnitPool], *, starting_units: int = 0,
                 faults=None):
        pools = tuple(pools)
        if not pools:
            raise ValueError("CapacityPlan needs at least one UnitPool")
        names = [p.name for p in pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        self.pools = pools
        self.default_pool = pools[0].name
        # fault injector (see repro_torch.core.convergence.faults) -- duck-typed so
        # this module stays import-cycle free: needs .reset(), .stuck_builds()
        # and .step_draws()
        self._faults = faults
        self._state: dict[str, _PoolState] = {}
        self.revocations: list[RevocationEvent] = []
        self.fault_events: list[FaultEvent] = []
        self.reset(starting_units)

    # -- lifecycle ------------------------------------------------------------------
    def reset(self, starting_units: int = 0) -> None:
        self._state = {}
        for i, p in enumerate(self.pools):
            live = p.starting_units if p.starting_units is not None else (
                starting_units if i == 0 else 0)
            self._state[p.name] = _PoolState(p, live)
        self.revocations = []
        self.fault_events = []
        if self._faults is not None:
            self._faults.reset()

    # -- totals ---------------------------------------------------------------------
    @property
    def total_live(self) -> int:
        return sum(s.live for s in self._state.values())

    @property
    def total_pending(self) -> int:
        return sum(s.n_pending for s in self._state.values())

    @property
    def n_revoked(self) -> int:
        return sum(s.revoked for s in self._state.values())

    def live_of(self, name: str) -> int:
        return self._state[name].live

    def pending_of(self, name: str) -> int:
        return self._state[name].n_pending

    def __iter__(self) -> Iterator[UnitPool]:
        return iter(self.pools)

    # -- per-step protocol ----------------------------------------------------------
    def land(self, now: float, step_s: float = 1.0) -> int:
        """Start one step: land provisioned units whose delay elapsed (clamped
        to the pool ceiling, excess counted in the ``overflow`` meter), apply
        revocations for preemptible pools and any injected faults, then meter
        this step's unit-seconds.  Returns total usable units."""
        for st in self._state.values():
            if st.pending:
                ready = sum(c for at, c in st.pending if at <= now)
                if ready:
                    admit = min(ready, max(st.pool.max_units - st.live, 0))
                    if admit < ready:
                        st.meters.overflow_landed += ready - admit
                    st.live += admit
                    st.meters.landed += admit
                    st.pending = [p for p in st.pending if p[0] > now]
            if st.slow:
                ready = sum(c for _, rdy, c in st.slow if rdy <= now)
                if ready:
                    admit = min(ready, max(st.pool.max_units - st.live, 0))
                    if admit < ready:
                        st.meters.overflow_landed += ready - admit
                    st.live += admit
                    st.meters.landed += admit
                    st.slow = [e for e in st.slow if e[1] > now]
            if st.pool.revoke_rate > 0.0 and st.live > 0:
                p_rev = -math.expm1(-st.pool.revoke_rate * step_s)
                k = int(st.rng.binomial(st.live, p_rev))
                if k:
                    st.live -= k
                    st.meters.revoked += k
                    st.unhealthy = min(st.unhealthy, st.live)
                    self.revocations.append(
                        RevocationEvent(time=now, pool=st.pool.name, count=k))
            if self._faults is not None:
                self._apply_faults(st, now, step_s)
            st.unit_seconds += st.live * step_s
        return self.total_live

    def _apply_faults(self, st: _PoolState, now: float, step_s: float) -> None:
        lost, flapped, healed = self._faults.step_draws(
            st.pool.name, st.live, st.unhealthy, now, step_s)
        if lost:
            st.live -= lost
            st.meters.lost += lost
            st.unhealthy = min(st.unhealthy, st.live)
            self.fault_events.append(
                FaultEvent(time=now, pool=st.pool.name, kind="unit_loss",
                           count=lost))
        if flapped:
            st.unhealthy = min(st.live, st.unhealthy + flapped)
            self.fault_events.append(
                FaultEvent(time=now, pool=st.pool.name, kind="flap",
                           count=flapped))
        if healed:
            healed = min(healed, st.unhealthy)
            if healed:
                st.unhealthy -= healed
                self.fault_events.append(
                    FaultEvent(time=now, pool=st.pool.name, kind="heal",
                               count=healed))
        # correlated multi-unit loss (AZ-scale event): drawn once per step
        # across pools, applied after the independent unit_loss draws so
        # their RNG streams stay aligned with corr-free runs
        corr_fn = getattr(self._faults, "corr_loss", None)
        if corr_fn is not None:
            corr = min(int(corr_fn(st.pool.name, st.live, now, step_s)),
                       st.live)
            if corr:
                st.live -= corr
                st.meters.lost += corr
                st.unhealthy = min(st.unhealthy, st.live)
                self.fault_events.append(
                    FaultEvent(time=now, pool=st.pool.name, kind="corr_loss",
                               count=corr))

    # -- actuation ------------------------------------------------------------------
    def request(self, name: str, count: int, now: float) -> int:
        """Queue units of ``name`` behind its provisioning delay, clamped to
        the pool's remaining ceiling headroom (``max_units - live - pending``);
        refused units are counted in the ``overflow`` meter.  Returns the
        count actually queued."""
        if count <= 0:
            return 0
        st = self._state.get(name)
        if st is None:
            raise ValueError(f"unknown pool {name!r}; plan pools: "
                             f"{[p.name for p in self.pools]}")
        count = int(count)
        queued = min(count, max(st.pool.max_units - st.live - st.n_pending, 0))
        if queued < count:
            st.meters.overflow_request += count - queued
        if queued <= 0:
            return 0
        at = now + st.delay_s
        stuck = (self._faults.stuck_builds(st.pool.name, queued, now)
                 if self._faults is not None else 0)
        if stuck:
            st.stuck.append((at, stuck))
            self.fault_events.append(
                FaultEvent(time=now, pool=st.pool.name, kind="stuck_build",
                           count=stuck))
        healthy = queued - stuck
        if healthy:
            factor_fn = getattr(self._faults, "delay_factor", None) \
                if self._faults is not None else None
            factor = float(factor_fn(st.pool.name, now)) if factor_fn else 1.0
            if factor > 1.0:
                # provisioning brownout: the build WILL land, but later than
                # promised; overdue detection keys off the expected time
                st.slow.append((at, now + st.delay_s * factor, healthy))
                self.fault_events.append(
                    FaultEvent(time=now, pool=st.pool.name, kind="brownout",
                               count=healthy))
            else:
                st.pending.append((at, healthy))
        st.meters.queued += queued
        return queued

    def releasable(self) -> int:
        """Units a voluntary release could currently reclaim: all pending plus
        live capacity above each pool's floor."""
        return sum(s.n_pending + max(s.live - s.pool.min_units, 0)
                   for s in self._state.values())

    def _release_order(self) -> list[_PoolState]:
        # most expensive first; among equal prices, later-declared pools go
        # first so the default pool is the last to shrink
        return sorted(self._state.values(),
                      key=lambda s: (s.pool.cost_rate,
                                     self.pools.index(s.pool)),
                      reverse=True)

    def release_plan(self, count: int) -> list[tuple[str, str, int]]:
        """Decompose a voluntary release of up to ``count`` units into ordered
        ``("cancel" | "drain", pool, n)`` operations WITHOUT mutating state.

        Executing the returned operations through :meth:`cancel_pending` /
        :meth:`drain` (in order) is mechanically identical to
        :meth:`release` -- same pool order, same queue semantics -- which is
        what lets the imperative controller actuate through a
        :class:`~repro_torch.core.convergence.converger.StepExecutor` (and thus
        drive real replica fleets) without perturbing the golden behavior.
        """
        ops: list[tuple[str, str, int]] = []
        left = int(count)
        order = self._release_order()
        for st in order:                       # pass 1: cancel pending
            take = min(left, st.n_pending)
            if take > 0:
                ops.append(("cancel", st.pool.name, take))
                left -= take
        for st in order:                       # pass 2: release live
            take = min(left, max(st.live - st.pool.min_units, 0))
            if take > 0:
                ops.append(("drain", st.pool.name, take))
                left -= take
        return ops

    def release(self, count: int) -> dict[str, int]:
        """Voluntarily release up to ``count`` units, most expensive capacity
        first: pass 1 cancels pending allocations (newest-first within each
        pool), pass 2 releases live units above each pool's floor.  Returns
        the per-pool released counts (sum <= count)."""
        out: dict[str, int] = {}
        left = int(count)
        order = self._release_order()
        for st in order:                       # pass 1: cancel pending
            if left > 0 and (st.pending or st.stuck or st.slow):
                take = st.cancel(left)
                left -= take
                if take:
                    out[st.pool.name] = out.get(st.pool.name, 0) + take
        for st in order:                       # pass 2: release live
            take = min(left, max(st.live - st.pool.min_units, 0))
            if take > 0:
                st.live -= take
                st.unhealthy = max(st.unhealthy - take, 0)   # drain sick first
                st.meters.released += take
                left -= take
                out[st.pool.name] = out.get(st.pool.name, 0) + take
        return out

    # -- convergence primitives -----------------------------------------------------
    def cancel_pending(self, name: str, count: int) -> int:
        """Cancel up to ``count`` pending builds of ``name`` (stuck builds
        first, then healthy pending newest-first).  Returns the count
        actually cancelled."""
        if count <= 0:
            return 0
        return self._pool(name).cancel(count)

    def drain(self, name: str, count: int) -> int:
        """Voluntarily drain up to ``count`` live units of ``name``,
        respecting the pool floor; unhealthy units go first.  Returns the
        count actually drained."""
        if count <= 0:
            return 0
        st = self._pool(name)
        take = min(int(count), max(st.live - st.pool.min_units, 0))
        if take > 0:
            st.live -= take
            st.unhealthy = max(st.unhealthy - take, 0)
            st.meters.released += take
        return take

    def replace_unhealthy(self, name: str, count: int, now: float, *,
                          queue_replacements: bool = True) -> tuple[int, int]:
        """Tear down up to ``count`` unhealthy live units of ``name`` and
        queue replacements behind the provisioning delay (the fleet briefly
        dips, exactly as a real instance failure would).  Returns
        ``(drained, queued)``.

        ``queue_replacements=False`` tears down only: an engine-backed
        executor books each replacement itself (via :meth:`request` after a
        measured spawn, or :meth:`queue_stuck` after a failed one)."""
        st = self._pool(name)
        k = min(int(count), st.unhealthy)
        if k <= 0:
            return 0, 0
        st.live -= k
        st.unhealthy -= k
        st.meters.released += k
        queued = self.request(name, k, now) if queue_replacements else 0
        return k, queued

    # -- engine-measured actuation (used by fleet step executors) --------------------
    def calibrate_delay(self, name: str, seconds: float) -> None:
        """Record a *measured* provisioning delay for ``name`` (real spawn
        wall time: checkpoint load + remesh + compile + probe decode).
        Latest measurement wins -- the first spawn pays jit compilation,
        later ones reuse the cache, and the plan should price the current
        reality, not the configured guess."""
        if seconds < 0.0:
            raise ValueError(f"measured delay must be >= 0, got {seconds}")
        self._pool(name).delay_override = float(seconds)

    def queue_stuck(self, name: str, count: int, now: float) -> int:
        """Record ``count`` builds of ``name`` that started but will never
        land -- a real spawn failure observed by an executor, as opposed to
        an injected stuck_build fault.  The converger's overdue-timeout /
        cancel / retry machinery applies identically."""
        if count <= 0:
            return 0
        st = self._pool(name)
        count = int(count)
        st.stuck.append((now + st.delay_s, count))
        st.meters.queued += count
        self.fault_events.append(
            FaultEvent(time=now, pool=st.pool.name, kind="stuck_build",
                       count=count))
        return count

    def mark_lost(self, name: str, count: int, now: float) -> int:
        """Remove up to ``count`` live units of ``name`` that an executor
        observed dead (replica process killed out from under us) -- the
        measured counterpart of an injected unit_loss fault."""
        st = self._pool(name)
        k = min(int(count), st.live)
        if k <= 0:
            return 0
        st.live -= k
        st.meters.lost += k
        st.unhealthy = min(st.unhealthy, st.live)
        self.fault_events.append(
            FaultEvent(time=now, pool=st.pool.name, kind="unit_loss", count=k))
        return k

    def set_unhealthy(self, name: str, count: int) -> None:
        """Sync the unhealthy gauge of ``name`` from an executor's real
        health checks (clamped to the live count)."""
        st = self._pool(name)
        st.unhealthy = min(max(int(count), 0), st.live)

    def overdue_pending(self, name: str, now: float, timeout_s: float) -> int:
        """Builds of ``name`` whose expected landing is more than
        ``timeout_s`` overdue -- the observable symptom of a stuck build."""
        st = self._pool(name)
        return (sum(c for at, c in st.stuck if now >= at + timeout_s)
                + sum(c for at, c in st.pending if now >= at + timeout_s)
                + sum(c for exp, _, c in st.slow if now >= exp + timeout_s))

    def _pool(self, name: str) -> _PoolState:
        st = self._state.get(name)
        if st is None:
            raise ValueError(f"unknown pool {name!r}; plan pools: "
                             f"{[p.name for p in self.pools]}")
        return st

    # -- observation / accounting ---------------------------------------------------
    def stats(self) -> dict[str, PoolStats]:
        return {
            name: PoolStats(units=st.live, pending=st.n_pending,
                            cost_rate=st.pool.cost_rate,
                            min_units=st.pool.min_units,
                            max_units=st.pool.max_units,
                            preemptible=st.pool.preemptible,
                            revoked=st.revoked,
                            unhealthy=st.unhealthy,
                            lost=st.meters.lost,
                            overflow=st.meters.overflow)
            for name, st in self._state.items()
        }

    def meters(self) -> dict[str, PoolMeters]:
        """Copies of the per-pool conservation ledgers (see PoolMeters)."""
        return {name: replace(st.meters) for name, st in self._state.items()}

    def unit_seconds_by_pool(self) -> dict[str, float]:
        return {name: st.unit_seconds for name, st in self._state.items()}

    def cost(self) -> float:
        """Priced capacity consumed so far (sum of unit-hours x pool rate)."""
        return sum(st.unit_seconds / 3600.0 * st.pool.cost_rate
                   for st in self._state.values())

    def report_kwargs(self) -> dict:
        """RunReport constructor kwargs carrying the plan's priced accounting."""
        return {
            "pool_unit_seconds": self.unit_seconds_by_pool(),
            "pool_cost_rates": {p.name: p.cost_rate for p in self.pools},
            "n_revocations": self.n_revoked,
            # measured provisioning delays only -- a pool appears here iff an
            # executor calibrated it from a real spawn (configured guesses
            # stay out of the report)
            "pool_provision_delay_s": {
                name: st.delay_override
                for name, st in self._state.items()
                if st.delay_override is not None},
        }


__all__ = ["DEFAULT_POOL", "CapacityPlan", "FaultEvent", "PoolMeters",
           "PoolStats", "RevocationEvent", "Sla", "UnitPool"]
