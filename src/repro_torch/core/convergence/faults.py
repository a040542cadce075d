"""Seeded fault-injection processes threaded through the capacity plane.

Three fault kinds, matching the failure taxonomy the ROADMAP's convergence
item names (the scenarios an imperative delta controller cannot express):

* **unit loss** -- live units vanish abruptly (hardware failure, AZ event):
  each live unit is lost within a step with probability
  ``1 - exp(-loss_rate * step_s)``.
* **stuck builds** -- a queued allocation never lands (hung image build,
  exhausted capacity pool behind the API): each unit of a request sticks
  with probability ``stuck_p``.  Stuck builds occupy pending capacity -- and
  ceiling headroom -- until something cancels them, which is exactly what
  clogs the imperative baseline.
* **flapping health** -- live units oscillate between healthy and unhealthy
  with hazards ``flap_rate`` / ``heal_rate``.
* **provisioning brownouts** -- builds land, but ``brownout_factor`` times
  later than promised (degraded control plane, capacity crunch behind the
  API).  Unlike stuck builds these eventually arrive; the converger sees
  them as overdue-but-alive and must decide between waiting and relaunching.
* **correlated loss** -- one AZ-scale event takes a ``corr_loss_frac``
  fraction of EVERY affected pool's live units in the same step (probability
  ``corr_loss_p`` per step while the window is active).  Independent
  per-unit hazards can never produce this covariance, which is what makes
  it the interesting recovery drill.

Each :class:`FaultSpec` is windowed (``start_s``..``end_s``) and carries its
own seed; the injector keeps one RNG stream per (spec, fault-kind) so the
unit-loss process a run experiences does not depend on how many requests the
controller happened to issue.  ``CapacityPlan`` holds the injector behind a
duck-typed attach point (``stuck_builds`` / ``step_draws`` / ``reset``), so
the scaling package never imports this module.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FaultSpec:
    """One windowed, seeded fault process; ``pool=None`` hits every pool."""

    pool: str | None = None
    loss_rate: float = 0.0       # per-unit hazard of abrupt unit loss, 1/s
    stuck_p: float = 0.0         # probability a queued build never lands
    flap_rate: float = 0.0       # per-unit hazard healthy -> unhealthy, 1/s
    heal_rate: float = 0.0       # per-unit hazard unhealthy -> healthy, 1/s
    brownout_factor: float = 1.0  # provisioning-delay inflation (1.0 = none)
    corr_loss_p: float = 0.0     # per-step probability of an AZ-scale event
    corr_loss_frac: float = 1.0  # fraction of live units the event takes
    start_s: float = 0.0
    end_s: float = math.inf
    seed: int = 0

    def __post_init__(self):
        for f in ("loss_rate", "flap_rate", "heal_rate"):
            if getattr(self, f) < 0.0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")
        if not 0.0 <= self.stuck_p <= 1.0:
            raise ValueError(f"stuck_p must be in [0, 1], got {self.stuck_p}")
        if self.brownout_factor < 1.0:
            raise ValueError(f"brownout_factor must be >= 1, got "
                             f"{self.brownout_factor}")
        if not 0.0 <= self.corr_loss_p <= 1.0:
            raise ValueError(f"corr_loss_p must be in [0, 1], got "
                             f"{self.corr_loss_p}")
        if not 0.0 < self.corr_loss_frac <= 1.0:
            raise ValueError(f"corr_loss_frac must be in (0, 1], got "
                             f"{self.corr_loss_frac}")
        if self.end_s < self.start_s:
            raise ValueError(f"end_s {self.end_s} < start_s {self.start_s}")

    def active(self, pool: str, now: float) -> bool:
        return ((self.pool is None or self.pool == pool)
                and self.start_s <= now < self.end_s)


class FaultInjector:
    """Seeded draws for a set of :class:`FaultSpec` processes.

    Deterministic given the specs' seeds and the sequence of calls; streams
    are split per fault kind so loss draws stay aligned between runs whose
    request patterns differ (e.g. imperative vs convergence mode).
    """

    def __init__(self, specs):
        self.specs = tuple(specs)
        self._rngs: list[dict[str, np.random.Generator]] = []
        self._corr_cache: dict[tuple[int, float], bool] = {}
        self.reset()

    def reset(self) -> None:
        # "corr" is appended so the (seed, index) streams of the original
        # kinds stay bit-identical to pre-brownout injectors
        self._rngs = [
            {kind: np.random.default_rng((spec.seed, i))
             for i, kind in enumerate(("loss", "stuck", "flap", "heal",
                                       "corr"))}
            for spec in self.specs
        ]
        self._corr_cache = {}

    def stuck_builds(self, pool: str, count: int, now: float) -> int:
        """How many of ``count`` units just queued for ``pool`` will stick."""
        stuck = 0
        for spec, rngs in zip(self.specs, self._rngs):
            if spec.stuck_p > 0.0 and spec.active(pool, now):
                stuck += int(rngs["stuck"].binomial(count - stuck, spec.stuck_p))
                if stuck >= count:
                    return count
        return stuck

    def step_draws(self, pool: str, live: int, unhealthy: int, now: float,
                   step_s: float) -> tuple[int, int, int]:
        """Per-step fault draws for ``pool``: (lost, flapped, healed)."""
        lost = flapped = healed = 0
        for spec, rngs in zip(self.specs, self._rngs):
            if not spec.active(pool, now):
                continue
            if spec.loss_rate > 0.0 and live - lost > 0:
                p = -math.expm1(-spec.loss_rate * step_s)
                lost += int(rngs["loss"].binomial(live - lost, p))
            healthy = max(live - lost - unhealthy, 0)
            if spec.flap_rate > 0.0 and healthy - flapped > 0:
                p = -math.expm1(-spec.flap_rate * step_s)
                flapped += int(rngs["flap"].binomial(healthy - flapped, p))
            if spec.heal_rate > 0.0 and unhealthy - healed > 0:
                p = -math.expm1(-spec.heal_rate * step_s)
                healed += int(rngs["heal"].binomial(unhealthy - healed, p))
        return lost, flapped, healed

    def delay_factor(self, pool: str, now: float) -> float:
        """Provisioning-delay inflation for a build queued on ``pool`` now
        (product of all active brownout windows; 1.0 = healthy)."""
        factor = 1.0
        for spec in self.specs:
            if spec.brownout_factor > 1.0 and spec.active(pool, now):
                factor *= spec.brownout_factor
        return factor

    def corr_loss(self, pool: str, live: int, now: float,
                  step_s: float) -> int:
        """Units of ``pool`` taken by correlated AZ-scale events this step.

        Whether an event fires is drawn ONCE per (spec, step) and cached, so
        every pool a spec covers is hit in the same step -- that shared draw
        is the correlation.  ``step_s`` is accepted for signature symmetry
        with :meth:`step_draws`; the event probability is per step.
        """
        del step_s
        lost = 0
        for i, (spec, rngs) in enumerate(zip(self.specs, self._rngs)):
            if spec.corr_loss_p <= 0.0 or not spec.active(pool, now):
                continue
            key = (i, float(now))
            fired = self._corr_cache.get(key)
            if fired is None:
                fired = bool(rngs["corr"].random() < spec.corr_loss_p)
                self._corr_cache[key] = fired
            if fired:
                lost += math.ceil(spec.corr_loss_frac * max(live - lost, 0))
        return min(lost, live)


_SCRIPT_KINDS = ("lose", "corr_lose", "flap", "heal", "stick", "brownout")


@dataclass(frozen=True)
class ScriptedFault:
    """One deterministic fault occurrence on a chaos-drill timeline.

    Point events (``lose`` / ``corr_lose`` / ``flap`` / ``heal``) fire in the
    step containing ``at_s``; window events (``stick`` / ``brownout``) are
    active over ``[at_s, until_s)``.  ``corr_lose`` takes ``frac`` of every
    matching pool's live units in the SAME step -- the correlation is the
    shared timeline, no draw needed.  ``pool=None`` hits every pool.
    """

    at_s: float
    kind: str
    pool: str | None = None
    count: int = 1               # units for lose / flap / heal
    frac: float = 1.0            # fraction for corr_lose
    until_s: float = math.inf    # window end for stick / brownout
    factor: float = 2.0          # delay inflation for brownout

    def __post_init__(self):
        if self.kind not in _SCRIPT_KINDS:
            raise ValueError(f"kind must be one of {_SCRIPT_KINDS}, "
                             f"got {self.kind!r}")
        if self.at_s < 0.0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {self.frac}")
        if self.kind in ("stick", "brownout") and self.until_s <= self.at_s:
            raise ValueError(f"until_s {self.until_s} must be > at_s "
                             f"{self.at_s} for {self.kind!r} windows")
        if self.kind == "brownout" and self.factor <= 1.0:
            raise ValueError(f"brownout factor must be > 1, got {self.factor}")

    def hits(self, pool: str) -> bool:
        return self.pool is None or self.pool == pool

    def fires(self, pool: str, now: float, step_s: float) -> bool:
        """Point event lands in the step ``[now, now + step_s)``?"""
        return self.hits(pool) and now <= self.at_s < now + step_s

    def window_active(self, pool: str, now: float) -> bool:
        return self.hits(pool) and self.at_s <= now < self.until_s


class ScriptedFaults:
    """Script-driven injector: the same duck-typed attach point as
    :class:`FaultInjector` (``stuck_builds`` / ``step_draws`` /
    ``delay_factor`` / ``corr_loss`` / ``reset``) but with EXACT timed
    events instead of seeded hazards, so a chaos drill replays identically
    -- same faults at the same virtual times -- on every run.  Stateless:
    every answer is a pure function of (pool, time), which is what makes
    same-seed audit logs byte-identical."""

    def __init__(self, events):
        self.events = tuple(events)
        for ev in self.events:
            if not isinstance(ev, ScriptedFault):
                raise TypeError(f"expected ScriptedFault, got {ev!r}")

    def reset(self) -> None:
        """Nothing to rewind: the timeline is immutable."""

    def stuck_builds(self, pool: str, count: int, now: float) -> int:
        for ev in self.events:
            if ev.kind == "stick" and ev.window_active(pool, now):
                return int(count)
        return 0

    def step_draws(self, pool: str, live: int, unhealthy: int, now: float,
                   step_s: float) -> tuple[int, int, int]:
        lost = flapped = healed = 0
        for ev in self.events:
            if not ev.fires(pool, now, step_s):
                continue
            if ev.kind == "lose":
                lost += ev.count
            elif ev.kind == "flap":
                flapped += ev.count
            elif ev.kind == "heal":
                healed += ev.count
        lost = min(lost, live)
        flapped = min(flapped, max(live - lost - unhealthy, 0))
        healed = min(healed, unhealthy)
        return lost, flapped, healed

    def delay_factor(self, pool: str, now: float) -> float:
        factor = 1.0
        for ev in self.events:
            if ev.kind == "brownout" and ev.window_active(pool, now):
                factor *= ev.factor
        return factor

    def corr_loss(self, pool: str, live: int, now: float,
                  step_s: float) -> int:
        lost = 0
        for ev in self.events:
            if ev.kind == "corr_lose" and ev.fires(pool, now, step_s):
                lost += math.ceil(ev.frac * max(live - lost, 0))
        return min(lost, live)


__all__ = ["FaultInjector", "FaultSpec", "ScriptedFault", "ScriptedFaults"]
