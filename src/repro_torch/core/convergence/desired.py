"""The desired-state model: what the fleet *should* look like.

The paper's controllers emit imperative deltas ("add 1 CPU") and assume every
action succeeds.  The convergence plane instead keeps a :class:`DesiredGroup`
-- per-pool target counts with floors and ceilings -- and continuously
reconciles observed capacity toward it, so capacity lost to revocation,
unit-loss faults, or stuck builds is healed without the policy noticing.

:func:`derive_desired` is the thin adapter that lets every existing policy
work unchanged: it folds a policy ``Decision``'s per-pool deltas into the
previous desired state using exactly the imperative controller's semantics
(ceiling-clamped upscales; net downscale capped per tick and distributed
expensive-first, cancellable-pending before live-above-floor).  With no
faults injected the derived target always equals what the imperative path
would have actuated, which is what keeps the golden parity tests bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from repro_torch.core.scaling.capacity import PoolStats


@dataclass(frozen=True)
class PoolTarget:
    """Desired unit count for one pool, with its actuation bounds."""

    target: int
    min_units: int = 0
    max_units: int = 4096

    def __post_init__(self):
        if self.target < 0:
            raise ValueError(f"target must be >= 0, got {self.target}")


@dataclass(frozen=True)
class DesiredGroup:
    """Per-pool targets the converger reconciles the fleet toward.

    ``generation`` is the desired-state epoch: the converger bumps it on
    every intent change (policy tick, webhook floor, schedule edge) and
    stamps it onto the steps it plans, so retry/backoff state belonging to
    a superseded intent can be discarded instead of resumed, and the audit
    log can prove no step ever contradicted the latest desired state.
    """

    targets: Mapping[str, PoolTarget]
    generation: int = 0

    @property
    def total(self) -> int:
        return sum(t.target for t in self.targets.values())

    def target_of(self, name: str) -> int:
        t = self.targets.get(name)
        return t.target if t is not None else 0

    def with_target(self, name: str, target: int) -> "DesiredGroup":
        cur = self.targets[name]
        new = dict(self.targets)
        new[name] = PoolTarget(target=int(target), min_units=cur.min_units,
                               max_units=cur.max_units)
        return DesiredGroup(new, generation=self.generation)


def observed_group(stats: Mapping[str, PoolStats]) -> DesiredGroup:
    """Desired state that ratifies what is currently observed (live+pending)."""
    return DesiredGroup({
        name: PoolTarget(target=ps.units + ps.pending,
                         min_units=ps.min_units, max_units=ps.max_units)
        for name, ps in stats.items()
    })


def derive_desired(prev: DesiredGroup | None,
                   stats: Mapping[str, PoolStats],
                   deltas: Mapping[str, int],
                   *, downscale_cap: int = 1) -> DesiredGroup:
    """Fold a policy decision's per-pool ``deltas`` into the desired state.

    Mirrors ``ScalingController.maybe_adapt``'s imperative actuation exactly:

    * positive per-pool deltas raise that pool's target, clamped to its
      ceiling (the request-time headroom clamp);
    * the net negative delta is capped at ``downscale_cap`` per tick and
      distributed most-expensive-first, reducing targets by what a release
      could actually reclaim right now (observed cancellable pending first,
      then observed live above the floor).

    ``prev=None`` starts from the observed state, so a pool the policy never
    touches keeps whatever it started with.
    """
    for name in deltas:
        if name not in stats:
            raise ValueError(f"unknown pool {name!r}; observed pools: "
                             f"{list(stats)}")
    base = prev if prev is not None else observed_group(stats)
    targets = {
        name: (base.target_of(name) if name in base.targets
               else ps.units + ps.pending)
        for name, ps in stats.items()
    }
    for name, d in deltas.items():
        if d > 0:
            targets[name] = min(targets[name] + d, stats[name].max_units)
    down_req = -sum(d for d in deltas.values() if d < 0)
    if down_req > 0:
        want = min(downscale_cap, down_req)
        index = {name: i for i, name in enumerate(stats)}
        order = sorted(stats.items(),
                       key=lambda kv: (kv[1].cost_rate, index[kv[0]]),
                       reverse=True)
        for name, ps in order:                 # pass 1: cancellable pending
            take = min(want, ps.pending, targets[name])
            targets[name] -= take
            want -= take
        for name, ps in order:                 # pass 2: live above floor
            take = min(want, max(ps.units - ps.min_units, 0), targets[name])
            targets[name] -= take
            want -= take
    return DesiredGroup({
        name: PoolTarget(target=targets[name], min_units=ps.min_units,
                         max_units=ps.max_units)
        for name, ps in stats.items()
    })


__all__ = ["DesiredGroup", "PoolTarget", "derive_desired", "observed_group"]
