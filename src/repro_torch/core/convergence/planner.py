"""The pure planner: diff desired vs observed capacity into typed steps.

``plan_steps`` is a pure function of (desired, observed) -- no clocks, no
randomness, no plan mutation -- so it is trivially testable and *idempotent*:
on a converged fleet it returns ``[]``.  The converger executes whatever it
emits and simply re-plans on the next tick, which is what makes partial
failures safe: an under-applied step just shows up as remaining diff.

Step ordering within one plan: cancellations of stuck builds first (they
free ceiling headroom), then replacements of unhealthy units, then scale-down
steps, then launches (which can use the headroom the earlier steps freed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Union

from repro_torch.core.scaling.capacity import PoolStats

from .desired import DesiredGroup


@dataclass(frozen=True)
class LaunchUnit:
    """Queue ``count`` new builds of ``pool``.  ``gen`` is the desired-state
    generation the step serves (0 = ungenerationed, pre-epoch callers)."""

    pool: str
    count: int
    gen: int = 0


@dataclass(frozen=True)
class CancelPending:
    """Cancel ``count`` pending builds of ``pool`` (``reason``: surplus or
    stuck)."""

    pool: str
    count: int
    reason: str = "surplus"
    gen: int = 0


@dataclass(frozen=True)
class DrainUnit:
    """Voluntarily drain ``count`` live units of ``pool`` (floor-respecting)."""

    pool: str
    count: int
    gen: int = 0


@dataclass(frozen=True)
class ReplaceUnhealthy:
    """Tear down ``count`` unhealthy units of ``pool`` and queue replacements."""

    pool: str
    count: int
    gen: int = 0


Step = Union[LaunchUnit, CancelPending, DrainUnit, ReplaceUnhealthy]


def step_record(s: Step) -> dict:
    """Canonical audit-record form of one step (what ``plan`` records carry
    and what the replay verifier recomputes -- one serializer, no drift)."""
    rec = {"step": type(s).__name__, "pool": s.pool, "count": s.count}
    if isinstance(s, CancelPending):
        rec["reason"] = s.reason
    return rec


def plan_steps(desired: DesiredGroup,
               stats: Mapping[str, PoolStats],
               *,
               overdue: Mapping[str, int] | None = None,
               launch_blocked: frozenset | set = frozenset(),
               replace_blocked: frozenset | set = frozenset()) -> list[Step]:
    """Diff ``desired`` against observed ``stats`` and emit convergence steps.

    ``overdue`` carries per-pool counts of builds considered stuck (expected
    landing more than the build timeout ago); they are cancelled and their
    replacement launch re-planned, subject to ``launch_blocked`` (pools in
    retry backoff or given up).  ``replace_blocked`` damps health-flap thrash.
    """
    overdue = overdue or {}
    gen = desired.generation
    stuck_cancels: list[Step] = []
    replaces: list[Step] = []
    downs: list[Step] = []
    ups: list[Step] = []
    for name, ps in stats.items():
        od = min(overdue.get(name, 0), ps.pending)
        if od > 0:
            stuck_cancels.append(CancelPending(name, od, reason="stuck",
                                               gen=gen))
        if ps.unhealthy > 0 and name not in replace_blocked:
            replaces.append(ReplaceUnhealthy(name, ps.unhealthy, gen=gen))
        have = ps.units + ps.pending - od
        target = desired.target_of(name) if name in desired.targets else have
        if have > target:
            surplus = have - target
            cancel = min(ps.pending - od, surplus)
            if cancel > 0:
                downs.append(CancelPending(name, cancel, gen=gen))
                surplus -= cancel
            drainable = min(surplus, max(ps.units - ps.min_units, 0))
            if drainable > 0:
                downs.append(DrainUnit(name, drainable, gen=gen))
        elif have < target and name not in launch_blocked:
            ups.append(LaunchUnit(name, target - have, gen=gen))
    return stuck_cancels + replaces + downs + ups


__all__ = ["CancelPending", "DrainUnit", "LaunchUnit", "ReplaceUnhealthy",
           "Step", "plan_steps", "step_record"]
