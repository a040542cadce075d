"""Deterministic fault schedules for chaos drills.

A :class:`ChaosScript` is a sorted list of timed :class:`ChaosAction`
entries bound to a live serving target through the target's ``on_step``
hook.  Everything is a pure function of (script, seed, step clock): victim
selection draws from a seeded generator, actions fire on the first step at
or past their timestamp, and :meth:`ChaosScript.reset` rewinds the whole
schedule for a byte-identical re-run -- the property the audit-determinism
gate in ``benchmarks/chaos_drills.py`` relies on.

The target is duck-typed.  ``webhook`` actions need ``fire_webhook(name,
now)`` (:class:`~repro_torch.serving.fleet.FleetBackend`, or a
:class:`~repro_torch.core.scaling.ScalingController` via an adapter); ``kill`` /
``corr_kill`` actions additionally need ``pool.serving`` (replicas with an
``rix``) and ``kill_replica(replica, now)`` -- i.e. a fleet of real engines.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: action kinds, in intra-step execution order (kills land before operator
#: intent so a webhook fired "at the same instant" sees the loss)
KINDS = ("kill", "corr_kill", "webhook")


@dataclass(frozen=True)
class ChaosAction:
    """One timed fault in a drill script.

    * ``kill`` -- abrupt loss of ``count`` live replicas; victims are a
      seeded uniform draw over the serving set (in-flight work restarts
      from scratch, same semantics as eviction).
    * ``corr_kill`` -- correlated loss of ``ceil(frac * live)`` replicas in
      a single tick, modelling an AZ / rack failure domain.
    * ``webhook`` -- operator intent lands mid-incident: fire the scaling
      group's webhook ``name``.  In convergence mode its floors apply to
      the desired state *immediately*, superseding any in-flight retry or
      backoff for the affected pools.
    """

    at_s: float
    kind: str
    count: int = 1
    frac: float = 0.5
    name: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown action kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.at_s < 0:
            raise ValueError(f"at_s={self.at_s} must be >= 0")
        if self.count < 1:
            raise ValueError(f"count={self.count} must be >= 1")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac={self.frac} must be in (0, 1]")
        if self.kind == "webhook" and not self.name:
            raise ValueError("webhook action needs a name")


class ChaosScript:
    """Seeded, replayable incident schedule.

    Pass :meth:`on_step` as the target's ``on_step`` hook (both
    ``FleetBackend`` and ``ElasticCluster`` call it as ``hook(target, t)``
    once per step, after capacity lands and before arrivals).  Every action
    due at or before the current step fires exactly once, in timestamp
    order (ties break by :data:`KINDS` order, then webhook name);
    :attr:`fired` records what actually happened -- kill victims by
    ``rix`` -- for assertions and drill reports.
    """

    def __init__(self, actions, *, seed: int = 0):
        acts = tuple(actions)
        for a in acts:
            if not isinstance(a, ChaosAction):
                raise TypeError(f"expected ChaosAction, got {type(a).__name__}")
        self.actions = tuple(sorted(
            acts, key=lambda a: (a.at_s, KINDS.index(a.kind), a.name)))
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._cursor = 0
        self.fired: list[dict] = []

    def reset(self) -> None:
        """Rewind for a byte-identical re-run (same seed, same draws)."""
        self._rng = np.random.default_rng(self.seed)
        self._cursor = 0
        self.fired = []

    @property
    def done(self) -> bool:
        return self._cursor >= len(self.actions)

    def on_step(self, target, now: float) -> None:
        while (self._cursor < len(self.actions)
               and self.actions[self._cursor].at_s <= now):
            action = self.actions[self._cursor]
            self._cursor += 1
            self._fire(target, action, now)

    def _fire(self, target, action: ChaosAction, now: float) -> None:
        if action.kind == "webhook":
            target.fire_webhook(action.name, now)
            self.fired.append({"t": now, "kind": "webhook",
                               "name": action.name})
            return
        live = sorted(target.pool.serving, key=lambda r: r.rix)
        if action.kind == "kill":
            k = min(action.count, len(live))
        else:                                   # corr_kill: failure domain
            k = min(max(math.ceil(action.frac * len(live)), 1), len(live))
        picks = (self._rng.choice(len(live), size=k, replace=False)
                 if k else np.empty(0, np.int64))
        victims = [live[i] for i in sorted(int(p) for p in picks)]
        for rep in victims:
            target.kill_replica(rep, now)
        self.fired.append({"t": now, "kind": action.kind,
                           "victims": [r.rix for r in victims]})


__all__ = ["KINDS", "ChaosAction", "ChaosScript"]
