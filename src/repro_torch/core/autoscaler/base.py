"""Auto-scaling policy interface shared by every scaling backend (tweet
simulator, elastic LLM-serving fleet, live serving driver).

A policy sees an :class:`Observation` once per adaptation period and returns a
:class:`Decision`.  The *controller* (`repro_torch.core.scaling.ScalingController`)
owns the mechanics the paper fixes in Table III: the 60 s adaptation
frequency, the 60 s resource-provisioning delay, the 1-unit-at-a-time
downscale limit, and the >= 1 resource floor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Mapping

if TYPE_CHECKING:  # no runtime import: scaling.controller imports this module
    from repro_torch.core.scaling.capacity import PoolStats
    from repro_torch.core.scaling.signals import WindowStats


@dataclass(frozen=True)
class Observation:
    """What a policy may look at.  Three tiers, per the paper's taxonomy:

    * infrastructure level -- ``utilization``;
    * system level -- ``n_in_system`` (queue + in service), ``input_rate``;
    * application level -- ``signals``: windowed stats per *named channel* of
      data produced by the application itself (sentiment of processed tweets,
      score of generated answers, any user channel).

    The ``app_*`` fields are the pre-redesign single-channel view; the
    controller keeps them mirrored to its primary channel so existing policies
    keep working.  New policies should read ``signal(channel)``.
    """

    time: float
    n_units: int                      # currently usable resources (CPUs / replicas)
    n_pending: int                    # allocated, still inside the provisioning delay
    utilization: float                # mean busy fraction over the last adapt window
    n_in_system: int
    input_rate: float                 # arrivals/s over the last adapt window
    app_window_mean: float = 0.0      # mean app-signal, last window (post-time indexed)
    app_prev_window_mean: float = 0.0  # mean app-signal, window before that
    app_window_count: int = 0         # how many signal samples backed app_window_mean
    signals: Mapping[str, WindowStats] = field(default_factory=dict)
    pools: Mapping[str, PoolStats] = field(default_factory=dict)
    # ``pools``: per-pool capacity view (live/pending/price/preemptible) when the
    # controller runs a typed CapacityPlan; n_units/n_pending stay the totals.

    def signal(self, channel: str | None = None) -> WindowStats:
        """Windowed stats for a named channel; ``None`` selects the backend's
        primary channel (equivalently, the legacy ``app_*`` fields).

        Channels register lazily on their first recorded sample, so a channel
        with no data yet — or a misspelled name — reads as empty stats
        (``count == 0``) rather than raising; signal-driven policies should
        treat ``count`` below their sample floor as "no evidence"."""
        from repro_torch.core.scaling.signals import WindowStats
        if channel is not None:
            if channel in self.signals:
                return self.signals[channel]
            return WindowStats()
        return WindowStats(mean=self.app_window_mean,
                           count=self.app_window_count,
                           prev_mean=self.app_prev_window_mean)


@dataclass(frozen=True)
class Decision:
    """delta > 0 allocates (subject to provisioning delay); delta < 0 releases.

    The scalar ``delta`` targets the controller's *default* pool.  A
    pool-aware policy may instead set ``pools`` to per-pool deltas (e.g.
    ``{"spot": +4}``); when ``pools`` is not None it is authoritative and
    ``delta`` is ignored.  ``total`` is the net delta either way -- the sign
    every scalar consumer (composition, veto logic) keys on.
    """

    delta: int = 0
    reason: str = ""
    pools: Mapping[str | None, int] | None = None

    @property
    def total(self) -> int:
        if self.pools is not None:
            return sum(self.pools.values())
        return self.delta

    def pool_deltas(self, default_pool: str) -> dict[str, int]:
        """Per-pool deltas with the scalar form mapped onto ``default_pool``.
        (A ``None`` key -- produced when composition merges a scalar vote with
        pool-targeted ones -- also resolves to the default pool.)"""
        if self.pools is None:
            return {default_pool: int(self.delta)} if self.delta else {}
        out: dict[str, int] = {}
        for name, d in self.pools.items():
            key = default_pool if name is None else name
            out[key] = out.get(key, 0) + int(d)
        return {k: v for k, v in out.items() if v != 0}

    def __add__(self, other: "Decision") -> "Decision":
        reason = ";".join(r for r in (self.reason, other.reason) if r)
        if self.pools is None and other.pools is None:
            return Decision(self.delta + other.delta, reason)
        # merge in pool space; scalar sides keep targeting the default pool,
        # represented by the None key until the controller resolves it
        merged: dict[str | None, int] = {}
        for d in (self, other):
            items = (d.pools.items() if d.pools is not None
                     else ((None, d.delta),) if d.delta else ())
            for name, dd in items:
                merged[name] = merged.get(name, 0) + int(dd)
        merged = {k: v for k, v in merged.items() if v != 0}
        if set(merged) <= {None}:
            return Decision(merged.get(None, 0), reason)
        return Decision(0, reason, pools=merged)


class Policy:
    """Base class.  Policies are stateful (e.g. edge detection) but cheap."""

    name = "base"

    def reset(self) -> None:  # called once per simulation run
        pass

    def decide(self, obs: Observation) -> Decision:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class CompositePolicy(Policy):
    """Run several policies side by side (paper: appdata "runs alongside the load
    algorithm").  Upscale requests add; downscale is capped at -1 by the controller."""

    name = "composite"

    def __init__(self, policies: list[Policy]):
        self.policies = list(policies)

    def reset(self) -> None:
        for p in self.policies:
            p.reset()

    def decide(self, obs: Observation) -> Decision:
        total = Decision()
        for p in self.policies:
            d = p.decide(obs)
            # A positive vote from any sub-policy wins over another's -1 release.
            if d.total > 0 and total.total < 0:
                total = dataclasses.replace(total, delta=0, pools=None)
            if total.total > 0 and d.total < 0:
                d = dataclasses.replace(d, delta=0, pools=None)
            total = total + d
        return total

    def describe(self) -> str:
        return "+".join(p.describe() for p in self.policies)
