"""Scaling-group configuration: validated pools + desired-state changes.

A *scaling group* names a set of :class:`UnitPool`\\ s plus two kinds of
declarative desired-state changes layered over whatever the policy asks for:

* **scheduled** floors -- "hold at least N units of pool P during [at, end)"
  (the paper's pre-provisioning idea, expressed as desired state rather than
  the delta-voting :class:`ScheduledPolicy`);
* **webhook** floors -- the same, but armed by an external event
  (``group.fire("breaking-news", now)``) and held for ``hold_s`` seconds.

Configs are plain dicts validated by a hand-rolled schema walker (no
dependency on a schema library): unknown keys, wrong types, and targets
naming undeclared pools all raise ``ValueError`` with the offending path,
e.g. ``pools[1].cost_rate: expected number, got str``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from repro_torch.core.scaling.capacity import UnitPool

from .desired import DesiredGroup, PoolTarget

_MISSING = object()


def _get(cfg: Mapping, key: str, types, path: str, *, default=_MISSING):
    """One schema-walker step: presence + type check with a path-qualified error."""
    if key not in cfg:
        if default is _MISSING:
            raise ValueError(f"{path}{key}: required key missing")
        return default
    val = cfg[key]
    if types is bool:
        ok = isinstance(val, bool)
    elif types is int:
        ok = isinstance(val, int) and not isinstance(val, bool)
    elif types is float:   # "number": int or float, but not bool
        ok = isinstance(val, (int, float)) and not isinstance(val, bool)
    else:
        ok = isinstance(val, types)
    if not ok:
        want = {bool: "bool", int: "int", float: "number",
                str: "str", dict: "dict", list: "list"}.get(types, str(types))
        raise ValueError(f"{path}{key}: expected {want}, "
                         f"got {type(val).__name__}")
    return val


def _no_unknown(cfg: Mapping, allowed: set, path: str) -> None:
    unknown = set(cfg) - allowed
    if unknown:
        raise ValueError(f"{path}: unknown key(s) {sorted(unknown)}; "
                         f"allowed: {sorted(allowed)}")


def _targets(cfg: Mapping, pool_names: set, path: str) -> dict[str, int]:
    raw = _get(cfg, "targets", dict, path)
    out = {}
    for pool, n in raw.items():
        if pool not in pool_names:
            raise ValueError(f"{path}targets: unknown pool {pool!r}; "
                             f"declared pools: {sorted(pool_names)}")
        if not isinstance(n, int) or isinstance(n, bool) or n < 0:
            raise ValueError(f"{path}targets[{pool!r}]: expected int >= 0, "
                             f"got {n!r}")
        out[pool] = n
    return out


_POOL_KEYS = {"name", "provision_delay_s", "cost_rate", "min_units",
              "max_units", "starting_units", "preemptible", "revoke_rate",
              "revoke_seed"}


def validate_group_config(cfg: Mapping) -> dict:
    """Validate a scaling-group config dict; returns a normalized copy.

    Schema::

        {"name": str,
         "pools": [{"name": str, "provision_delay_s"?: number,
                    "cost_rate"?: number, "min_units"?: int,
                    "max_units"?: int, "starting_units"?: int,
                    "preemptible"?: bool, "revoke_rate"?: number,
                    "revoke_seed"?: int}, ...],          # >= 1 pool
         "schedule"?: [{"at_s": number, "end_s": number,
                        "targets": {pool: int}}, ...],
         "webhooks"?: [{"name": str, "hold_s": number,
                        "targets": {pool: int}}, ...]}
    """
    if not isinstance(cfg, Mapping):
        raise ValueError(f"group config: expected dict, "
                         f"got {type(cfg).__name__}")
    _no_unknown(cfg, {"name", "pools", "schedule", "webhooks"}, "group config")
    name = _get(cfg, "name", str, "")
    if not name:
        raise ValueError("name: must be non-empty")
    raw_pools = _get(cfg, "pools", list, "")
    if not raw_pools:
        raise ValueError("pools: need at least one pool")
    pools = []
    for i, pc in enumerate(raw_pools):
        path = f"pools[{i}]."
        if not isinstance(pc, Mapping):
            raise ValueError(f"pools[{i}]: expected dict, "
                             f"got {type(pc).__name__}")
        _no_unknown(pc, _POOL_KEYS, f"pools[{i}]")
        pool = {"name": _get(pc, "name", str, path)}
        for key, typ in (("provision_delay_s", float), ("cost_rate", float),
                         ("min_units", int), ("max_units", int),
                         ("starting_units", int), ("preemptible", bool),
                         ("revoke_rate", float), ("revoke_seed", int)):
            val = _get(pc, key, typ, path, default=None)
            if val is not None:
                pool[key] = val
        pools.append(pool)
    pool_names = {p["name"] for p in pools}
    schedule = []
    for i, sc in enumerate(_get(cfg, "schedule", list, "", default=[])):
        path = f"schedule[{i}]."
        if not isinstance(sc, Mapping):
            raise ValueError(f"schedule[{i}]: expected dict, "
                             f"got {type(sc).__name__}")
        _no_unknown(sc, {"at_s", "end_s", "targets"}, f"schedule[{i}]")
        at = _get(sc, "at_s", float, path)
        end = _get(sc, "end_s", float, path)
        if end <= at:
            raise ValueError(f"{path}end_s: must be > at_s ({at}), got {end}")
        schedule.append({"at_s": float(at), "end_s": float(end),
                         "targets": _targets(sc, pool_names, path)})
    webhooks = []
    for i, wc in enumerate(_get(cfg, "webhooks", list, "", default=[])):
        path = f"webhooks[{i}]."
        if not isinstance(wc, Mapping):
            raise ValueError(f"webhooks[{i}]: expected dict, "
                             f"got {type(wc).__name__}")
        _no_unknown(wc, {"name", "hold_s", "targets"}, f"webhooks[{i}]")
        hold = _get(wc, "hold_s", float, path)
        if hold <= 0:
            raise ValueError(f"{path}hold_s: must be > 0, got {hold}")
        webhooks.append({"name": _get(wc, "name", str, path),
                         "hold_s": float(hold),
                         "targets": _targets(wc, pool_names, path)})
    wh_names = [w["name"] for w in webhooks]
    if len(set(wh_names)) != len(wh_names):
        raise ValueError(f"webhooks: duplicate names {wh_names}")
    return {"name": name, "pools": pools, "schedule": schedule,
            "webhooks": webhooks}


@dataclass(frozen=True)
class ScheduledChange:
    at_s: float
    end_s: float
    targets: Mapping[str, int]

    def floors_at(self, now: float) -> Mapping[str, int]:
        return self.targets if self.at_s <= now < self.end_s else {}


@dataclass(frozen=True)
class WebhookTrigger:
    name: str
    hold_s: float
    targets: Mapping[str, int]


@dataclass
class ScalingGroup:
    """Validated pools + scheduled/webhook desired-state floors."""

    name: str
    pools: tuple[UnitPool, ...]
    schedule: tuple[ScheduledChange, ...] = ()
    webhooks: tuple[WebhookTrigger, ...] = ()
    _fired: list[tuple[float, WebhookTrigger]] = field(default_factory=list)

    @classmethod
    def from_config(cls, cfg: Mapping) -> "ScalingGroup":
        norm = validate_group_config(cfg)
        return cls(
            name=norm["name"],
            pools=tuple(UnitPool(**pc) for pc in norm["pools"]),
            schedule=tuple(ScheduledChange(at_s=sc["at_s"], end_s=sc["end_s"],
                                           targets=sc["targets"])
                           for sc in norm["schedule"]),
            webhooks=tuple(WebhookTrigger(name=wc["name"], hold_s=wc["hold_s"],
                                          targets=wc["targets"])
                           for wc in norm["webhooks"]),
        )

    def reset(self) -> None:
        self._fired.clear()

    def fire(self, name: str, now: float) -> WebhookTrigger:
        """Arm webhook ``name`` at ``now``; its floors hold for ``hold_s``."""
        for trig in self.webhooks:
            if trig.name == name:
                self._fired.append((float(now), trig))
                return trig
        raise ValueError(f"unknown webhook {name!r}; declared: "
                         f"{[t.name for t in self.webhooks]}")

    def floors_at(self, now: float) -> dict[str, int]:
        """Active per-pool floors from the schedule and armed webhooks."""
        floors: dict[str, int] = {}
        for sc in self.schedule:
            for pool, n in sc.floors_at(now).items():
                floors[pool] = max(floors.get(pool, 0), n)
        for t0, trig in self._fired:
            if t0 <= now < t0 + trig.hold_s:
                for pool, n in trig.targets.items():
                    floors[pool] = max(floors.get(pool, 0), n)
        return floors

    def overlay(self, desired: DesiredGroup, now: float) -> DesiredGroup:
        """Raise desired targets to any active floors (ceiling-clamped)."""
        floors = self.floors_at(now)
        if not floors:
            return desired
        targets = dict(desired.targets)
        for pool, floor in floors.items():
            cur = targets.get(pool)
            if cur is None:
                continue
            raised = min(max(cur.target, floor), cur.max_units)
            if raised != cur.target:
                targets[pool] = PoolTarget(target=raised,
                                           min_units=cur.min_units,
                                           max_units=cur.max_units)
        return DesiredGroup(targets, generation=desired.generation)

    def as_policy(self, lead_s: float = 0.0):
        """Imperative-mode fallback: the group's schedule and webhooks as a
        delta-voting policy (reuses :class:`ScheduledPolicy` semantics)."""
        from repro_torch.core.autoscaler.policies import WebhookPolicy
        total_sched = tuple(
            (sc.at_s - lead_s, sc.end_s, sum(sc.targets.values()))
            for sc in self.schedule)
        pol = WebhookPolicy(
            triggers={t.name: (sum(t.targets.values()), t.hold_s)
                      for t in self.webhooks},
            schedule=total_sched)
        return pol


__all__ = ["ScalingGroup", "ScheduledChange", "WebhookTrigger",
           "validate_group_config"]
