"""ScalableBackend protocol + the shared RunReport result schema.

A backend is anything that serves work with a scalable pool of units and lets
a :class:`~repro_torch.core.scaling.controller.ScalingController` drive the pool:
the tweet simulator (`repro_torch.core.simulator.Engine`), the elastic replica
fleet (`repro_torch.core.elastic.ElasticCluster`), and the live serving driver
(`repro_torch.launch.serve.ServeBackend`).  They all return a RunReport, so
benchmarks and examples compare policies across backends with one code path.

RunReport also supports ``report["key"]`` lookups over its summary dict so
pre-redesign call sites that consumed the ElasticCluster result dict keep
working unchanged.

The capacity redesign adds the *priced* view: per-pool unit-seconds and cost
rates (filled from ``CapacityPlan.report_kwargs()``) roll up into ``cost``,
and an optional :class:`~repro_torch.core.scaling.capacity.Sla` spec plus per-item
``classes`` labels yield per-request-class violation rates and the
worst-class breakdown -- the paper's economics (SLA violations vs money
spent) made first-class in every backend's report.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.scaling.capacity import Sla
from repro_torch.core.scaling.controller import DecisionRecord


@dataclass
class RunReport:
    """Per-run outputs every backend reports in the same shape."""

    backend: str                  # "simulator" | "elastic" | "serve" | ...
    workload: str                 # trace / stream identifier
    policy: str                   # policy.describe()
    sla_s: float
    latencies: np.ndarray         # per-item completion latency, seconds
    unit_seconds: float           # integral of usable units over time
    units_t: np.ndarray           # usable units per step
    n_decisions_up: int = 0
    n_decisions_down: int = 0
    unit_name: str = "unit"       # what one unit is (cpu / replica / slot)
    decisions: list[DecisionRecord] = field(default_factory=list)
    extra: dict[str, Any] = field(default_factory=dict)   # backend-specific rows
    sla: Sla | None = None        # per-class deadline spec (None: flat sla_s)
    classes: np.ndarray | None = None   # per-item request-class labels, aligned
                                        # with ``latencies``
    pool_unit_seconds: dict[str, float] = field(default_factory=dict)
    pool_cost_rates: dict[str, float] = field(default_factory=dict)
    n_revocations: int = 0
    # measured provisioning delay per pool (only pools an executor calibrated
    # from a real spawn appear; configured guesses never show up here)
    pool_provision_delay_s: dict[str, float] = field(default_factory=dict)
    _summary_cache: dict[str, Any] | None = field(
        default=None, init=False, repr=False, compare=False)

    # -- derived metrics -------------------------------------------------------------
    @property
    def n_done(self) -> int:
        return int(self.latencies.size)

    def _deadlines(self) -> np.ndarray | float:
        """Per-item deadline array (per-class Sla + labels) or the flat SLA."""
        if self.sla is None:
            return self.sla_s
        if self.classes is not None and self.sla.per_class:
            return self.sla.deadlines(self.classes)
        return self.sla.default_s

    @property
    def violation_rate(self) -> float:
        if self.latencies.size == 0:
            return 0.0
        return float(np.mean(self.latencies > self._deadlines()))

    def violation_rate_by_class(self) -> dict[str, float]:
        """Violation rate per request class (empty when classes are unknown)."""
        if self.classes is None or self.latencies.size == 0:
            return {}
        cls = np.asarray(self.classes)
        out = {}
        for c in np.unique(cls):
            m = cls == c
            thr = self.sla.deadline_s(str(c)) if self.sla is not None else self.sla_s
            out[str(c)] = float(np.mean(self.latencies[m] > thr))
        return out

    @property
    def worst_class(self) -> tuple[str, float] | None:
        """(request class, violation rate) of the worst-served class."""
        by_cls = self.violation_rate_by_class()
        if not by_cls:
            return None
        name = max(by_cls, key=by_cls.get)
        return name, by_cls[name]

    @property
    def cost(self) -> float:
        """Priced capacity: sum over pools of unit-hours x cost_rate.  Without
        pool accounting (a legacy single-pool backend), one unit-hour costs
        1.0 so ``cost == unit_hours``."""
        if self.pool_unit_seconds:
            return sum(us / 3600.0 * self.pool_cost_rates.get(name, 1.0)
                       for name, us in self.pool_unit_seconds.items())
        return self.unit_hours

    @property
    def mean_latency_s(self) -> float:
        return float(self.latencies.mean()) if self.latencies.size else 0.0

    @property
    def p99_latency_s(self) -> float:
        return float(np.quantile(self.latencies, 0.99)) if self.latencies.size else 0.0

    @property
    def unit_hours(self) -> float:
        return self.unit_seconds / 3600.0

    @property
    def max_units(self) -> int:
        return int(self.units_t.max()) if self.units_t.size else 0

    def summary(self) -> dict[str, Any]:
        # reports are effectively immutable after construction; cache so the
        # mapping shim doesn't recompute quantiles on every lookup
        if self._summary_cache is not None:
            return dict(self._summary_cache)
        out = {
            "backend": self.backend,
            "workload": self.workload,
            "policy": self.policy,
            "n_done": self.n_done,
            "violation_rate": self.violation_rate,
            "violation_pct": 100.0 * self.violation_rate,
            "mean_latency_s": self.mean_latency_s,
            "p99_latency_s": self.p99_latency_s,
            f"{self.unit_name}_hours": self.unit_hours,
            "max_units": self.max_units,
            f"max_{self.unit_name}s": self.max_units,
            "n_scale_ups": self.n_decisions_up,
            "n_scale_downs": self.n_decisions_down,
            "cost": self.cost,
        }
        by_cls = self.violation_rate_by_class()
        if by_cls:
            for cls, rate in sorted(by_cls.items()):
                out[f"viol_pct.{cls}"] = 100.0 * rate
            worst, worst_rate = self.worst_class
            out["worst_class"] = worst
            out["worst_class_viol_pct"] = 100.0 * worst_rate
        if len(self.pool_unit_seconds) > 1 or self.n_revocations:
            for name, us in sorted(self.pool_unit_seconds.items()):
                out[f"unit_hours.{name}"] = us / 3600.0
            out["n_revocations"] = self.n_revocations
        for name, d in sorted(self.pool_provision_delay_s.items()):
            out[f"measured_delay_s.{name}"] = d
        out.update(self.extra)
        self._summary_cache = out
        return dict(out)

    # -- mapping shim (legacy result-dict call sites) ---------------------------------
    def __getitem__(self, key: str) -> Any:
        return self.summary()[key]

    def __contains__(self, key: str) -> bool:
        return key in self.summary()

    def keys(self) -> Iterator[str]:
        return iter(self.summary().keys())


@runtime_checkable
class ScalableBackend(Protocol):
    """Anything a ScalingController can scale: run one workload, report one
    RunReport.  Backends construct their controller themselves (they know
    their unit semantics, step size, and signal channels)."""

    def run(self) -> RunReport: ...


def compare(reports: Mapping[str, RunReport]) -> list[dict[str, Any]]:
    """Flatten named reports into comparable summary rows (one code path for
    benchmarks/ and examples/ across backends)."""
    rows = []
    for name, rep in reports.items():
        row = {"name": name}
        row.update(rep.summary())
        rows.append(row)
    return rows


__all__ = ["RunReport", "ScalableBackend", "compare"]
