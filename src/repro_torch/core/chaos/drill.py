"""The drill harness: reference run, faulted run, invariant verdict.

A :class:`ChaosDrill` owns one scripted incident end to end: it builds a
fault-free *reference* backend and runs it to completion, rewinds the
script, builds the *faulted* backend with the script wired into its
``on_step`` hook (cheap invariants -- duplicate completions, KV page
conservation -- checked after every step), runs it, then applies the full
invariant battery from :mod:`.invariants` and folds everything into a
:class:`DrillReport`.

The backend factory is duck-typed: it is called as
``make_backend(on_step=..., audit_path=...)`` and must return an object
with ``run()``, ``requests`` / ``completed`` (objects carrying ``rid``),
a ``pool`` of real replicas (for KV checks; targets without one are
skipped via ``getattr``), and a ``controller`` exposing the capacity plan
for the audit final-state cross check --
:class:`~repro_torch.serving.fleet.FleetBackend` is the canonical target.
Elastic-simulator incidents instead compose
:class:`~repro_torch.core.convergence.faults.ScriptedFaults` (process-level
loss/brownout windows) with :func:`~repro_torch.core.chaos.invariants.check_audit`
directly; see ``benchmarks/chaos_drills.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .invariants import (
    Violation, check_audit, check_exactly_once, check_kv_conservation,
    check_outputs_match,
)
from .script import ChaosScript


@dataclass
class DrillReport:
    """Outcome of one drill: what fired, what broke, what completed."""

    name: str
    violations: list[Violation]
    fired: list[dict]                   # script actions that actually ran
    n_completed: int
    n_reference: int
    audit_path: str | None = None
    extra: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        verdict = ("OK" if self.ok
                   else f"{len(self.violations)} violation(s)")
        lines = [f"drill {self.name!r}: {verdict} "
                 f"({len(self.fired)} actions, {self.n_completed}/"
                 f"{self.n_reference} requests)"]
        lines.extend(f"  - {v}" for v in self.violations)
        return "\n".join(lines)


class ChaosDrill:
    """One scripted incident, checked for observational equivalence.

    ``make_backend(on_step=..., audit_path=...)`` must build a *fresh*
    target each call -- requests are mutable (the engine fills outputs in
    place), so reference and faulted passes cannot share them.
    """

    def __init__(self, name: str, make_backend, script: ChaosScript, *,
                 audit_path: str | None = None, per_step_checks: bool = True):
        self.name = name
        self.make_backend = make_backend
        self.script = script
        self.audit_path = audit_path
        self.per_step_checks = per_step_checks

    def run(self) -> DrillReport:
        reference = self.make_backend(on_step=None, audit_path=None)
        reference.run()

        self.script.reset()
        step_violations: list[Violation] = []

        def hook(backend, now):
            self.script.on_step(backend, now)
            if not self.per_step_checks:
                return
            rids = [r.rid for r in backend.requests]
            step_violations.extend(
                check_exactly_once(rids, backend.completed, final=False))
            pool = getattr(backend, "pool", None)
            if pool is not None:
                step_violations.extend(check_kv_conservation(pool))

        faulted = self.make_backend(on_step=hook, audit_path=self.audit_path)
        faulted.run()

        violations = list(step_violations)
        violations += check_exactly_once(
            [r.rid for r in faulted.requests], faulted.completed)
        violations += check_outputs_match(faulted.completed,
                                          reference.completed)
        pool = getattr(faulted, "pool", None)
        if pool is not None:
            violations += check_kv_conservation(pool, drained=True)
        if self.audit_path is not None:
            plan = faulted.controller.plan
            final_state = {p.name: {"live": plan.live_of(p.name),
                                    "pending": plan.pending_of(p.name)}
                           for p in plan}
            violations += check_audit(self.audit_path, final_state)

        # a per-step breakage repeats every later step; report each once
        deduped = list(dict.fromkeys(violations))
        return DrillReport(
            name=self.name,
            violations=deduped,
            fired=list(self.script.fired),
            n_completed=len(faulted.completed),
            n_reference=len(reference.completed),
            audit_path=self.audit_path,
        )


__all__ = ["ChaosDrill", "DrillReport"]
