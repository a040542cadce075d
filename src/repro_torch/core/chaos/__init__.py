"""Incident-hardening layer: seeded chaos drills over the convergence plane.

A *drill* replays a scripted incident -- timed replica kills, correlated
multi-replica loss, brownout windows, operator webhooks landing mid-retry --
against a live serving target, then proves recovery was *correct*, not just
eventual, by checking invariants after every step and at drill end:

* **exactly-once** -- every admitted request finishes exactly once; no loss,
  no duplicates (:func:`~repro_torch.core.chaos.invariants.check_exactly_once`);
* **bit-identical** -- the faulted run's outputs match a fault-free reference
  token-for-token (:func:`~repro_torch.core.chaos.invariants.check_outputs_match`);
* **KV conservation** -- the page free list balances across kill / drain /
  respawn (:func:`~repro_torch.core.chaos.invariants.check_kv_conservation`);
* **audit replay** -- the sealed JSONL log loads clean and replaying its
  planner inputs reproduces the converger's decisions byte-for-byte, with no
  step issued against a superseded desired-state generation
  (:func:`~repro_torch.core.chaos.invariants.check_audit`).

:mod:`.script` holds the deterministic fault schedule (a
:class:`~repro_torch.core.chaos.script.ChaosScript` of timed
:class:`~repro_torch.core.chaos.script.ChaosAction` entries -- seeded victim
selection, replayable byte-for-byte); :mod:`.drill` runs the
reference-vs-faulted pair and aggregates violations into a
:class:`~repro_torch.core.chaos.drill.DrillReport`.  Process-level fault windows
(stuck builds, brownouts, flaps) compose via
:class:`~repro_torch.core.convergence.faults.ScriptedFaults` on the same clock.
"""
from .drill import ChaosDrill, DrillReport
from .invariants import (
    Violation, check_audit, check_exactly_once, check_kv_conservation,
    check_outputs_match,
)
from .script import ChaosAction, ChaosScript

__all__ = [
    "ChaosAction",
    "ChaosDrill",
    "ChaosScript",
    "DrillReport",
    "Violation",
    "check_audit",
    "check_exactly_once",
    "check_kv_conservation",
    "check_outputs_match",
]
