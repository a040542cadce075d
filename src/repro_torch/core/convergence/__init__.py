"""Convergence control plane: desired-state reconciliation for the fleet.

The imperative :class:`~repro_torch.core.scaling.ScalingController` actuates policy
deltas directly and assumes every provisioning action succeeds.  This package
adds the production-style alternative (``ControllerConfig(convergence=True)``):
policies still vote deltas, but a thin adapter folds them into a *desired
state* (:mod:`.desired`), a pure planner diffs desired vs observed capacity
into typed steps (:mod:`.planner`), and a converger loop executes the steps
with build timeouts, bounded retries and exponential backoff (:mod:`.converger`)
-- healing capacity lost to the seeded fault processes in :mod:`.faults`.
Every observation, plan, step, and outcome lands in an append-only JSONL audit
log (:mod:`.audit`) that tests replay back to the exact final plan state.
:mod:`.groups` adds dict-schema-validated scaling-group configs with scheduled
and webhook-triggered desired-state changes.

With no faults injected, a converged fleet plans zero steps and the whole
plane is bit-for-bit equivalent to the imperative path (pinned by parity
tests against the simulator goldens).
"""
from .audit import AuditIntegrityError, AuditLog, replay, verify_plan_replay
from .converger import (
    Converger, ConvergerConfig, PlanExecutor, StepExecutor, StepOutcome,
)
from .desired import DesiredGroup, PoolTarget, derive_desired, observed_group
from .faults import FaultInjector, FaultSpec, ScriptedFault, ScriptedFaults
from .groups import (
    ScalingGroup, ScheduledChange, WebhookTrigger, validate_group_config,
)
from .planner import (
    CancelPending, DrainUnit, LaunchUnit, ReplaceUnhealthy, Step, plan_steps,
    step_record,
)

__all__ = [
    "AuditIntegrityError",
    "AuditLog",
    "CancelPending",
    "Converger",
    "ConvergerConfig",
    "DesiredGroup",
    "DrainUnit",
    "FaultInjector",
    "FaultSpec",
    "LaunchUnit",
    "PlanExecutor",
    "PoolTarget",
    "ReplaceUnhealthy",
    "StepExecutor",
    "ScalingGroup",
    "ScheduledChange",
    "ScriptedFault",
    "ScriptedFaults",
    "Step",
    "StepOutcome",
    "WebhookTrigger",
    "derive_desired",
    "observed_group",
    "plan_steps",
    "replay",
    "step_record",
    "validate_group_config",
    "verify_plan_replay",
]
