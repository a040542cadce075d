"""The scaling control plane: monitoring (SignalBus), decision/actuation
(ScalingController over a typed CapacityPlan of UnitPools), the shared
water-filling service core (ServiceProcess), and the backend/result contract
(ScalableBackend, RunReport with priced cost and per-class SLAs) every scaled
system shares.  See DESIGN.md."""
from repro_torch.core.scaling.signals import DEFAULT_CHANNEL, SignalBus, WindowStats
from repro_torch.core.scaling.capacity import (
    DEFAULT_POOL,
    CapacityPlan,
    PoolStats,
    RevocationEvent,
    Sla,
    UnitPool,
)
from repro_torch.core.scaling.controller import (
    ControllerConfig,
    DecisionRecord,
    ScalingController,
)
from repro_torch.core.scaling.service import ServiceProcess, StepResult, water_level
from repro_torch.core.scaling.backend import RunReport, ScalableBackend, compare
from repro_torch.core.scaling.registry import (
    available_policies,
    make_policy,
    register_policy,
)

__all__ = [
    "DEFAULT_CHANNEL", "SignalBus", "WindowStats",
    "DEFAULT_POOL", "CapacityPlan", "PoolStats", "RevocationEvent", "Sla",
    "UnitPool",
    "ControllerConfig", "DecisionRecord", "ScalingController",
    "ServiceProcess", "StepResult", "water_level",
    "RunReport", "ScalableBackend", "compare",
    "available_policies", "make_policy", "register_policy",
]
