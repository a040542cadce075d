from repro_torch.core.autoscaler.base import CompositePolicy, Decision, Observation, Policy
from repro_torch.core.autoscaler.policies import (
    AppDataPolicy,
    CheapestFirstRouter,
    LoadPolicy,
    ScheduledPolicy,
    TargetTrackingPolicy,
    ThresholdPolicy,
    WebhookPolicy,
)

__all__ = [
    "CompositePolicy", "Decision", "Observation", "Policy",
    "AppDataPolicy", "CheapestFirstRouter", "LoadPolicy", "ScheduledPolicy",
    "TargetTrackingPolicy", "ThresholdPolicy", "WebhookPolicy",
]
