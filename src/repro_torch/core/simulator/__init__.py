from repro_torch.core.simulator.distributions import CLASSES, ServiceModel, TweetClass
from repro_torch.core.simulator.engine import Engine, SimConfig, SimResult, repeat_until_ci, run_scenario
from repro_torch.core.simulator.workload import MATCHES, MatchSpec, Trace, generate_trace

__all__ = [
    "CLASSES", "ServiceModel", "TweetClass",
    "Engine", "SimConfig", "SimResult", "run_scenario", "repeat_until_ci",
    "MATCHES", "MatchSpec", "Trace", "generate_trace",
]
