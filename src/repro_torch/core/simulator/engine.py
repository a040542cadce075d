"""Discrete-time processor-sharing simulator (paper §IV-A/B) with auto-scaling.

The paper's Algorithm 1 distributes the CPU cycles of one simulation step
egalitarianly among all in-flight tweets, redistributing each tweet's excess to the
still-hungry ones.  That per-tweet loop is exact *water-filling*, implemented once
for every backend in :mod:`repro_torch.core.scaling.service` (sorted struct-of-arrays
in-flight set, payload columns, prefix completion handling).  This engine carries
(post time, sentiment) as the payload columns and is bit-identical to the paper's
loop, ~1000x faster -- what makes the 4.3M-tweet Spain trace x repeat-until-CI
feasible.

The Table III controller mechanics (60 s adaptation frequency, 60 s
provisioning delay, single-unit downscale cap, >= 1 unit floor) live in the
shared :class:`repro_torch.core.scaling.ScalingController`; the per-second sentiment
bins live in a :class:`repro_torch.core.scaling.SignalBus` channel.  The engine is
one :class:`~repro_torch.core.scaling.ScalableBackend` among several -- it only
simulates the processor-sharing service and feeds the control plane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.autoscaler.base import Policy

if TYPE_CHECKING:
    from repro_torch.core.convergence.converger import ConvergerConfig
    from repro_torch.core.convergence.faults import FaultSpec
from repro_torch.core.scaling import (
    ControllerConfig,
    RunReport,
    ScalingController,
    ServiceProcess,
    SignalBus,
    Sla,
    UnitPool,
)
from repro_torch.core.scaling.service import water_level as _water_level  # noqa: F401
from repro_torch.core.simulator.workload import CLASSES, Trace


@dataclass(frozen=True)
class SimConfig:
    """Table III defaults."""

    freq_hz: float = 2.0e9
    starting_units: int = 1
    step_s: float = 1.0
    sla_s: float = 300.0
    adapt_period_s: float = 60.0
    alloc_delay_s: float = 60.0
    max_units: int = 4096                 # safety valve, far above anything reached
    max_input_rate: float | None = None   # tweets/s admitted from the input queue
    queue_in_system: bool = False          # does n_in_system include the ingest queue?
                                           # (the Streams input queue sits upstream of
                                           # the application, so policies cannot see it)
    app_window_s: float = 120.0           # appdata window (§V-B: 120 s beats 60 s)
    drain: bool = True                    # keep simulating until all tweets finish
    pools: tuple[UnitPool, ...] | None = None   # typed capacity (None: one
                                                # on-demand pool from the knobs above)
    sla: Sla | None = None                # per-class deadlines (None: flat sla_s)
    convergence: bool = False             # desired-state reconciliation instead
                                          # of imperative deltas (fault-free:
                                          # bit-for-bit identical)
    converge: "ConvergerConfig | None" = None   # converger timeout/retry knobs
    faults: "tuple[FaultSpec, ...] | None" = None   # seeded fault injection
    audit_path: str | None = None         # mirror the audit log to JSONL


@dataclass
class SimResult(RunReport):
    """Simulator RunReport + the time series the benchmarks/figures need.

    Legacy accessors (``match``, ``delays``, ``cpu_seconds``, ...) map onto the
    shared RunReport schema so pre-redesign call sites keep working.
    """

    util_t: np.ndarray = field(                      # busy fraction per step
        default_factory=lambda: np.empty(0, np.float32))
    in_system_t: np.ndarray = field(                 # tweets in the system per step
        default_factory=lambda: np.empty(0, np.int64))

    @property
    def match(self) -> str:
        return self.workload

    @property
    def delays(self) -> np.ndarray:
        return self.latencies

    @property
    def cpu_seconds(self) -> float:
        return self.unit_seconds

    @property
    def cpu_hours(self) -> float:
        return self.unit_seconds / 3600.0

    @property
    def mean_delay(self) -> float:
        return self.mean_latency_s

    def summary(self) -> dict:
        out = super().summary()
        out.update({
            "match": self.match,
            "violation_pct": 100.0 * self.violation_rate,
            "cpu_hours": self.cpu_hours,
            "mean_delay_s": self.mean_delay,
        })
        return out


class Engine:
    """One simulation run of (trace x policy x config)."""

    def __init__(self, trace: Trace, policy: Policy, config: SimConfig | None = None):
        self.trace = trace
        self.policy = policy
        self.cfg = config or SimConfig()

    def run(self) -> SimResult:
        cfg = self.cfg
        tr = self.trace
        policy = self.policy

        step = cfg.step_s
        n_total = tr.n_tweets
        # Arrival bucketing: tweet i arrives at the step floor(post_time / step).
        arrive_step = (tr.post_time / step).astype(np.int64)
        duration_steps = int(tr.duration / step)

        # in-flight set: the shared water-filling core, carrying (post time,
        # sentiment, tweet class) payload columns through the sorted arrays
        proc = ServiceProcess({"post": np.float64, "sent": np.float32,
                               "cls": np.int8})

        # input queue (only used when max_input_rate caps admission)
        q_head = 0          # first not-yet-admitted tweet index (arrival order)
        n_arrived = 0

        # completed-tweet accounting
        delays = np.zeros(n_total, dtype=np.float64)
        done_cls = np.zeros(n_total, dtype=np.int8)   # class of the i-th completion
        n_done = 0
        # app-signal channel: per-second bins of completed tweets, by POST time
        # (§V-B: "it is not the time the tweet is done being processed that is used
        #  ... but the tweets post time").
        nbins = duration_steps + 2
        bus = SignalBus(("sentiment",), bin_s=step, horizon_bins=nbins)
        ctrl = ScalingController(
            policy,
            ControllerConfig(
                adapt_period_s=cfg.adapt_period_s,
                provision_delay_s=cfg.alloc_delay_s,
                max_units=cfg.max_units,
                step_s=step,
                app_window_s=cfg.app_window_s,
                signal_channel="sentiment",
                pools=cfg.pools,
                convergence=cfg.convergence,
                converge=cfg.converge,
                faults=cfg.faults,
                audit_path=cfg.audit_path,
            ),
            bus,
            starting_units=cfg.starting_units,
        )
        self.controller = ctrl      # post-run inspection (audit log, meters)

        units_hist: list[int] = []
        util_hist: list[float] = []
        insys_hist: list[int] = []

        t_step = 0
        max_steps = duration_steps + 200_000   # drain guard

        while True:
            now = t_step * step
            units = ctrl.on_step_start(now)

            # ---- admit new tweets -------------------------------------------------
            if t_step < duration_steps:
                hi = np.searchsorted(arrive_step, t_step, side="right")
                new_lo, new_hi = n_arrived, hi
                n_arrived = hi
            else:
                new_lo = new_hi = n_arrived
            # input-rate cap: admit from queue head up to max_input_rate * step
            if cfg.max_input_rate is None:
                adm_lo, adm_hi = new_lo, new_hi
                q_head = new_hi
            else:
                budget = int(cfg.max_input_rate * step)
                adm_lo = q_head
                adm_hi = min(n_arrived, q_head + budget)
                q_head = adm_hi
            k_new = adm_hi - adm_lo
            if k_new > 0:
                # zero-demand tweets (PE1 discards) complete instantly
                instant = proc.admit(tr.cycles[adm_lo:adm_hi],
                                     post=tr.post_time[adm_lo:adm_hi],
                                     sent=tr.sentiment[adm_lo:adm_hi],
                                     cls=tr.class_id[adm_lo:adm_hi])
                if instant is not None:
                    k0 = instant["post"].size
                    delays[n_done : n_done + k0] = (now + step) - instant["post"]
                    done_cls[n_done : n_done + k0] = instant["cls"]
                    n_done += k0
                    bus.record("sentiment", instant["post"], instant["sent"])

            L = len(proc)
            insys_hist.append(L + (n_arrived - q_head) if cfg.queue_in_system else L)

            # ---- distribute cycles (Algorithm 1, exact water-filling) ------------
            capacity = units * cfg.freq_hz * step
            sr = proc.step(capacity)
            if sr.n_finished > 0:
                fin_post = sr.finished["post"]
                delays[n_done : n_done + sr.n_finished] = (now + step) - fin_post
                done_cls[n_done : n_done + sr.n_finished] = sr.finished["cls"]
                n_done += sr.n_finished
                bus.record("sentiment", fin_post, sr.finished["sent"])
            util = sr.busy
            units_hist.append(units)
            util_hist.append(util)

            # ---- adapt (Table III mechanics live in the shared controller) --------
            ctrl.note_step(util, new_hi - new_lo)
            ctrl.maybe_adapt(time=now + step, n_in_system=insys_hist[-1])

            t_step += 1
            done_with_arrivals = t_step >= duration_steps and q_head >= n_total
            if done_with_arrivals and (len(proc) == 0 or not cfg.drain):
                break
            if t_step >= max_steps:
                raise RuntimeError(
                    f"simulation failed to drain after {max_steps} steps "
                    f"({len(proc)} tweets left, {units} units)"
                )

        units_arr = np.asarray(units_hist, dtype=np.int64)
        class_names = np.array([c.name for c in CLASSES])
        return SimResult(
            backend="simulator",
            workload=tr.match.name,
            policy=policy.describe(),
            sla_s=cfg.sla_s,
            latencies=delays[:n_done],
            unit_seconds=float(units_arr.sum() * step),
            units_t=units_arr,
            n_decisions_up=ctrl.n_up,
            n_decisions_down=ctrl.n_down,
            unit_name="cpu",
            decisions=ctrl.decision_log,
            sla=cfg.sla,
            classes=class_names[done_cls[:n_done]],
            util_t=np.asarray(util_hist, dtype=np.float32),
            in_system_t=np.asarray(insys_hist, dtype=np.int64),
            **ctrl.plan.report_kwargs(),
        )


def run_scenario(trace: Trace, policy: Policy, config: SimConfig | None = None) -> SimResult:
    return Engine(trace, policy, config).run()


def repeat_until_ci(
    make_policy,
    match: str,
    *,
    config: SimConfig | None = None,
    metric: str = "violation_rate",
    rel_ci: float = 0.10,
    min_reps: int = 3,
    max_reps: int = 8,
    seed0: int = 0,
):
    """Paper §V: 'repeated until the length of the confidence interval with 95%
    confidence was smaller than 10% of the mean'.  Returns (results, reps)."""
    from repro_torch.core.simulator.workload import generate_trace
    from repro_torch.utils.stats import mean_confidence_interval

    results: list[SimResult] = []
    vals: list[float] = []
    for rep in range(max_reps):
        tr = generate_trace(match, seed=seed0 + rep)
        res = run_scenario(tr, make_policy(), config)
        results.append(res)
        vals.append(getattr(res, metric))
        if rep + 1 >= min_reps:
            mean, ci = mean_confidence_interval(vals)
            if mean == 0.0 or ci < rel_ci * abs(mean):
                break
    return results, len(results)


__all__ = ["SimConfig", "SimResult", "Engine", "run_scenario", "repeat_until_ci"]
