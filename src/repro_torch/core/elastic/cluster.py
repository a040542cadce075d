"""Elastic LLM-serving cluster driven by the paper's auto-scaling policies.

This is the paper's resource-management insight transplanted to TPU serving:

* unit of elasticity = a model REPLICA (a DP slice of the pod) -- TPU meshes
  are torus-wired, so capacity moves in whole replicas, not single chips;
* per-request service demand comes from a-priori request CLASSES
  (prefill_len, decode_len buckets) priced by the roofline step-times of the
  compiled dry-run (the LLM analogue of the paper's per-class Weibulls);
* the `load` policy estimates the drain time of everything in the system from
  a quantile of the class mixture, exactly as in the paper;
* the `appdata` policy watches a signal computed from the application's own
  OUTPUT stream (e.g. windowed mean score of generated answers: a burst of
  "breaking-news-shaped" queries shifts the output distribution minutes before
  the request-rate peak) and pre-provisions replicas;
* provisioning delay = checkpoint restore + re-mesh + recompile, and scale-in
  releases one replica at a time (Table III semantics retained).

The cluster itself is a discrete-time simulation (1 s steps) whose per-replica
throughput is derived from the dry-run roofline numbers, so policy behaviour
is faithful to what the real fleet would do; the *mechanism* (mesh rebuild +
parameter resharding) is real JAX, exercised by `remesh.py` + tests.

Table III mechanics and window accounting are delegated to the shared
:class:`repro_torch.core.scaling.ScalingController`/:class:`SignalBus` control
plane, and the service process itself is the shared exact water-filling core
(:class:`repro_torch.core.scaling.ServiceProcess`) -- the same Algorithm 1
machinery the tweet simulator runs on, so policy comparisons across backends
sit on an identical service model.  Admission is slot-capped from an
index-head queue (O(1) per admit, 100k+-request streams are cheap) and the
reported busy fraction is derived from work actually *consumed*
(``min(demand, capacity) / capacity``), not from pre-step demand.  The
primary signal channel is ``output_score`` (windowed mean score of generated
answers); requests may carry additional named channels in ``signals`` (e.g. a
refusal-rate or topic-shift stream), all observable by policies via
``Observation.signal(channel)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.autoscaler.base import Policy

if TYPE_CHECKING:
    from repro_torch.core.convergence.converger import ConvergerConfig
    from repro_torch.core.convergence.faults import FaultSpec
    from repro_torch.core.convergence.groups import ScalingGroup
from repro_torch.core.scaling import (
    ControllerConfig,
    RunReport,
    ScalingController,
    ServiceProcess,
    SignalBus,
    Sla,
    UnitPool,
)


@dataclass(frozen=True)
class ReplicaSpec:
    """Capacity model of one serving replica, priced from the dry-run."""

    chips: int = 16
    prefill_tokens_per_s: float = 250_000.0   # roofline-derived
    decode_tokens_per_s: float = 20_000.0     # batched decode, all slots
    max_slots: int = 64


@dataclass
class ServeRequest:
    rid: int
    arrival_s: float
    prefill_len: int
    decode_len: int
    score: float = 0.5            # application-output signal carried by the reply
    done_s: float | None = None
    signals: dict[str, float] = field(default_factory=dict)   # extra named channels
    request_class: str = "standard"   # SLA class (per-class deadlines via Sla)

    def work_prefill(self) -> float:
        return float(self.prefill_len)

    def work_decode(self) -> float:
        return float(self.decode_len)


@dataclass(frozen=True)
class ClusterConfig:
    replica: ReplicaSpec = ReplicaSpec()
    sla_s: float = 30.0                      # request completion SLA
    adapt_period_s: float = 15.0
    provision_delay_s: float = 45.0          # restore + remesh + warmup
    starting_replicas: int = 1
    max_replicas: int = 64
    app_window_s: float = 60.0
    step_s: float = 1.0
    signal_channel: str = "output_score"     # primary channel (legacy app_* tier)
    pools: tuple[UnitPool, ...] | None = None   # typed replica pools (None: one
                                                # on-demand pool from the knobs above)
    sla: Sla | None = None                   # per-class deadlines (None: flat sla_s)
    convergence: bool = False                # desired-state reconciliation
                                             # (fault-free: bit-for-bit identical)
    converge: "ConvergerConfig | None" = None    # converger timeout/retry knobs
    faults: "tuple[FaultSpec, ...] | None" = None   # seeded fault injection or
                                                    # a duck-typed injector
    group: "ScalingGroup | None" = None      # scaling-group pools + scheduled
                                             # and webhook desired-state floors
    audit_path: str | None = None            # mirror the audit log to JSONL


class _ClassModel:
    """A-priori (prefill+decode cost) distribution over request classes --
    the `load` policy's quantile service model.

    The sorted sample array is cached between adapt ticks (quantiles are read
    every tick, samples only change on observe), so `quantile_seconds` is an
    O(1) interpolation instead of an O(n log n) re-sort of up to 50k samples.
    """

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self._samples: list[float] = []
        self._sorted: np.ndarray | None = None   # invalidated on observe

    def _trim(self):
        # a bulk observe can overshoot by more than 2x: keep halving (drop
        # oldest first) until the retained set is back under the cap
        while len(self._samples) > 50_000:
            del self._samples[: len(self._samples) // 2]
        self._sorted = None

    def observe(self, req: ServeRequest):
        self._samples.append(self.seconds_of(req))
        self._trim()

    def observe_seconds(self, seconds: np.ndarray):
        """Vectorized observe of pre-priced service times."""
        self._samples.extend(np.asarray(seconds, dtype=np.float64).tolist())
        self._trim()

    def seconds_of(self, req: ServeRequest) -> float:
        s = self.spec
        return req.work_prefill() / s.prefill_tokens_per_s \
            + req.work_decode() / (s.decode_tokens_per_s / s.max_slots)

    def price(self, prefill_len: np.ndarray, decode_len: np.ndarray) -> np.ndarray:
        """Vectorized `seconds_of` over per-request length arrays."""
        s = self.spec
        return (np.asarray(prefill_len, np.float64) / s.prefill_tokens_per_s
                + np.asarray(decode_len, np.float64)
                / (s.decode_tokens_per_s / s.max_slots))

    def quantile_seconds(self, q: float) -> float:
        if not self._samples:
            return 1.0
        if self._sorted is None:
            self._sorted = np.sort(np.asarray(self._samples, dtype=np.float64))
        s = self._sorted
        # linear interpolation at rank q * (n - 1): matches np.quantile's
        # default method on the same samples
        pos = q * (s.size - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, s.size - 1)
        return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))

    def mean_seconds(self) -> float:
        if not self._samples:
            return 1.0
        return float(np.mean(self._samples))


@dataclass
class ElasticResult(RunReport):
    """Elastic RunReport + the per-step service-process series the
    conservation tests and utilization figures need (not part of the summary
    row schema)."""

    util_t: np.ndarray = field(                      # consumed/capacity per step
        default_factory=lambda: np.empty(0, np.float32))
    demand_t: np.ndarray = field(                    # pre-step demand, replica-s
        default_factory=lambda: np.empty(0, np.float64))
    consumed_t: np.ndarray = field(                  # work consumed, replica-s
        default_factory=lambda: np.empty(0, np.float64))
    capacity_t: np.ndarray = field(                  # usable capacity, replica-s
        default_factory=lambda: np.empty(0, np.float64))
    in_system_t: np.ndarray = field(                 # queue + in-flight per step
        default_factory=lambda: np.empty(0, np.int64))


class ElasticCluster:
    """Discrete-time elastic serving fleet under a Policy (threshold / load /
    appdata composite from `repro_torch.core.autoscaler`)."""

    def __init__(self, cfg: ClusterConfig, policy: Policy,
                 requests: list[ServeRequest], *, on_step=None):
        self.cfg = cfg
        self.policy = policy
        # chaos-drill hook: called as on_step(cluster, t) right after capacity
        # convergence each step (kill timing, mid-incident webhook fires)
        self.on_step = on_step
        self.incoming = sorted(requests, key=lambda r: r.arrival_s)
        n = len(self.incoming)
        # struct-of-arrays view of the request stream (vectorized service core)
        self._arrival = np.array([r.arrival_s for r in self.incoming],
                                 dtype=np.float64)
        self._score = np.array([r.score for r in self.incoming],
                               dtype=np.float64)
        self._cls = np.array([r.request_class for r in self.incoming])
        self.class_model = _ClassModel(cfg.replica)
        self._work = self.class_model.price(
            np.array([r.prefill_len for r in self.incoming], dtype=np.float64),
            np.array([r.decode_len for r in self.incoming], dtype=np.float64))
        # extra named channels as dense columns (NaN where a request doesn't
        # carry the channel)
        self._extra: dict[str, np.ndarray] = {}
        for i, r in enumerate(self.incoming):
            for name, val in r.signals.items():
                self._extra.setdefault(name, np.full(n, np.nan))[i] = val
        self.class_model.observe_seconds(self._work)   # a-priori knowledge

    # -- the load policy's expected-drain estimator --------------------------------
    def expected_delay(self, n_in_system: int, replicas: int, q: float) -> float:
        if replicas <= 0:
            return math.inf
        per = self.class_model.quantile_seconds(q)
        return n_in_system * per / replicas

    def run(self) -> RunReport:
        cfg = self.cfg
        bus = SignalBus((cfg.signal_channel,), bin_s=cfg.step_s)
        ctrl = ScalingController(
            self.policy,
            ControllerConfig(
                adapt_period_s=cfg.adapt_period_s,
                provision_delay_s=cfg.provision_delay_s,
                max_units=cfg.max_replicas,
                step_s=cfg.step_s,
                app_window_s=cfg.app_window_s,
                signal_channel=cfg.signal_channel,
                pools=cfg.pools,
                convergence=cfg.convergence,
                converge=cfg.converge,
                faults=cfg.faults,
                group=cfg.group,
                audit_path=cfg.audit_path,
            ),
            bus,
            starting_units=cfg.starting_replicas,
        )
        self.controller = ctrl      # post-run inspection (audit log, meters)
        n = len(self.incoming)
        arrival, work, score = self._arrival, self._work, self._score

        # shared water-filling service core; the sorted in-flight arrays carry
        # the request index plus (arrival, score) payload columns
        proc = ServiceProcess({"idx": np.int64,
                               "arrival": np.float64,
                               "score": np.float64})
        t = 0.0
        n_arrived = 0     # requests with arrival_s <= t (entered the system)
        q_head = 0        # index-head queue: next request not yet in a slot
        done_t = np.zeros(n, dtype=np.float64)
        replica_seconds = 0.0
        hist_replicas: list[int] = []
        util_hist: list[float] = []
        demand_hist: list[float] = []
        consumed_hist: list[float] = []
        capacity_hist: list[float] = []
        insys_hist: list[int] = []

        horizon = float(arrival[-1]) + 1.0 if n else 1.0
        while True:
            replicas = ctrl.on_step_start(t)
            if self.on_step is not None:
                self.on_step(self, t)
                replicas = ctrl.plan.total_live   # the hook may move capacity
            # arrivals (arrival-sorted, so the queue is the contiguous index
            # range [q_head, n_arrived))
            hi = int(np.searchsorted(arrival, t, side="right"))
            new_arr = hi - n_arrived
            n_arrived = hi
            # slot-capped admission from the queue head, FIFO
            capacity_slots = replicas * cfg.replica.max_slots
            k_adm = min(max(capacity_slots - len(proc), 0), n_arrived - q_head)
            instant = None
            if k_adm > 0:
                idx = np.arange(q_head, q_head + k_adm, dtype=np.int64)
                instant = proc.admit(work[idx], idx=idx,
                                     arrival=arrival[idx], score=score[idx])
                q_head += k_adm
            # serve: exact water-filling of replica-seconds across in-flight
            capacity = replicas * cfg.step_s
            sr = proc.step(capacity)
            fin_idx = sr.finished["idx"]
            fin_arr = sr.finished["arrival"]
            fin_score = sr.finished["score"]
            if instant is not None:       # zero-work requests finish instantly
                fin_idx = np.concatenate([instant["idx"], fin_idx])
                fin_arr = np.concatenate([instant["arrival"], fin_arr])
                fin_score = np.concatenate([instant["score"], fin_score])
            if fin_idx.size:
                done_t[fin_idx] = t + cfg.step_s
                # signals indexed by ARRIVAL time (§V-B post-time indexing)
                bus.record(cfg.signal_channel, fin_arr, fin_score)
                for name, col in self._extra.items():
                    vals = col[fin_idx]
                    carried = ~np.isnan(vals)
                    if carried.any():
                        bus.record(name, fin_arr[carried], vals[carried])
            replica_seconds += replicas * cfg.step_s
            hist_replicas.append(replicas)
            util_hist.append(sr.busy)
            demand_hist.append(sr.demand)
            consumed_hist.append(sr.consumed)
            capacity_hist.append(capacity)
            insys_hist.append((n_arrived - q_head) + len(proc))

            ctrl.note_step(sr.busy, new_arr)
            ctrl.maybe_adapt(time=t, n_in_system=insys_hist[-1])

            t += cfg.step_s
            if t > horizon and len(proc) == 0 and q_head >= n:
                break
            if t > horizon + 48 * 3600:
                raise RuntimeError("cluster failed to drain")

        if ctrl.audit is not None:       # terminal marker: the run completed
            ctrl.audit.seal(t)
            ctrl.audit.close()
        for i, r in enumerate(self.incoming):     # keep the request-object API
            r.done_s = float(done_t[i]) if done_t[i] > 0.0 else None
        done_mask = done_t > 0.0
        lat = (done_t - arrival)[done_mask]
        return ElasticResult(
            backend="elastic",
            workload=f"{n} requests",
            policy=self.policy.describe(),
            sla_s=cfg.sla_s,
            latencies=lat,
            unit_seconds=replica_seconds,
            units_t=np.asarray(hist_replicas, dtype=np.int64),
            n_decisions_up=ctrl.n_up,
            n_decisions_down=ctrl.n_down,
            unit_name="replica",
            decisions=ctrl.decision_log,
            sla=cfg.sla,
            classes=self._cls[done_mask],
            extra={"chip_hours": replica_seconds * cfg.replica.chips / 3600.0},
            **ctrl.plan.report_kwargs(),
            util_t=np.asarray(util_hist, dtype=np.float32),
            demand_t=np.asarray(demand_hist, dtype=np.float64),
            consumed_t=np.asarray(consumed_hist, dtype=np.float64),
            capacity_t=np.asarray(capacity_hist, dtype=np.float64),
            in_system_t=np.asarray(insys_hist, dtype=np.int64),
        )


__all__ = ["ClusterConfig", "ElasticCluster", "ElasticResult", "ReplicaSpec",
           "ServeRequest"]
