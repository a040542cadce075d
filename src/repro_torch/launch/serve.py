"""Serving driver: the continuous-batching engine under a bursty request
stream, with SLA accounting, straggler mitigation, and the scaling control
plane driving decode-slot elasticity.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --policy appdata --device cuda

``--arch mamba2-1.3b`` serves the ssm family through the engine's
dense-cache fallback (its prefill runs the SSD intra-chunk kernel).
``--replicas N`` (N > 1) serves through the replica fleet
(:mod:`repro_torch.serving.fleet`): one replica spawned from a checkpoint
at start, up to N under the policy, each spawn's wall time measured.

Counterpart of ``repro.launch.serve``.  :class:`ServeBackend` is a scalable
backend over the *live* :class:`~repro_torch.serving.ServingEngine`: the
unit of elasticity is a decode slot, and the ``output_score`` SignalBus
channel carries each request's application-output signal -- the
engine-computed running mean logprob of the tokens actually generated.
Any registered policy can manage the slot pool.  The engine (every
replica, in fleet mode) runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core.scaling import (
    ControllerConfig,
    RunReport,
    ScalingController,
    SignalBus,
    make_policy,
)


class DrainTimeout(RuntimeError):
    """The virtual-time loop ran far past the horizon without draining."""


class ServeBackend:
    """ScalableBackend over a live ServingEngine (unit = decode slot).

    ``pools`` types the slot capacity (e.g. an on-demand pool plus a cheap
    preemptible one whose slots model borrowed capacity that can be revoked);
    ``sla`` adds per-request-class deadlines.  Both default to the legacy
    single-pool / flat-SLA configuration.
    """

    def __init__(self, eng, requests, *, sla_s: float, horizon_s: float,
                 policy=None, adapt_period_s: float = 5.0,
                 provision_delay_s: float = 3.0, app_window_s: float = 10.0,
                 starting_slots: int = 1, stall_steps: float = 50.0,
                 pools=None, sla=None, decode_steps: int = 1,
                 convergence: bool = False, faults=None, audit_path=None):
        self.eng = eng
        # tokens each slot advances per virtual second (one K-step device
        # loop per step); 1 keeps the classic one-token-per-second clock
        self.decode_steps = max(int(decode_steps), 1)
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        self.sla_s = sla_s
        self.sla = sla
        self.horizon_s = horizon_s
        self.stall_steps = stall_steps
        self.evictions = 0
        if policy is None:
            policy = make_policy("target")   # same default as the CLI path
        self.controller = ScalingController(
            policy,
            ControllerConfig(
                adapt_period_s=adapt_period_s,
                provision_delay_s=provision_delay_s,
                min_units=1,
                max_units=eng.cfg.max_batch,
                step_s=1.0,
                app_window_s=app_window_s,
                signal_channel="output_score",
                pools=pools,
                convergence=convergence,
                faults=faults,
                audit_path=audit_path,
            ),
            SignalBus(("output_score",), bin_s=1.0),
            starting_units=starting_slots,
        )

    def run(self) -> RunReport:
        eng, ctrl = self.eng, self.controller
        bus = ctrl.bus
        t = 0.0
        head = 0
        n_reported = 0                      # completed requests already on the bus
        last_progress: dict[int, tuple[int, float]] = {}
        units_hist: list[int] = []

        while head < len(self.requests) or eng.n_in_system:
            units = ctrl.on_step_start(t)
            eng.slot_limit = units
            new_arr = 0
            while head < len(self.requests) and self.requests[head].arrival_s <= t:
                eng.submit(self.requests[head])
                head += 1
                new_arr += 1
            served = eng.step(now=t, decode_steps=self.decode_steps)
                                       # slots that advanced, incl. ones that
                                       # finished this step (active is already
                                       # drained of them by now)
            # straggler mitigation: evict slots that stopped producing tokens
            for slot, req in list(eng.active.items()):
                n_out = len(req.output)
                if last_progress.get(req.rid, (-1, t))[0] == n_out:
                    if t - last_progress[req.rid][1] > self.stall_steps:
                        eng.evict(slot)          # backup dispatch
                        self.evictions += 1
                        last_progress.pop(req.rid)
                else:
                    last_progress[req.rid] = (n_out, t)
            # application-output signal (engine-computed mean decode logprob),
            # indexed by request arrival time (§V-B)
            fresh = eng.completed[n_reported:]
            if fresh:
                bus.record("output_score",
                           np.array([r.arrival_s for r in fresh]),
                           np.array([r.score for r in fresh]))
                for r in fresh:
                    last_progress.pop(r.rid, None)
                n_reported = len(eng.completed)
            units_hist.append(units)
            # served can exceed units right after a scale-in (old slots drain
            # out); clamp so utilization keeps its busy-fraction contract
            ctrl.note_step(min(1.0, served / max(units, 1)), new_arr)
            ctrl.maybe_adapt(time=t + 1.0, n_in_system=eng.n_in_system)
            t += 1.0
            if t > self.horizon_s + 10_000:
                raise DrainTimeout("serve backend failed to drain")

        units_arr = np.asarray(units_hist, dtype=np.int64)
        lat = np.array([r.done_s - r.arrival_s for r in eng.completed])
        classes = np.array(
            [f"p{r.request_class[0]}d{r.request_class[1]}" for r in eng.completed])
        return RunReport(
            backend="serve",
            workload=f"{len(self.requests)} requests",
            policy=ctrl.policy.describe(),
            sla_s=self.sla_s,
            latencies=lat,
            unit_seconds=float(units_arr.sum()),
            units_t=units_arr,
            n_decisions_up=ctrl.n_up,
            n_decisions_down=ctrl.n_down,
            unit_name="slot",
            decisions=ctrl.decision_log,
            sla=self.sla,
            classes=classes,
            extra={"evictions": self.evictions, "engine_steps": eng.step_count,
                   "prefill_occupancy": eng.prefill_occupancy},
            **ctrl.plan.report_kwargs(),
        )


def serve(args) -> int:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.scaling import available_policies
    from repro_torch.data import request_stream
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    # policies whose observation tiers are meaningful for the slot backend:
    # 'load' prices work in tweet-trace CPU cycles and 'scheduled' needs a
    # schedule, neither of which the CLI can supply
    supported = ("appdata", "target", "threshold")
    if args.policy:
        if args.policy not in available_policies():
            print(f"[serve] unknown policy {args.policy!r}; registered: "
                  f"{', '.join(available_policies())}", file=sys.stderr)
            return 2
        if args.policy not in supported:
            print(f"[serve] policy {args.policy!r} is not usable on the slot "
                  f"backend from the CLI; supported: {', '.join(supported)}",
                  file=sys.stderr)
            return 2
    policy = make_policy(args.policy) if args.policy else None

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init_params(args.seed)
    serve_cfg = ServeConfig(max_batch=args.batch, max_len=args.max_len,
                            page_size=args.page_size,
                            decode_steps=args.decode_steps,
                            chunked_prefill=not args.bucketed)

    stream = request_stream(n_requests=args.requests, seed=args.seed,
                            mean_prompt=args.mean_prompt,
                            mean_decode=args.mean_decode,
                            burst_times=(args.horizon * 0.5,),
                            horizon_s=args.horizon)
    reqs = []
    for i, (t, p, d) in enumerate(stream):
        # Request.score is left at its default: the ENGINE fills it with the
        # running mean logprob of the tokens it generates
        reqs.append(Request(
            rid=i, arrival_s=t,
            prompt=np.random.default_rng(i).integers(
                0, cfg.vocab, min(p, args.max_len // 2)).astype(np.int32),
            max_new_tokens=max(min(d, args.max_len // 4), 1)))

    if args.replicas > 1:
        return serve_fleet(args, model, params, serve_cfg, reqs, policy)

    eng = ServingEngine(model, params, serve_cfg, device=model.device)
    backend = ServeBackend(eng, reqs, sla_s=args.sla, horizon_s=args.horizon,
                           policy=policy, stall_steps=args.stall_steps,
                           decode_steps=args.decode_steps,
                           convergence=args.convergence,
                           audit_path=args.audit_path)
    t0 = time.time()
    try:
        rep = backend.run()
    except DrainTimeout:
        print("[serve] failed to drain", file=sys.stderr)
        return 1

    print(f"[serve] completed {rep.n_done}/{len(reqs)} requests in "
          f"{eng.step_count} steps ({time.time() - t0:.1f}s wall) "
          f"under {rep.policy} on {model.device}")
    print(f"[serve] latency mean {rep.mean_latency_s:.1f} "
          f"p99 {rep.p99_latency_s:.1f} (virtual s); "
          f"SLA({args.sla}s) violations {100 * rep.violation_rate:.2f}%; "
          f"slots peak {rep.max_units}/{args.batch}; "
          f"stragglers evicted {backend.evictions} "
          f"(page size {eng.kv.page_size if eng.paged else '-'}, "
          f"prefill occupancy {eng.prefill_occupancy:.2f})")
    return 0


def serve_fleet(args, model, params, serve_cfg, reqs, policy) -> int:
    """Fleet mode: the unit of elasticity is a whole ENGINE, spawned from a
    checkpoint with a measured provisioning delay and drained with
    in-flight migration (see :mod:`repro_torch.serving.fleet`)."""
    import os
    import tempfile

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.serving.fleet import FLEET_POOL, FleetBackend, ReplicaPool

    if not serve_cfg.chunked_prefill:
        print("[serve] --replicas needs the mixed step: migration requires the "
              "chunked paged engine (drop --bucketed)", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="fleet-ckpt-") as ckpt_dir:
        ckpt = save_checkpoint(os.path.join(ckpt_dir, "ckpt_00000001.npz"),
                               params, step=0)
        pool = ReplicaPool(model, ckpt, serve_cfg)
        backend = FleetBackend(pool, reqs, sla_s=args.sla,
                               horizon_s=args.horizon, policy=policy,
                               starting_replicas=1,
                               max_replicas=args.replicas,
                               decode_steps=args.decode_steps,
                               audit_path=args.audit_path)
        t0 = time.time()
        rep = backend.run()
    measured = rep.pool_provision_delay_s.get(FLEET_POOL, 0.0)
    print(f"[serve] fleet completed {rep.n_done}/{len(reqs)} requests "
          f"({time.time() - t0:.1f}s wall) under {rep.policy} on {model.device}")
    print(f"[serve] latency mean {rep.mean_latency_s:.1f} "
          f"p99 {rep.p99_latency_s:.1f} (virtual s); "
          f"SLA({args.sla}s) violations {100 * rep.violation_rate:.2f}%; "
          f"replicas peak {rep.max_units}/{args.replicas}; "
          f"measured provisioning delay {measured:.3f}s")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default 'cuda' needs a GPU")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--mean-prompt", type=int, default=16)
    ap.add_argument("--mean-decode", type=int, default=8)
    ap.add_argument("--horizon", type=float, default=60.0)
    ap.add_argument("--sla", type=float, default=20.0)
    ap.add_argument("--stall-steps", type=float, default=50.0)
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: per device, see "
                         "repro_torch.kernels.decode_attention.autotune)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="ceiling on serving-engine replicas; > 1 switches to "
                         "fleet mode (repro_torch.serving.fleet): starts at one "
                         "replica spawned from a checkpoint and lets the "
                         "convergence plane scale the fleet, with measured "
                         "provisioning delays and drain-migration")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="tokens each slot advances per virtual second (one "
                         "K-step device loop per engine step)")
    ap.add_argument("--bucketed", action="store_true",
                    help="batched bucketed prefill + K-step decode "
                         "(ServeConfig(chunked_prefill=False)) instead of the "
                         "mixed chunked-prefill / speculative step")
    ap.add_argument("--convergence", action="store_true",
                    help="drive slot capacity through the convergence control "
                         "plane (desired-state reconciliation) instead of "
                         "imperative deltas")
    ap.add_argument("--audit-path", default=None,
                    help="mirror the convergence audit log to this JSONL file")
    ap.add_argument("--policy", default=None,
                    help="registered policy name (default: the backend's "
                         "target-tracking rule; see repro_torch.core.scaling)")
    ap.add_argument("--seed", type=int, default=0)
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
