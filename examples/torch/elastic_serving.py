"""Elastic serving on the PyTorch port: a measured re-provisioning cost drives
the paper's policies.  The counterpart of ``examples/elastic_serving.py``.

Phase A (mechanism, real PyTorch): ``--world`` gloo ranks (processes on the
CPU, joined through a ``file://`` store) re-mesh smollm-360m's smoke config
over every rank at tensor-parallel degrees 1, 2 and 4, re-placing the live
parameters through ``repro_torch.core.elastic.remesh.measure_provision_delay``
(mesh rebuild + re-sharding + the first forward on the new mesh); the worst
transition is the measured provisioning delay.

Phase B (policy): ``provisioned_cluster_config`` puts that delay into an
elastic ``ClusterConfig``, and the threshold, target-tracking and
target-tracking + appdata policies drive the port's replica-fleet simulator
(``repro_torch.core.elastic.ElasticCluster``) over a seeded bursty request
stream whose answers' score rises ahead of each burst.

The JAX example's later phases run ``benchmarks/`` helpers (the replica-load
policy, typed spot capacity, the convergence drill); ``benchmarks/`` imports
the JAX package, so their port waits for the port's own benchmark (ROADMAP
item 1).

Run:  PYTHONPATH=src python examples/torch/elastic_serving.py [--world 4]
"""
import argparse
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.core.autoscaler import (AppDataPolicy, CompositePolicy, TargetTrackingPolicy,
                                         ThresholdPolicy)
from repro_torch.core.elastic import (ClusterConfig, ElasticCluster, ServeRequest,
                                      measure_provision_delay, provisioned_cluster_config)
from repro_torch.models import build_model


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One gloo rank of phase A: every rank re-meshes, rank 0 writes the
    seconds of each transition."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        model = build_model(get_smoke_config("smollm-360m"), device="cpu")
        params = model.init_params(0)
        rows = []
        for tp in (t for t in (1, 2, 4) if world % t == 0):
            dt, mesh, params = measure_provision_delay(
                model, params, devices=list(range(world)), model_parallel=tp)
            rows.append({"dp": world // tp, "tp": tp, "seconds": dt})
        if rank == 0:
            Path(out).write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()


def bursty_stream(seed: int = 0, n: int = 3000, horizon: float = 900.0) -> list:
    """Requests at a base rate with two bursts; the answers' score rises
    about a minute before each burst (the application-output signal)."""
    rng = np.random.default_rng(seed)
    bursts = (300.0, 650.0)
    t = np.arange(int(horizon))
    lam = np.ones(t.size)
    for b in bursts:
        lam *= 1.0 + 5.0 * np.where(t < b, np.exp(-((t - b) ** 2) / (2 * 25.0 ** 2)),
                                    np.exp(-(t - b) / 90.0))
    lam *= n / lam.sum()
    reqs = []
    for sec, rate in enumerate(lam):
        hot = any(b - 75.0 <= sec <= b + 60.0 for b in bursts)
        for _ in range(rng.poisson(rate)):
            reqs.append(ServeRequest(
                rid=len(reqs), arrival_s=sec + rng.random(),
                prefill_len=int(rng.exponential(3000)) + 256,
                decode_len=int(rng.exponential(100)) + 16,
                score=float(np.clip((0.92 if hot else 0.35) + rng.normal(0, 0.05), 0, 1))))
    return reqs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4, help="gloo ranks of phase A")
    args = ap.parse_args()

    print(f"=== Phase A: elastic re-mesh over {args.world} gloo ranks, measured ===")
    with tempfile.TemporaryDirectory(prefix="elastic-") as tmp:
        out = os.path.join(tmp, "delays.json")
        mp.spawn(rank_main, args=(args.world, os.path.join(tmp, "store"), out),
                 nprocs=args.world, join=True)
        rows = json.loads(Path(out).read_text())
    for r in rows:
        print(f"  re-meshed to dp={r['dp']} tp={r['tp']} ({args.world} ranks) in "
              f"{r['seconds']:.2f}s  (provisioning-delay analogue)")
    measured = max(r["seconds"] for r in rows)      # the worst transition
    print(f"  measured provision delay: {measured:.2f}s "
          f"(feeds ClusterConfig.provision_delay_s)")

    print("\n=== Phase B: the fleet under the policies (measured delay) ===")
    cfg = provisioned_cluster_config(ClusterConfig(), measured)
    for name, policy in [
            ("threshold60", ThresholdPolicy(0.6)),
            ("target75", TargetTrackingPolicy(target=0.75)),
            ("target75+appdata", CompositePolicy([TargetTrackingPolicy(target=0.75),
                                                  AppDataPolicy(extra_units=4, jump=0.5)]))]:
        rep = ElasticCluster(cfg, policy, bursty_stream()).run()
        print(f"  {name:17s} viol {100 * rep.violation_rate:5.2f}%  "
              f"chip-h {rep['chip_hours']:6.2f}  p99 {rep.p99_latency_s:6.1f}s  "
              f"max replicas {rep.max_units}")
    print("  (the JAX example's typed-capacity and convergence phases use "
          "benchmarks/ helpers: ROADMAP item 1)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
