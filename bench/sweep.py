"""The knee of a mix on the card: the highest steady rate the engine
sustains without a growing queue.

    python3 -m bench.sweep --workload <cell> --rates 4,6,8 --seconds 20 --seed <n>

One process builds the cell's model once; each rate gets a fresh engine,
a warm-up and one open-loop window of the cell's mix at that rate (a burst
mix offered at a steady rate), and prints one JSON line: the requests sent
and finished in the window, the queue's length in each quarter of it,
and the medians and 95th percentiles of the time to first token and of
the wait for a slot.  A rate is sustained where the queue in the last
quarter is no longer than in the first, or than what two steps' arrivals
make it (rate x step time x 2): the queue is read before each step, and
an engine that keeps up still has the requests that came due during the
step in flight waiting for the next one to admit them.  The cell's rate is
written into its workload file from this, by hand, once.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np

from bench.run import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench import driver, traffic
    from bench.run import _warm
    from bench.spec import load_cell, model_config
    from bench.weights import make_params
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    if not torch.cuda.is_available():
        print("bench.sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    wl = cell.workload
    cfg = model_config(cell.config)
    model = build_model(cfg, device="cuda")
    params = make_params(cfg, args.seed, "cuda")
    steady = dict(cell.traffic, arrivals={"kind": "poisson"})
    for rate in (float(r) for r in args.rates.split(",")):
        eng = ServingEngine(model, params, ServeConfig(
            max_batch=wl["max_batch"], max_len=wl["max_len"], chunked_prefill=True,
            paged=True), device="cuda")
        _warm(eng, 1, eng.span)
        arrivals = traffic.generate(steady, dict(wl, rate_per_s=rate), cfg.vocab,
                                    args.seed, args.seconds)
        queue = []
        win = driver.Window(eng, k=1, hook=lambda now, e=eng: queue.append((now, len(e.queue))))
        win.run_open(arrivals, args.seconds, 0.0)
        recs = list(win.recs.values())
        ttft = [r.first - r.due for r in recs if r.first is not None]
        wait = [r.admit - r.due for r in recs if r.admit is not None]
        quarters = []
        for q in range(4):
            lo, hi = q * args.seconds / 4, (q + 1) * args.seconds / 4
            vals = [n for t, n in queue if lo <= t < hi]
            quarters.append(float(np.mean(vals)) if vals else 0.0)
        steps = [s for s in win.steps if s.t0 < args.seconds]
        last = [s.t1 - s.t0 for s in steps if s.t0 >= 0.75 * args.seconds]
        in_flight = 2 * rate * float(np.mean(last)) if last else 0.0
        print(json.dumps({
            "workload": cell.name, "rate_per_s": rate, "sent": len(recs),
            "finished": sum(r.done is not None for r in recs),
            "first_tokens": len(ttft), "queue_by_quarter": quarters,
            "in_flight": in_flight,
            "sustained": quarters[3] <= max(quarters[0], 1.0, in_flight),
            "ttft_p50_ms": float(np.median(ttft)) * 1e3 if ttft else None,
            "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3 if ttft else None,
            "wait_p50_ms": float(np.median(wait)) * 1e3 if wait else None,
            "wait_p95_ms": float(np.percentile(wait, 95)) * 1e3 if wait else None,
            "step_ms": float(np.mean([s.t1 - s.t0 for s in steps])) * 1e3 if steps else None,
            "rows_per_step": float(np.mean([s.served for s in steps])) if steps else None,
        }), flush=True)
        del eng, win
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
