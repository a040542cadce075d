"""Quickstart on the PyTorch port: the paper's experiment, then the LLM
substrate on the card.  The counterpart of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]

Part 1 runs the paper's three policies on the ``uruguay`` match trace through
the port's copy of the simulator; part 2 trains smollm-135m's smoke config
for 20 steps; part 3 serves 6 requests through the continuous-batching
engine.  ``--device`` defaults to ``cuda``: there the engine's attention,
lm-head and sampling run the hand-written CUDA kernels, and training the
plain route (as the JAX package trains with its kernels off).  ``--device
cpu`` runs every kernel's plain version.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.autoscaler import AppDataPolicy, CompositePolicy, LoadPolicy, ThresholdPolicy
from repro_torch.core.simulator import SimConfig, generate_trace, run_scenario
from repro_torch.core.simulator.distributions import ServiceModel
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.training import make_train_step

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
t0 = time.perf_counter()

# ---- 1. the paper: application-data auto-scaling on a match trace ---------------
trace = generate_trace("uruguay", seed=0)
sm = ServiceModel()
for policy in [
    ThresholdPolicy(0.6),
    LoadPolicy(sm, quantile=0.99999),
    CompositePolicy([LoadPolicy(sm, quantile=0.99999), AppDataPolicy(extra_units=5)]),
]:
    res = run_scenario(trace, policy, SimConfig())
    print(f"{res.policy:35s} violations {100 * res.violation_rate:6.2f}%  "
          f"cost {res.cpu_hours:6.2f} CPU-h")

# ---- 2. the substrate: train a small LM for a few steps -------------------------
cfg = get_smoke_config("smollm-135m")
model = build_model(cfg, device=args.device)
params = model.init_params(0)
opt = adamw_init(params)
step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=20), donate=True)
data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
losses = []
for i in range(20):
    batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
    params, opt, m = step(params, opt, batch)
    losses.append(float(m["loss"]))
    if i % 5 == 0 or i == 19:
        print(f"step {i:3d}  loss {losses[-1]:.4f}")
if not np.isfinite(losses).all():
    raise SystemExit(f"a loss is not finite: {losses}")

# ---- 3. serve it with continuous batching ----------------------------------------
eng = ServingEngine(model, params, ServeConfig(max_batch=4, max_len=96), device=args.device)
rng = np.random.default_rng(0)
for i in range(6):
    eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                       max_new_tokens=4))
eng.run_until_drained()
if len(eng.completed) != 6 or any(len(r.output) != 4 for r in eng.completed):
    raise SystemExit(f"served {len(eng.completed)} of 6 requests")
print(f"served {len(eng.completed)} requests in {eng.step_count} engine steps "
      f"on {model.device} ({time.perf_counter() - t0:.1f} s in all)")
