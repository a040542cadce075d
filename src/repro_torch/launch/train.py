"""Fault-tolerant training driver.

Single entry point for real runs and for the CPU-scale examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 8 --seq 512                  # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --smoke --device cpu --steps 50 --batch 8 --seq 128

Counterpart of ``repro.launch.train``, with the same flags plus
``--device`` (``cuda`` by default, ``cpu`` on request).  Fault tolerance:

* a train-state checkpoint (parameters, AdamW ``m``/``v`` and ``step``, in
  the JAX package's format and keys) every ``--ckpt-every`` steps (async,
  atomic, rotating);
* on start, auto-resume from the newest complete checkpoint, which either
  package may have written;
* deterministic data: batch i depends only on (seed, i), so a restart
  replays the exact stream;
* ``--simulate-failure N`` kills the process at step N (exit 17); the
  outer supervisor loop (``--supervise``) restarts
  ``python -m repro_torch.launch.train``, proving end-to-end
  checkpoint/restart.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np


def train(args) -> int:
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches, donate=True)

    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    params = model.init_params(args.seed)
    opt_state = adamw_init(params)
    start_step = 0
    state_tmpl = {"params": params, "opt": opt_state}
    restored, meta = ckpt.restore_latest(state_tmpl, device=model.device)
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start_step = int(meta.get("step", 0))
        print(f"[train] resumed from step {start_step}", flush=True)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        if args.simulate_failure >= 0 and step == args.simulate_failure:
            print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
            os._exit(17)
        batch = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt:.1f}s)", flush=True)
        if step > start_step and step % args.ckpt_every == 0:
            ckpt.save({"params": params, "opt": opt_state}, step=step + 1)
    ckpt.save({"params": params, "opt": opt_state}, step=args.steps)
    ckpt.wait()
    if not losses:
        print(f"[train] done: nothing to run past step {start_step}", flush=True)
        return 0
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})", flush=True)
    return 0


def supervise(argv: list[str], max_restarts: int = 5) -> int:
    """Heartbeat supervisor: restart the training subprocess on failure."""
    for attempt in range(max_restarts + 1):
        child = [sys.executable, "-m", "repro_torch.launch.train"] + argv
        print(f"[supervisor] launch attempt {attempt}: {' '.join(child)}", flush=True)
        p = subprocess.run(child, env={**os.environ, "REPRO_SUPERVISED": "1"})
        if p.returncode == 0:
            print("[supervisor] run completed", flush=True)
            return 0
        print(f"[supervisor] child exited rc={p.returncode}; restarting "
              f"(node-failure recovery path)", flush=True)
        # after the first restart, stop injecting failures
        if "--simulate-failure" in argv:
            i = argv.index("--simulate-failure")
            argv = argv[:i] + argv[i + 2:]
    return 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions, for the smoke configs)")
    args, rest = ap.parse_known_args()

    if args.supervise and not os.environ.get("REPRO_SUPERVISED"):
        argv = [a for a in sys.argv[1:] if a != "--supervise"]
        sys.exit(supervise(argv))
    sys.exit(train(args))


if __name__ == "__main__":
    main()
