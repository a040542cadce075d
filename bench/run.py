"""One run of one cell of the benchmark of ``repro_torch``'s serving engine.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's model with weights
drawn from the seed on the card, warms the engine up at the cell's width,
drives one window of the cell's traffic through ``ServingEngine`` (with
``--trace 1`` also profiling a slice of it), checks a sample of the served
tokens against the plain reference and prints one JSON line: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  It exits non-zero, printing no result, without as many
CUDA devices as the cell asks for, or if JAX or the JAX package was
loaded.  Kernels build once into ``build/`` of the checkout.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "repro")
TRACE_SECONDS = 3.0        # the traced slice: the window's last seconds (a fifth at most)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reader(name: str):
    """``metrics/<name>.py``, or for a name with a suffix (``step_ms.open``)
    ``metrics/<name without it>.py``."""
    for stem in (name, name.rsplit(".", 1)[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"bench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH / 'metrics'}")


@dataclass
class Run:
    """What the readers see of one window."""

    shape: object              # bench.roofline.Shape
    setup_s: float
    close: float               # the window's length in seconds
    deadline: float            # the drain deadline, seconds after the window opened
    recs: list                 # driver.ReqRec of the window's requests
    window_steps: list         # driver.StepRec of the steps that started in it
    traced_steps: list         # ... of the traced slice
    spec0: dict
    spec1: dict
    kv_pages: int
    max_batch: int
    span: int
    page_size: int
    trace: object = None       # tracer.Summary


def _warm(eng, k: int, span: int) -> None:
    """Fill every slot, run steps at the window's cadence until drained:
    the shapes of every step of the window (the mixed step's width is
    fixed), the kernels loaded, the allocator's pool grown."""
    import numpy as np

    from repro_torch.serving.engine import Request
    for i in range(eng.cfg.max_batch):
        eng.submit(Request(rid=-1 - i, prompt=np.full(2 * span + 1, 7 + i, np.int32),
                           max_new_tokens=2 * span))
    while eng.queue or eng.active:
        eng.step(decode_steps=k)


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, control: bool = False,
             weights_seed: int | None = None) -> dict:
    """Everything of one run but the look for a card: the result's dict.
    ``control`` adds the float8 control's readings of the same sample, and
    ``weights_seed`` draws the weights from another seed than the traffic
    (both for ``bench.control``; the benchmark's runs use neither)."""
    import torch

    from bench import check, driver, roofline, traffic
    from bench.spec import model_config
    from bench.tracer import Tracer
    from bench.weights import make_params
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    wl = cell.workload
    cfg = model_config(cell.config)
    model = build_model(cfg, device=device)
    params = make_params(cfg, seed if weights_seed is None else weights_seed, device)
    eng = ServingEngine(model, params, ServeConfig(
        max_batch=wl["max_batch"], max_len=wl["max_len"], chunked_prefill=True,
        paged=True), device=device)
    k = eng.decode_steps if cell.loop == "offline" else 1
    _warm(eng, k, eng.span)
    tracer = None
    if trace:
        length = min(TRACE_SECONDS, seconds / 5)
        tracer = Tracer(seconds - length, length)
        tracer.warm(lambda: torch.ones(1, device=device).add_(1))
    arrivals = traffic.generate(cell.traffic, wl, cfg.vocab, seed, seconds)
    spec0 = dict(eng.speculation_stats)
    if cuda:
        torch.cuda.synchronize()
    win = driver.Window(eng, k=k, hook=tracer.hook if tracer else None)
    setup_s = time.perf_counter() - t_start
    if cell.loop == "offline":
        win.run_offline(arrivals, seconds)
    else:
        win.run_open(arrivals, seconds, float(wl["drain_s"]))
    if tracer is not None:
        tracer.finish()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_steps = [s for s in win.steps if s.t0 < win.close]
    traced = []
    if tracer is not None and tracer.summary is not None:
        on, off = tracer.t_on - win.origin, tracer.t_off - win.origin
        traced = [s for s in win.steps if s.t0 >= on and s.t1 <= off]
    if cell.loop == "offline":
        recs = [r for r in win.recs.values() if r.admit is not None]
        failed = 0
    else:
        recs = list(win.recs.values())
        failed = sum(r.done is None for r in recs)
    run = Run(shape=roofline.Shape.of(cell.config), setup_s=setup_s, close=win.close,
              deadline=win.deadline, recs=recs, window_steps=window_steps,
              traced_steps=traced, spec0=spec0, spec1=dict(eng.speculation_stats),
              kv_pages=eng.kv.num_pages - 1, max_batch=wl["max_batch"], span=eng.span,
              page_size=eng.kv.page_size,
              trace=tracer.summary if tracer is not None else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m.name)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    done = [r.req for r in recs if r.done is not None]
    # the program's state goes before the reference runs
    del eng, win, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = check.sample(done, seed, int(wl["sample_tokens"]))
    values = check.readings(params, cell.config, picked)
    ok, checks = check.judge(values, wl["limits"])
    result = {
        "correct": bool(ok and failed == 0),
        "attempted": len(recs),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    spec1 = run.spec1
    step_ms = sorted((s.t1 - s.t0) * 1e3 for s in window_steps) or [0.0]
    result["window"] = {
        "steps": len(window_steps), "iterations": sum(s.iters for s in window_steps),
        "emitted": sum(s.emitted for s in window_steps),
        "tokens_per_row_iteration": (spec1["emitted"] - spec0["emitted"])
        / max(spec1["live_iters"] - spec0["live_iters"], 1),
        "step_ms_p10_p50_p90_max": [step_ms[len(step_ms) // 10], step_ms[len(step_ms) // 2],
                                    step_ms[len(step_ms) * 9 // 10], step_ms[-1]]}
    result["sample"] = {"requests": len(picked),
                        "tokens": sum(len(q.output) for q in picked), "readings": values}
    if control:
        result["control"] = check.readings(params, cell.config, picked, control=True)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["USE_FLAX"] = "0"
    from bench.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench.run: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch finds {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"bench.run: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
