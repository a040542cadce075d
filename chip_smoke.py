#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build both hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
3. hold each kernel against its plain PyTorch version at the serving
   shapes of smollm-135m, and time the kernel, the plain version and a
   PyTorch library yardstick beside the least time the card could take;
4. a small end-to-end reference: the smoke config at float32 served on the
   card (kernels) and on the CPU (plain versions) must emit identical tokens;
5. the main path at full width: smollm-135m ``CONFIG`` in bf16 with seeded
   random weights, ``ServingEngine(max_batch=8, max_len=1024)`` draining 16
   requests; every request completes, pages are conserved, and both kernels
   were launched on the way (launch counters zeroed just before);
6. the paper's loop on that model: ``ServeBackend`` with the ``appdata``
   policy over a seeded bursty request stream;
7. a short profiled window of the main path (device time by kernel).

The second-to-last line of stdout is the ``kernels`` JSON record, the last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at the 700 W limit
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak, same source


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, *, reps: int = 20, flush=None) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, from CUDA events
    around each call; ``flush()`` (not timed) evicts the L2 cache before
    each call, as the serving loop finds it after the other layers ran."""
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------------

def check_attention(dev, flush) -> dict:
    """paged mixed attention at the serving shapes of smollm-135m: 8 rows of
    16 queries, 9 query / 3 kv heads of 64, 16-token pages, 64 pages a row,
    mixed starts up to 1000; bf16 and int8 pages, window -1 and 64."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_mixed, paged_mixed_attention_plain)
    from repro_torch.serving.kvcache import _span_mask, paged_gather

    B, T, Hq, Hkv, D, ps, n = 8, 16, 9, 3, 64, 16, 64
    P = B * n + 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    starts = torch.tensor([0, 17, 130, 255, 511, 640, 893, 1000], dtype=torch.int32,
                          device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    tbl = torch.zeros((B, n), dtype=torch.int32, device=dev)   # dead entries: page 0
    n_live = [-(-(int(s) + T) // ps) for s in starts.tolist()]
    for b in range(B):
        tbl[b, :n_live[b]] = perm[b * n:b * n + n_live[b]]
    q = torch.randn((B, T, Hq, D), generator=g, device=dev)
    kf = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
    vf = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
    kf[0] = vf[0] = 1e3                                        # trash-page garbage
    k8 = torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev,
                       dtype=torch.int8)
    k8[0] = v8[0] = 127
    ks = torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.02 + 1e-3

    variants = {
        "float32": (q, kf, vf, {}),
        "bfloat16": (q.bfloat16(), kf.bfloat16(), vf.bfloat16(), {}),
        "int8": (q.bfloat16(), k8, v8, {"k_scale": ks, "v_scale": vs}),
    }
    errs = {}
    for name, (qq, kk, vv, sc) in variants.items():
        for window in (-1, 64):
            args = (qq, kk, vv, tbl, starts)
            out = decode_attention_mixed(*args, window=window, **sc)
            torch.cuda.synchronize()
            ref = paged_mixed_attention_plain(*args, window=window, **sc)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-4 if name == "float32" else 2e-2
            log(f"[kernels] paged_mixed_attention {name} window={window}: "
                f"max |kernel - plain| = {err:.3e} (tol {tol})")
            if not (err <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"paged_mixed_attention {name} window={window} "
                                     f"disagrees with its plain version: {err}")
            errs[(name, window)] = err

    # timings on the main path's variant: bf16 pages, no window
    qq, kk, vv, _ = variants["bfloat16"]
    args = (qq, kk, vv, tbl, starts)
    ms = timed_ms(lambda: decode_attention_mixed(*args, window=-1), flush=flush)
    plain_ms = timed_ms(lambda: paged_mixed_attention_plain(*args, window=-1), flush=flush)
    kd = paged_gather(kk, tbl).transpose(1, 2)                 # (B, Hkv, S, D)
    vd = paged_gather(vv, tbl).transpose(1, 2)
    mask = _span_mask(n * ps, starts, T, -1)[:, None]          # (B, 1, T, S)
    qt = qq.transpose(1, 2)                                    # (B, Hq, T, D)

    def lib():
        return F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True)

    lib_err = (lib().transpose(1, 2).float()
               - paged_mixed_attention_plain(*args, window=-1).float()).abs().max().item()
    library_ms = timed_ms(lib, flush=flush)

    # least time: each live page read once, q read and out written once;
    # flops: QK^T and PV over the keys each query really attends
    elt = qq.element_size()
    live_pages = sum(n_live)
    n_bytes = (2 * qq.numel() * elt + live_pages * 2 * ps * Hkv * D * kk.element_size()
               + tbl.numel() * 4 + starts.numel() * 4)
    keys = sum(int(s) + t + 1 for s in starts.tolist() for t in range(T))
    flops = 4.0 * keys * Hq * D
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] paged_mixed_attention bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": "paged_mixed_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_mixed_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:234",
            "max_abs_err": errs[("bfloat16", -1)], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_lmhead(dev, flush) -> dict:
    """fused lm-head at the serving shape: 128 rows (8 x 16 span positions),
    d = 576, the tied 49152 x 576 bf16 embedding as the head; plus a case
    of exact ties."""
    import torch
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, lmhead_greedy_plain

    N, d, V = 128, 576, 49152
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    h = torch.randn((N, d), generator=g, device=dev).bfloat16()
    embed = (torch.randn((V, d), generator=g, device=dev) * 0.02).bfloat16()
    w = embed.T                                   # the tied head, a strided view
    tok, lp = fused_lmhead_greedy(h, w)
    torch.cuda.synchronize()
    tok_p, lp_p = lmhead_greedy_plain(h, w)
    logits = h.float() @ w.float()
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4      # summation order differs
    lp_err = (lp - lp_p).abs().max().item()
    log(f"[kernels] lmhead_greedy bf16: {int(clear.sum())}/{N} rows with a clear top-1, "
        f"tokens equal on them: {bool(torch.equal(tok[clear], tok_p[clear]))}; "
        f"max |lp - plain| = {lp_err:.3e} (tol 1e-3)")
    if not (torch.equal(tok[clear], tok_p[clear]) and lp_err <= 1e-3):
        raise AssertionError("lmhead_greedy disagrees with its plain version")

    # exact ties: integer-valued inputs make every logit exact in f32
    hi = torch.randint(-2, 3, (N, d), generator=g, device=dev).bfloat16()
    ei = torch.randint(-1, 2, (V, d), generator=g, device=dev).bfloat16()
    first = int((hi[0].float() @ ei.float().T).argmax())
    ei[5] = ei[V - 1] = ei[first]
    tok_t, lp_t = fused_lmhead_greedy(hi, ei.T)
    torch.cuda.synchronize()
    tok_tp, lp_tp = lmhead_greedy_plain(hi, ei.T)
    tie_ok = (torch.equal(tok_t, tok_tp) and int(tok_t[0]) == min(first, 5)
              and (lp_t - lp_tp).abs().max().item() <= 1e-3)
    log(f"[kernels] lmhead_greedy ties: row 0 -> {int(tok_t[0])} (first maximal index "
        f"{min(first, 5)}), all rows equal to plain: {bool(torch.equal(tok_t, tok_tp))}")
    if not tie_ok:
        raise AssertionError("lmhead_greedy breaks ties differently from argmax")

    ms = timed_ms(lambda: fused_lmhead_greedy(h, w), flush=flush)
    plain_ms = timed_ms(lambda: lmhead_greedy_plain(h, w), flush=flush)

    def lib():
        x = torch.matmul(h, w)
        return x.max(dim=-1), torch.logsumexp(x.float(), dim=-1)

    library_ms = timed_ms(lib, flush=flush)
    n_bytes = V * d * 2 + N * d * 2 + N * 8
    flops = 2.0 * N * d * V
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] lmhead_greedy bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"matmul+max+logsumexp {library_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": "lmhead_greedy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lmhead_greedy.cu",
            "replaces": "src/repro/kernels/sampling/kernel.py:139",
            "max_abs_err": lp_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------------
# phases 4-7: the serving path
# ---------------------------------------------------------------------------------

def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def small_reference(dev) -> None:
    """Smoke config at float32: the engine on the card (kernels) and on the
    CPU (plain versions) emit identical greedy tokens."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32)
    outs = {}
    for where in ("cpu", "cuda"):
        model = build_model(cfg, device=where)
        params = to_device(build_model(cfg, device="cpu").init_params(SEED), where)
        eng = ServingEngine(model, params, ServeConfig(max_batch=4, max_len=64, page_size=8,
                                                       chunk_size=8, draft_len=4),
                            device=where)
        rng = np.random.default_rng(SEED)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 24))),
                               max_new_tokens=int(rng.integers(4, 16))))
        eng.run_until_drained()
        eng.kv.check_invariants()
        outs[where] = {r.rid: (r.output, r.score) for r in eng.completed}
    same = all(outs["cpu"][r][0] == outs["cuda"][r][0] for r in outs["cpu"])
    dscore = max(abs(outs["cpu"][r][1] - outs["cuda"][r][1]) for r in outs["cpu"])
    log(f"[reference] smoke f32 engine, card vs CPU: tokens identical {same}, "
        f"max |score diff| {dscore:.2e}")
    if not (same and len(outs["cuda"]) == 6 and dscore < 1e-4):
        raise AssertionError("the engine on the card disagrees with the CPU reference")


def main_path(dev, model, params, counters) -> dict:
    import numpy as np
    import torch
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(64, 513))),
                    max_new_tokens=int(rng.integers(32, 129))) for i in range(16)]
    for r in reqs:
        eng.submit(r)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    eng.kv.check_invariants()
    emitted = sum(len(r.output) for r in reqs)
    ok = (len(eng.completed) == len(reqs)
          and all(len(r.output) == r.max_new_tokens for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output)
          and all(np.isfinite(r.score) and r.score <= 0.0 for r in reqs)
          and eng.kv.n_free == eng.kv.num_pages - 1
          and all(v > 0 for v in launches.values()))
    log(f"[main] {cfg.name} bf16, {cfg.n_layers} layers, d={cfg.d_model}: {len(eng.completed)}"
        f"/{len(reqs)} requests, {sum(len(r.prompt) for r in reqs)} prompt + {emitted} "
        f"emitted tokens in {wall:.3f} s ({emitted / wall:.1f} emitted tok/s, "
        f"{eng.step_count} mixed iterations of {1e3 * wall / eng.step_count:.2f} ms, "
        f"span {eng.span}); launches {launches}")
    log(f"[main] speculation {json.dumps(eng.speculation_stats)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not ok:
        raise AssertionError("main path failed: incomplete requests, bad outputs, a "
                             "page leak, or a kernel that never launched")
    return launches


def scaling_loop(dev, model, params, counters) -> None:
    import numpy as np
    import torch
    from repro_torch.core.scaling import make_policy
    from repro_torch.data import request_stream
    from repro_torch.launch.serve import ServeBackend
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    V = model.cfg.vocab
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
    stream = request_stream(n_requests=24, seed=SEED, mean_prompt=128, mean_decode=32,
                            burst_times=(15.0,), horizon_s=30.0)
    reqs = [Request(rid=i, arrival_s=t,
                    prompt=np.random.default_rng(i).integers(0, V, min(p, 512)),
                    max_new_tokens=max(min(d, 256), 1))
            for i, (t, p, d) in enumerate(stream)]
    backend = ServeBackend(eng, reqs, sla_s=20.0, horizon_s=30.0,
                           policy=make_policy("appdata"), decode_steps=1)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rep = backend.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    log(f"[scaling] appdata over the live engine: {rep.n_done}/{len(reqs)} completed, "
        f"SLA({rep.sla_s:.0f}s) violations {100 * rep.violation_rate:.2f}%, slots peak "
        f"{rep.max_units}/8, {rep.n_decisions_up} up / {rep.n_decisions_down} down, "
        f"{eng.step_count} engine steps in {wall:.2f} s wall; launches {launches}")
    if rep.n_done != len(reqs) or not all(v > 0 for v in launches.values()):
        raise AssertionError("scaling loop did not complete every request on the kernels")


def profile_window(dev, model, params) -> None:
    """Device time by kernel over three engine steps of the main path: one
    engine runs them unprofiled for the wall time, a twin engine with the
    same requests runs them under torch.profiler for the device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    def engine():
        eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
        rng = np.random.default_rng(SEED + 7)
        for i in range(8):
            eng.submit(Request(rid=i, prompt=rng.integers(0, model.cfg.vocab, 96),
                               max_new_tokens=24))
        eng.step(decode_steps=2)                  # warm
        torch.cuda.synchronize()
        return eng

    def three_steps(eng):
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step(decode_steps=8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, eng.step_count

    wall_ms, iters = three_steps(engine())
    twin = engine()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms, _ = three_steps(twin)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log("[profile] the profiler reported no device time: not measured")
        return
    busy_ms = sum(r[0] for r in rows)
    log(f"[profile] 3 engine steps ({iters - 1} mixed iterations after warm-up): wall "
        f"{wall_ms:.2f} ms unprofiled ({prof_wall_ms:.2f} ms profiled); device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of the unprofiled wall")
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} {key[:80]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import decode_attention_mixed
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s ({libs[build.SOURCES[0]].parent})")
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    records = [check_attention(dev, flush), check_lmhead(dev, flush)]
    del scratch
    small_reference(dev)

    counters = (decode_attention_mixed, fused_lmhead_greedy)
    cfg = get_config("smollm-135m")
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    launches = main_path(dev, model, params, counters)
    scaling_loop(dev, model, params, counters)
    profile_window(dev, model, params)

    by_kernel = {"paged_mixed_attention": launches["decode_attention_mixed"],
                 "lmhead_greedy": launches["fused_lmhead_greedy"]}
    for rec in records:
        rec["launches"] = by_kernel[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
