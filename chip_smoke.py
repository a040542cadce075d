#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build every hand-written CUDA kernel from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel); print
   each kernel's registers and spills, and the HMMA (tensor-core) count in
   the SASS of the two attention libraries with bf16 tensor-core bodies;
3. hold each kernel against its plain PyTorch version at the serving
   shapes of smollm-135m (the SSD intra-chunk kernel at mamba2-1.3b's
   prefill shape, the dense decode-attention kernel at zamba2-2.7b's shared
   attention; the two attention kernels also at qwen2.5-3b's, gemma3-4b's
   and zamba2-2.7b's head shapes), and time the kernel, the plain version
   and a PyTorch library yardstick beside the least time the card could
   take;
4. small end-to-end references: the smoke config at float32 served on the
   card (kernels) and on the CPU (plain versions) must emit identical
   tokens, on the chunked path and on the bucketed-prefill path; likewise
   mamba2-smoke through the dense-cache engine (tokens and step counts) and
   zamba2-smoke at model level (prefill and four decode steps);
5. the main path at full width: smollm-135m ``CONFIG`` in bf16 with seeded
   random weights, ``ServingEngine(max_batch=8, max_len=1024)`` draining 16
   requests; every request completes, pages are conserved, and both of its
   kernels were launched on the way (launch counters zeroed just before);
5b. the bucketed-prefill path at full width: the same model and requests
   with ``chunked_prefill=False``; every request completes, pages are
   conserved, and the flash-attention, paged-decode and greedy-epilogue
   kernels were launched (counters zeroed just before); it prints tokens/s,
   prefill occupancy and the share of requests whose tokens equal phase 5's,
   and the same share for both paths at float32;
5c. the ssm path at full width: mamba2-1.3b ``CONFIG`` in bf16 with seeded
   random weights through the engine's dense-cache fallback
   (``ServeConfig(max_batch=8, max_len=1024)``), draining phase 5's 16
   requests; every request completes, and the SSD intra-chunk kernel
   launched once per layer per prefill (counters zeroed just before);
5d. ``attention.mha_decode(use_kernel=True)``, the dense decode-attention
   kernel's only entry point, over eight decode positions at zamba2-2.7b's
   shared-attention shape, each step against the plain route;
5e. zamba2-2.7b at full width at model level: bf16 ``prefill`` of four
   512-token prompts (9 flash launches at head dim 80, 54 SSD launches),
   four decode steps, finite logits; wall, device time and peak memory;
6. the paper's loop on that model: ``ServeBackend`` with the ``appdata``
   policy over a seeded bursty request stream; 6b. the same on the
   mamba2-1.3b engine;
7. short profiled windows of the three serving paths (device time by
   kernel).

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
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores, same source


def log(msg: str) -> None:
    print(msg, flush=True)


HOLD_CYCLES = 1_000_000         # ~0.5 ms of spinning at the H100's clocks


def timed_ms(fn, *, reps: int = 20, flush=None) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, from CUDA events
    around each call; ``flush()`` (not timed) evicts the L2 cache before
    each call, as the serving loop finds it after the other layers ran.  A
    spin kernel (``torch.cuda._sleep``) holds the stream before the start
    event, so the host has enqueued ``fn``'s kernels before the clock
    starts: the time is the device's, not the host's enqueue time."""
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_us(fn, *, reps: int = 20, flush=None) -> str:
    """Mean device time of each kernel that ``fn()`` launches, from
    torch.profiler over ``reps`` calls (each after ``flush()``), as
    "name us; ..." with names cut to 40 characters; the flush's own fill
    kernel is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / reps) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and "FillFunctor" not in e.key and "Memset" not in e.key]
    if not rows:
        return "not measured (the profiler reported no device time)"
    return "; ".join(f"{k.replace('void ', '').replace('(anonymous namespace)::', '')[:40]} "
                     f"{us:.2f} us" for k, us in rows)


def bound_ms(n_bytes: float, flops: float,
             peak: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and flops over ``peak``, the
    card's rate for the operations' type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel symbol, e.g.
    ``flash_attention_bf16_kernel<Li80E>`` (Itanium ABI: a name is its
    length, then its characters; template arguments follow in I .. E)."""
    for i in range(len(mangled)):              # a length may follow other digits
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            continue
        name = mangled[j:j + int(mangled[i:j])]
        if name.endswith("_kernel") and name[0].isalpha():
            rest = mangled[j + len(name):]
            args = rest[1:rest.index("EE") + 1] if rest.startswith("I") and "EE" in rest else ""
            return f"{name}<{args}>" if args else name
    return mangled[:64]


def ptxas_report(log_text: str):
    """(kernel, "N registers, ... spill ...") for each entry function in an
    ``nvcc -Xptxas -v`` log."""
    fn, spill = "?", ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn, spill = kernel_name(line.split("'")[1]), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            yield fn, f"{line.split('Used', 1)[1].strip()}; {spill}"


def hmma_count(lib: Path) -> str:
    """The number of HMMA (tensor-core) instructions in a library's SASS,
    from ``cuobjdump -sass``; a missing tool is reported as such."""
    import shutil
    tool = next((str(p) for p in (Path("/usr/local/cuda/bin/cuobjdump"),) if p.exists()),
                shutil.which("cuobjdump"))
    if tool is None:
        return "HMMA count not read (no cuobjdump)"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        return f"HMMA count not read (cuobjdump exit {res.returncode})"
    n = sum(1 for line in res.stdout.splitlines() if "HMMA" in line)
    return f"{n} HMMA instructions in the SASS (cuobjdump -sass)"


# ---------------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------------

def paged_inputs(dev, B, T, Hq, Hkv, D, ps, n, starts, seed):
    """A paged pool (trash page 0 full of garbage that must never be read),
    a shuffled block table with dead entries on page 0, f32 and int8 pages
    with their scales, and f32 queries."""
    import torch
    P = B * n + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    starts = torch.tensor(starts, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    tbl = torch.zeros((B, n), dtype=torch.int32, device=dev)
    n_live = [-(-(int(s) + T) // ps) for s in starts.tolist()]
    for b in range(B):
        tbl[b, :n_live[b]] = perm[b * n:b * n + n_live[b]]
    q = torch.randn((B, T, Hq, D), generator=g, device=dev)
    kf = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
    vf = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
    kf[0] = vf[0] = 1e3
    k8 = torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev, dtype=torch.int8)
    k8[0] = v8[0] = 127
    ks = torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.02 + 1e-3
    return {"float32": (q, kf, vf, {}),
            "bfloat16": (q.bfloat16(), kf.bfloat16(), vf.bfloat16(), {}),
            "int8": (q.bfloat16(), k8, v8, {"k_scale": ks, "v_scale": vs})}, tbl, starts, n_live


def check_attention(dev, flush) -> dict:
    """paged mixed attention at the serving shapes of smollm-135m: 8 rows of
    16 queries, 9 query / 3 kv heads of 64, 16-token pages, 64 pages a row,
    mixed starts up to 1000; f32, bf16 and int8 pages, window -1 and 64;
    and, for correctness only, qwen2.5-3b's heads (16 / 2 of 128), also at
    32-query chunks (256 query rows a kv head: the bf16 kernel's row tiles),
    and gemma3-4b's local layers (8 / 4 of 256, window 1024, a 128-page
    table so the window bites)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, choose_pages_per_split, decode_attention_mixed,
        paged_mixed_attention_plain)
    from repro_torch.serving.kvcache import _span_mask, paged_gather

    B, T, Hq, Hkv, D, ps, n = 8, 16, 9, 3, 64, 16, 64
    variants, tbl, starts, n_live = paged_inputs(
        dev, B, T, Hq, Hkv, D, ps, n, [0, 17, 130, 255, 511, 640, 893, 1000], SEED)
    cases = [("smollm-135m", variants, tbl, starts, (-1, 64), ("float32", "bfloat16", "int8"))]
    qwen = paged_inputs(dev, 8, 16, 16, 2, 128, 16, 64,
                        [0, 17, 130, 255, 511, 640, 893, 1000], SEED + 12)
    cases.append(("qwen2.5-3b", qwen[0], qwen[1], qwen[2], (-1,),
                  ("float32", "bfloat16", "int8")))
    gemma = paged_inputs(dev, 8, 16, 8, 4, 256, 16, 128,
                         [0, 17, 130, 255, 1100, 1500, 1893, 2000], SEED + 13)
    cases.append(("gemma3-4b local", gemma[0], gemma[1], gemma[2], (1024,),
                  ("float32", "bfloat16", "int8")))
    # 32-token chunks on qwen2.5-3b: 256 query rows a kv head, two row tiles
    chunk32 = paged_inputs(dev, 8, 32, 16, 2, 128, 16, 64,
                           [0, 17, 130, 255, 511, 640, 893, 992], SEED + 18)
    cases.append(("qwen2.5-3b chunk 32", chunk32[0], chunk32[1], chunk32[2], (-1, 100),
                  ("float32", "bfloat16", "int8")))
    errs = {}
    for shape, var, tb, st, windows, names in cases:
        for name in names:
            qq, kk, vv, sc = var[name]
            for window in windows:
                args = (qq, kk, vv, tb, st)
                out = decode_attention_mixed(*args, window=window, **sc)
                torch.cuda.synchronize()
                ref = paged_mixed_attention_plain(*args, window=window, **sc)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = 1e-4 if name == "float32" else 2e-2
                log(f"[kernels] paged_mixed_attention {shape} {name} window={window}: "
                    f"max |kernel - plain| = {err:.3e} (tol {tol})")
                if not (err <= tol and torch.isfinite(out).all()):
                    raise AssertionError(f"paged_mixed_attention {shape} {name} "
                                         f"window={window} disagrees with its plain "
                                         f"version: {err}")
                errs[(shape, name, window)] = err
    del qwen, gemma, chunk32, cases

    # timings on the main path's variant: bf16 pages, no window
    qq, kk, vv, _ = variants["bfloat16"]
    args = (qq, kk, vv, tbl, starts)
    pps = choose_pages_per_split(B, Hkv, n, ps, _sm_count(0))
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
    live_splits = sum(-(-nl // pps) for nl in n_live) * Hkv
    log(f"[kernels] paged_mixed_attention bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    log(f"[kernels] paged_mixed_attention bf16: kernel/library {ms / library_ms:.3f}, "
        f"kernel/bound {ms / b_ms:.1f}; split plan {pps} pages a split, "
        f"{-(-n // pps)} splits a row, {B * Hkv * -(-n // pps)} pass-1 blocks of which "
        f"{live_splits} hold live pages")
    log(f"[kernels] paged_mixed_attention bf16 device time by kernel: "
        f"{device_us(lambda: decode_attention_mixed(*args, window=-1), flush=flush)}; "
        f"sdpa: {device_us(lib, flush=flush)}")
    return {"name": "paged_mixed_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_mixed_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:234",
            "max_abs_err": errs[("smollm-135m", "bfloat16", -1)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


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


def check_flash(dev, flush) -> dict:
    """flash attention at the bucketed prefill shape of smollm-135m: 8 rows
    of a 512 bucket, 9 query / 3 kv heads of 64; f32 and bf16, window -1
    and 64 (a local layer); and, for correctness only, zamba2-2.7b's shared
    attention (B 4, S 512, 32 / 32 heads of 80) and qwen2.5-3b's heads
    (16 / 2 of 128)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain

    def inputs(B, S, Hq, Hkv, D, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn((B, S, Hq, D), generator=g, device=dev),
                torch.randn((B, S, Hkv, D), generator=g, device=dev),
                torch.randn((B, S, Hkv, D), generator=g, device=dev))

    B, S, Hq, Hkv, D = 8, 512, 9, 3, 64
    q, k, v = inputs(B, S, Hq, Hkv, D, SEED + 2)
    cases = [("smollm-135m", (q, k, v), (-1, 64)),
             ("zamba2-2.7b", inputs(4, 512, 32, 32, 80, SEED + 14), (-1,)),
             ("qwen2.5-3b", inputs(4, 512, 16, 2, 128, SEED + 15), (-1, 64))]
    errs = {}
    for shape, (q_, k_, v_), windows in cases:
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for window in windows:
                qq, kk, vv = q_.to(dt), k_.to(dt), v_.to(dt)
                out = flash_attention_dyn(qq, kk, vv, window)
                torch.cuda.synchronize()
                ref = flash_attention_plain(qq, kk, vv, window)
                err = (out.float() - ref.float()).abs().max().item()
                tol = 1e-4 if name == "float32" else 2e-2
                log(f"[kernels] flash_attention {shape} {name} window={window}: "
                    f"max |kernel - plain| = {err:.3e} (tol {tol})")
                if not (err <= tol and torch.isfinite(out).all()):
                    raise AssertionError(f"flash_attention {shape} {name} window={window} "
                                         f"disagrees with its plain version: {err}")
                errs[(shape, name, window)] = err
    del cases

    qq, kk, vv = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ms = timed_ms(lambda: flash_attention_dyn(qq, kk, vv, -1), flush=flush)
    plain_ms = timed_ms(lambda: flash_attention_plain(qq, kk, vv, -1), flush=flush)
    qt, kt, vt = qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_err = (lib().transpose(1, 2).float()
               - flash_attention_plain(qq, kk, vv, -1).float()).abs().max().item()
    library_ms = timed_ms(lib, flush=flush)
    # least time: q, k, v read once, out written once; flops: QK^T and PV
    # over the causal pairs
    n_bytes = (2 * qq.numel() + kk.numel() + vv.numel()) * qq.element_size()
    flops = 4.0 * D * Hq * B * (S * (S + 1) // 2)
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] flash_attention bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    log(f"[kernels] flash_attention bf16: kernel/library {ms / library_ms:.3f}, "
        f"kernel/bound {ms / b_ms:.1f}")
    log(f"[kernels] flash_attention bf16 device time by kernel: "
        f"{device_us(lambda: flash_attention_dyn(qq, kk, vv, -1), flush=flush)}; "
        f"sdpa: {device_us(lib, flush=flush)}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "max_abs_err": errs[("smollm-135m", "bfloat16", -1)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def check_paged_decode(dev, flush) -> dict:
    """paged decode attention at the bucketed decode shape of smollm-135m:
    8 rows of one query, lengths 64 .. 640, 9 query / 3 kv heads of 64,
    16-token pages, 64 pages a row; bf16 and int8 pages, window -1 and 64."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_paged, paged_decode_attention_plain)
    from repro_torch.serving.kvcache import _vector_mask, paged_gather

    B, Hq, Hkv, D, ps, n = 8, 9, 3, 64, 16, 64
    P = B * n + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    lengths = torch.tensor([64, 97, 160, 255, 321, 448, 512, 640], dtype=torch.int32,
                           device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    tbl = torch.zeros((B, n), dtype=torch.int32, device=dev)   # dead entries: page 0
    n_live = [-(-int(x) // ps) for x in lengths.tolist()]
    for b in range(B):
        tbl[b, :n_live[b]] = perm[b * n:b * n + n_live[b]]
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev).bfloat16()
    kb = torch.randn((P, ps, Hkv, D), generator=g, device=dev).bfloat16()
    vb = torch.randn((P, ps, Hkv, D), generator=g, device=dev).bfloat16()
    kb[0] = vb[0] = 1e3                                        # trash-page garbage
    k8 = torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev,
                       dtype=torch.int8)
    k8[0] = v8[0] = 127
    ks = torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.02 + 1e-3
    variants = {"bfloat16": (kb, vb, {}), "int8": (k8, v8, {"k_scale": ks, "v_scale": vs})}
    errs = {}
    for name, (kk, vv, sc) in variants.items():
        for window in (-1, 64):
            args = (q, kk, vv, tbl, lengths)
            out = decode_attention_paged(*args, window=window, **sc)
            torch.cuda.synchronize()
            ref = paged_decode_attention_plain(*args, window=window, **sc)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"[kernels] paged_decode_attention {name} window={window}: "
                f"max |kernel - plain| = {err:.3e} (tol 2e-2)")
            if not (err <= 2e-2 and torch.isfinite(out).all()):
                raise AssertionError(f"paged_decode_attention {name} window={window} "
                                     f"disagrees with its plain version: {err}")
            errs[(name, window)] = err

    args = (q, kb, vb, tbl, lengths)
    ms = timed_ms(lambda: decode_attention_paged(*args, window=-1), flush=flush)
    plain_ms = timed_ms(lambda: paged_decode_attention_plain(*args, window=-1), flush=flush)
    kd = paged_gather(kb, tbl).transpose(1, 2)                 # (B, Hkv, S, D)
    vd = paged_gather(vb, tbl).transpose(1, 2)
    mask = _vector_mask(n * ps, lengths - 1, -1)[:, None]      # (B, 1, 1, S)
    qt = q.transpose(1, 2)                                     # (B, Hq, 1, D)

    def lib():
        return F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True)

    lib_err = (lib().transpose(1, 2).float()
               - paged_decode_attention_plain(*args, window=-1).float()).abs().max().item()
    library_ms = timed_ms(lib, flush=flush)
    # least time: each live page read once, q read and out written once;
    # flops: QK^T and PV over the keys each row attends
    n_bytes = (2 * q.numel() * q.element_size() + sum(n_live) * 2 * ps * Hkv * D * 2
               + tbl.numel() * 4 + lengths.numel() * 4)
    flops = 4.0 * Hq * D * int(lengths.sum())
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] paged_decode_attention bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:288",
            "max_abs_err": errs[("bfloat16", -1)], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_greedy(dev, flush) -> dict:
    """greedy epilogue over the decode step's (8, 49152) f32 logits, plus a
    case of exact ties."""
    import torch
    from repro_torch.kernels.sampling.ops import greedy_epilogue, greedy_epilogue_plain

    B, V = 8, 49152
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((B, V), generator=g, device=dev) * 3.0
    tok, lp = greedy_epilogue(x)
    torch.cuda.synchronize()
    tok_p, lp_p = greedy_epilogue_plain(x)
    err = (lp - lp_p).abs().max().item()
    xi = torch.randint(-4, 5, (B, V), generator=g, device=dev).float()
    xi[0, 7] = xi[0, 3000] = xi[0, V - 1] = 9.0
    tok_t, lp_t = greedy_epilogue(xi)
    torch.cuda.synchronize()
    tok_tp, lp_tp = greedy_epilogue_plain(xi)
    ok = (torch.equal(tok, tok_p) and err <= 1e-4 and torch.equal(tok_t, tok_tp)
          and int(tok_t[0]) == 7 and (lp_t - lp_tp).abs().max().item() <= 1e-4)
    log(f"[kernels] greedy_epilogue f32: tokens equal {bool(torch.equal(tok, tok_p))}, "
        f"max |lp - plain| = {err:.3e} (tol 1e-4); ties: row 0 -> {int(tok_t[0])} "
        f"(first maximal index 7), all rows equal to plain {bool(torch.equal(tok_t, tok_tp))}")
    if not ok:
        raise AssertionError("greedy_epilogue disagrees with its plain version")
    ms = timed_ms(lambda: greedy_epilogue(x), flush=flush)
    plain_ms = timed_ms(lambda: greedy_epilogue_plain(x), flush=flush)

    def lib():
        return x.max(dim=-1), torch.logsumexp(x, dim=-1)

    library_ms = timed_ms(lib, flush=flush)
    n_bytes = B * V * 4 + B * 8
    flops = 4.0 * B * V
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] greedy_epilogue f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"max+logsumexp {library_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB)")
    return {"name": "greedy_epilogue", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lmhead_greedy.cu",
            "replaces": "src/repro/kernels/sampling/kernel.py:63",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_ssd_intra(dev, flush) -> dict:
    """SSD intra-chunk term at mamba2-1.3b's width: 64 heads of 64, state
    128, chunk 256, one group (Bh/Ch an expand view over heads, as
    ``ssd_chunked`` passes them).  Checked and timed at the shapes phase
    5c's prefills give it (b 1, nc 1 and 2: prompts of 64 .. 512 tokens),
    at the shape phase 5e's zamba2-2.7b prefills give it (b 4, nc 2, 80
    heads of 64, state 64, expand view) and at a 2048-token prompt (nc 8),
    which is the record's shape; plus a ragged smoke shape with two groups
    (materialised by repeat_interleave).
    f32 throughout; tolerance 1e-5 of the output's largest magnitude (f32
    sums over up to q * n products in another order)."""
    import torch
    from repro_torch.kernels.ssd.ops import ssd_intra, ssd_intra_plain

    def inputs(b, nc, q, h, p, n, groups, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        xb = torch.randn((b, nc, q, h, p), generator=g, device=dev)
        dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=g, device=dev))
        A = -torch.exp(0.3 * torch.randn((h,), generator=g, device=dev))
        acs = torch.cumsum(A * dt, dim=2)
        Bq = torch.randn((b, nc, q, groups, n), generator=g, device=dev)
        Cq = torch.randn((b, nc, q, groups, n), generator=g, device=dev)
        if groups == 1:
            Bh, Ch = Bq.expand(b, nc, q, h, n), Cq.expand(b, nc, q, h, n)
        else:
            Bh = Bq.repeat_interleave(h // groups, dim=3)
            Ch = Cq.repeat_interleave(h // groups, dim=3)
        return xb, acs, Bh, Ch

    widths = {"nc 1 (phase 5c)": inputs(1, 1, 256, 64, 64, 128, 1, SEED + 4),
              "nc 2 (phase 5c)": inputs(1, 2, 256, 64, 64, 128, 1, SEED + 11),
              "zamba2-2.7b (phase 5e)": inputs(4, 2, 256, 80, 64, 64, 1, SEED + 17),
              "nc 8 (2048 tokens)": inputs(1, 8, 256, 64, 64, 128, 1, SEED + 5)}
    errs = {}
    for name, args in (*widths.items(),
                       ("ragged, 2 groups", inputs(2, 3, 40, 4, 16, 16, 2, SEED + 6))):
        out = ssd_intra(*args)
        torch.cuda.synchronize()
        ref = ssd_intra_plain(*args)
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        log(f"[kernels] ssd_intra {name} {tuple(args[0].shape)}: max |kernel - plain| = "
            f"{err:.3e} (tol {tol:.3e})")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"ssd_intra {name} disagrees with its plain version: {err}")
        errs[name] = err

    for name, args in widths.items():
        xb, acs, Bh, Ch = args
        b, nc, q, h, p = xb.shape
        n = Bh.shape[-1]
        ms = timed_ms(lambda: ssd_intra(*args), flush=flush)
        plain_ms = timed_ms(lambda: ssd_intra_plain(*args), flush=flush)
        tri = torch.ones((q, q), dtype=torch.bool, device=dev).tril()

        def lib():
            scores = torch.matmul(Ch.permute(0, 1, 3, 2, 4), Bh.permute(0, 1, 3, 4, 2))
            a = acs.permute(0, 1, 3, 2)                                # (b, nc, h, q)
            L = torch.where(tri, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
            return torch.matmul(scores * L, xb.permute(0, 1, 3, 2, 4))  # (b, nc, h, q, p)

        lib_err = (lib().permute(0, 1, 3, 2, 4) - ssd_intra_plain(*args)).abs().max().item()
        library_ms = timed_ms(lib, flush=flush)
        # least time: the JAX layout's bytes (Bh and Ch materialised per
        # head), each read once, y written once; flops: C.B and P.x over the
        # causal pairs, f32 on the CUDA cores (the JAX function is f32 end
        # to end)
        bc = b * nc
        n_bytes = 4 * (2 * bc * q * h * p + bc * q * h + 2 * bc * q * h * n)
        flops = 2.0 * (n + p) * bc * h * (q * (q + 1) // 2)
        b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
        log(f"[kernels] ssd_intra f32 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"two matmuls + masked exp {library_ms:.4f} ms (|library - plain| {lib_err:.2e}), "
            f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at "
            f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s f32; {n_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"for the bytes alone)")
    return {"name": "ssd_intra", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_intra.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:37",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def bf16_tol(ref) -> float:
    """A bf16 output's limit: 1e-2 of its largest magnitude.  Two f32
    results that agree closely round to bf16 values at most one step apart,
    2^-7 (0.78e-2) of the value; a fixed limit would be loose for the small
    outputs of a long random prefix."""
    return 1e-2 * ref.float().abs().max().item()


def check_dense_decode(dev, flush) -> dict:
    """Dense decode attention at zamba2-2.7b's shared-attention shape (B 8,
    S 4096, 32 / 32 heads of 80, pos 3000), at gemma3-4b's local layers
    (8 / 4 heads of 256, window 1024) and at an unaligned pos of 17.  f32
    at 1e-4 on the first two; bf16 on all three at :func:`bf16_tol`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)

    def inputs(B, S, Hq, Hkv, D, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn((B, 1, Hq, D), generator=g, device=dev),
                torch.randn((B, S, Hkv, D), generator=g, device=dev),
                torch.randn((B, S, Hkv, D), generator=g, device=dev))

    zamba = inputs(8, 4096, 32, 32, 80, SEED + 8)
    gemma = inputs(8, 4096, 8, 4, 256, SEED + 9)
    cases = [("zamba2 f32", zamba, torch.float32, 3000, None),
             ("zamba2 bf16", zamba, torch.bfloat16, 3000, None),
             ("gemma3 local f32", gemma, torch.float32, 3000, 1024),
             ("gemma3 local bf16", gemma, torch.bfloat16, 3000, 1024),
             ("zamba2 bf16 pos 17", zamba, torch.bfloat16, 17, None)]
    errs = {}
    for name, (q, k, v), dt, pos, window in cases:
        args = (q.to(dt), k.to(dt), v.to(dt), pos)
        out = decode_attention(*args, window=window)
        torch.cuda.synchronize()
        ref = decode_attention_plain(*args, window=window or -1)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-4 if dt == torch.float32 else bf16_tol(ref)
        log(f"[kernels] dense_decode_attention {name} (pos {pos}, window {window}): "
            f"max |kernel - plain| = {err:.3e} (tol {tol:.3e}, max |plain| "
            f"{ref.float().abs().max().item():.3e})")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"dense_decode_attention {name} disagrees with its plain "
                                 f"version: {err}")
        errs[name] = err
        del args, out, ref

    q, k, v = (t.bfloat16() for t in zamba)
    del zamba, gemma
    B, S, Hkv, D = k.shape
    Hq, pos = q.shape[2], 3000
    ms = timed_ms(lambda: decode_attention(q, k, v, pos), flush=flush)
    plain_ms = timed_ms(lambda: decode_attention_plain(q, k, v, pos), flush=flush)
    qt, kt, vt = q.transpose(1, 2), k[:, :pos].transpose(1, 2), v[:, :pos].transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=Hq != Hkv)

    lib_err = (lib().transpose(1, 2).float()
               - decode_attention_plain(q, k, v, pos).float()).abs().max().item()
    library_ms = timed_ms(lib, flush=flush)
    # least time: the K and V of the live positions read once, q read and
    # out written once; flops: QK^T and PV over the live keys
    n_bytes = 2 * B * pos * Hkv * D * 2 + 2 * q.numel() * 2
    flops = 4.0 * B * Hq * pos * D
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] dense_decode_attention bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa over the live prefix {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), "
        f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    return {"name": "dense_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dense_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
            "max_abs_err": errs["zamba2 bf16"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------------
# phases 4-7: the serving paths
# ---------------------------------------------------------------------------------

def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def small_reference(dev, *, chunked: bool = True) -> None:
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
                                                       chunk_size=8, draft_len=4,
                                                       chunked_prefill=chunked),
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
    log(f"[reference] smoke f32 {'chunked' if chunked else 'bucketed'} engine, card vs "
        f"CPU: tokens identical {same}, "
        f"max |score diff| {dscore:.2e}")
    if not (same and len(outs["cuda"]) == 6 and dscore < 1e-4):
        raise AssertionError("the engine on the card disagrees with the CPU reference")


def ssm_reference(dev) -> None:
    """The ssm path's small references at float32: mamba2-smoke through the
    dense-cache engine on the card (SSD kernel) and on the CPU (plain
    version) emits identical tokens in the same step count; zamba2-smoke,
    which the engine refuses (its decode takes one position for all rows),
    at model level: prefill, then four decode steps at a scalar position."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), dtype=torch.float32)
    runs = {}
    for where in ("cpu", "cuda"):
        params = to_device(build_model(cfg, device="cpu").init_params(SEED), where)
        eng = ServingEngine(build_model(cfg, device=where), params,
                            ServeConfig(max_batch=4, max_len=64), device=where)
        rng = np.random.default_rng(SEED)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 40))),
                               max_new_tokens=int(rng.integers(1, 16))))
        eng.run_until_drained()
        runs[where] = ([(r.rid, r.output) for r in eng.completed], eng.step_count,
                       {r.rid: r.score for r in eng.completed})
    same = runs["cpu"][:2] == runs["cuda"][:2]
    dscore = max(abs(runs["cpu"][2][r] - runs["cuda"][2][r]) for r in runs["cpu"][2])
    log(f"[reference] mamba2-smoke f32 dense-cache engine, card vs CPU: tokens, completion "
        f"order and step count ({runs['cuda'][1]}) identical {same}, max |score diff| "
        f"{dscore:.2e}")
    if not (same and len(runs["cuda"][0]) == 6 and dscore < 1e-4):
        raise AssertionError("the mamba2 engine on the card disagrees with the CPU reference")

    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(0, cfg.vocab, (2, 21)))
    toks = {}
    for where in ("cpu", "cuda"):
        model = build_model(cfg, device=where)
        params = to_device(build_model(cfg, device="cpu").init_params(SEED), where)
        logits, cache = model.prefill(params, {"tokens": tokens.to(where)}, max_len=32)
        out = [logits[:, 0].argmax(-1)]
        for i in range(4):
            logits, cache = model.decode_step(params, cache, out[-1][:, None], 21 + i)
            out.append(logits[:, 0].argmax(-1))
        toks[where] = torch.stack(out, 1).cpu()
    same = torch.equal(toks["cpu"], toks["cuda"])
    log(f"[reference] zamba2-smoke f32 model level (prefill + 4 decode steps), card vs CPU: "
        f"tokens identical {same}")
    if not same:
        raise AssertionError("the zamba2 model on the card disagrees with the CPU reference")


def main_requests(vocab):
    """Phase 5's 16 requests: prompts of 64 .. 512 tokens, 32 .. 128 new."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(64, 513))),
                    max_new_tokens=int(rng.integers(32, 129))) for i in range(16)]


def main_path(dev, model, params, counters) -> tuple[dict, dict]:
    """Phase 5; returns (launches, {rid: tokens})."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
    reqs = main_requests(cfg.vocab)
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
    return launches, {r.rid: r.output for r in reqs}


def bucketed_path(dev, model, params, counters, chunked_tokens) -> dict:
    """Phase 5b: phase 5's requests on the bucketed-prefill path.  At bf16 a
    near-tie argmax may differ between the two paths' summation orders, so
    the share of requests with phase 5's tokens is printed, not gated."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                                   chunked_prefill=False), device=dev)
    reqs = main_requests(cfg.vocab)
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
    same = sum(r.output == chunked_tokens[r.rid] for r in reqs)
    ok = (len(eng.completed) == len(reqs)
          and all(len(r.output) == r.max_new_tokens for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output)
          and all(np.isfinite(r.score) and r.score <= 0.0 for r in reqs)
          and eng.kv.n_free == eng.kv.num_pages - 1
          and all(v > 0 for v in launches.values()))
    log(f"[bucketed] {cfg.name} bf16, chunked_prefill=False: {len(eng.completed)}/{len(reqs)} "
        f"requests, {emitted} emitted tokens in {wall:.3f} s ({emitted / wall:.1f} emitted "
        f"tok/s, {eng.step_count} engine steps of {1e3 * wall / eng.step_count:.2f} ms); "
        f"prefill occupancy {eng.prefill_occupancy:.3f}, by bucket "
        f"{json.dumps(eng.bucket_occupancy)}; launches {launches}")
    log(f"[bucketed] {same}/{len(reqs)} requests emit phase 5's tokens exactly "
        f"({100 * same / len(reqs):.1f}%, not gated: bf16 near-ties may differ)")
    if not ok:
        raise AssertionError("bucketed path failed: incomplete requests, bad outputs, a "
                             "page leak, or a kernel that never launched")
    return launches


def ssm_path(dev, model, params, counters) -> tuple[dict, float]:
    """Phase 5c: phase 5's requests through the dense-cache engine on
    mamba2-1.3b at full width.  Each admitted request is prefilled alone
    (one SSD intra-chunk launch per layer); each engine step decodes all
    eight slots.  Returns (launches, wall seconds)."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
    reqs = main_requests(cfg.vocab)
    for r in reqs:
        eng.submit(r)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    emitted = sum(len(r.output) for r in reqs)
    prefills = eng._prefill_rows
    ok = (not eng.paged and len(eng.completed) == len(reqs)
          and all(len(r.output) == r.max_new_tokens for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output)
          and all(np.isfinite(r.score) and r.score <= 0.0 for r in reqs)
          and launches["ssd_intra"] == cfg.n_layers * prefills
          and all(v > 0 for v in launches.values()))
    log(f"[ssm] {cfg.name} bf16, {cfg.n_layers} layers, d={cfg.d_model}, dense-cache engine: "
        f"{len(eng.completed)}/{len(reqs)} requests, {sum(len(r.prompt) for r in reqs)} prompt "
        f"+ {emitted} emitted tokens in {wall:.3f} s ({emitted / wall:.1f} emitted tok/s, "
        f"{eng.step_count} engine steps of {1e3 * wall / eng.step_count:.2f} ms, {prefills} "
        f"prefills); launches {launches} (ssd_intra = {cfg.n_layers} x {prefills} prefills: "
        f"{launches['ssd_intra'] == cfg.n_layers * prefills})")
    log(f"[ssm] peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB (weights "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**20:.0f} MiB, dense "
        f"cache {sum(t.numel() * t.element_size() for t in eng.cache.values()) / 2**20:.0f} MiB)")
    if not ok:
        raise AssertionError("ssm path failed: incomplete requests, bad outputs, or a kernel "
                             "launch count that does not match one per layer per prefill")
    return launches, wall


def ssm_prefill_profile(dev, model, params, path_wall_s: float) -> None:
    """Phase 5c's 16 prefills again, as the engine runs them (one request
    at a time, ``model.prefill`` at max_len 1024), under torch.profiler: the
    device time of the SSD kernel at the shapes phase 5c gives it, and its
    share of phase 5c's wall."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = [torch.from_numpy(np.asarray(r.prompt, np.int64)).to(dev)[None]
               for r in main_requests(model.cfg.vocab)]

    def prefills():
        for tokens in prompts:
            model.prefill(params, {"tokens": tokens}, max_len=1024)
        torch.cuda.synchronize()

    prefills()                                     # warm
    t0 = time.perf_counter()
    prefills()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefills()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    ssd = [r for r in rows if "ssd_intra_kernel" in r[2]]
    if not ssd:
        log("[ssm prefill] the profiler reported no ssd_intra device time: not measured")
        return
    busy_ms = sum(r[0] for r in rows)
    ssd_ms, ssd_n = sum(r[0] for r in ssd), sum(r[1] for r in ssd)
    log(f"[ssm prefill] phase 5c's 16 prefills ({sum(p.shape[1] for p in prompts)} prompt "
        f"tokens, nc 1-2 of chunk {model.cfg.ssm.chunk}): wall {wall_ms:.2f} ms unprofiled, "
        f"device busy {busy_ms:.2f} ms; ssd_intra x{ssd_n} {ssd_ms:.3f} ms device "
        f"({1e3 * ssd_ms / ssd_n:.1f} us a launch, {100 * ssd_ms / busy_ms:.1f}% of the "
        f"prefills' device time, {100 * ssd_ms / (1e3 * path_wall_s):.2f}% of phase 5c's "
        f"{path_wall_s:.3f} s wall)")
    for dev_ms, count, key in sorted(rows, reverse=True)[:6]:
        log(f"[ssm prefill]   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} "
            f"{key[:80]}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def mha_decode_path(dev, counter) -> int:
    """Phase 5d: ``attention.mha_decode(use_kernel=True)``, the only entry
    point of the dense decode-attention kernel (no serving path calls it,
    in the JAX package either), over eight decode positions at zamba2-2.7b's
    shared-attention shape: each step writes the new token's K/V at
    ``pos - 1`` of a dense bf16 cache, then attends, against the plain
    route (masked sdpa)."""
    import torch
    from repro_torch.models.attention import mha_decode

    B, S, H, D = 8, 4096, 32, 80
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    k = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    counter.launches = 0
    worst, worst_tol, ok = 0.0, 0.0, True
    for pos in range(3001, 3009):
        q = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
        k[:, pos - 1] = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
        v[:, pos - 1] = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
        out = mha_decode(q, k, v, pos, use_kernel=True)
        ref = mha_decode(q, k, v, pos)
        err, tol = (out.float() - ref.float()).abs().max().item(), bf16_tol(ref)
        ok = ok and err <= tol
        if err >= worst:
            worst, worst_tol = err, tol
    torch.cuda.synchronize()
    launches = counter.launches
    log(f"[mha_decode] zamba2-2.7b shared-attention shape, 8 decode positions 3001..3008: "
        f"{launches} dense_decode_attention launches, max |kernel - masked sdpa| "
        f"{worst:.3e} (tol {worst_tol:.3e} at that step; 1e-2 of max |sdpa| at each)")
    if launches != 8 or not ok:
        raise AssertionError("mha_decode(use_kernel=True) did not run the dense kernel, "
                             "or disagrees with the plain route")
    return launches


def zamba_path(dev, counters) -> dict:
    """Phase 5e: zamba2-2.7b at full width at model level (the engine
    refuses the hybrid, as the JAX engine does): seeded bf16 weights,
    ``prefill`` of 4 seeded prompts of 512 tokens, then 4 decode steps at
    one scalar position.  The flash kernel must launch once per shared
    attention call (54 layers / 6) and the SSD kernel once per layer, in
    each prefill; logits must be finite.  Prints wall time, the device time
    of one profiled prefill by kernel, and peak memory."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("zamba2-2.7b")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    weights_mib = sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**20
    B, S = 4, 512
    tokens = torch.from_numpy(np.random.default_rng(SEED + 16).integers(
        0, cfg.vocab, (B, S))).to(dev)
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if i % cfg.shared_attn_every == cfg.shared_attn_every - 1)

    def prefill():
        return model.prefill(params, {"tokens": tokens}, max_len=S + 4)

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    finite = bool(torch.isfinite(logits).all())
    out = [logits[:, 0].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(4):
        logits, cache = model.decode_step(params, cache, out[-1][:, None], S + i)
        finite = finite and bool(torch.isfinite(logits).all())
        out.append(logits[:, 0].argmax(-1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / 4
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    ok = (finite and launches["flash_attention_dyn"] == n_attn
          and launches["ssd_intra"] == cfg.n_layers)
    log(f"[zamba2] {cfg.name} bf16, {cfg.n_layers} layers, d={cfg.d_model}, shared attention "
        f"every {cfg.shared_attn_every} ({cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}): prefill of {B} x {S} tokens {first_ms:.1f} ms cold, "
        f"{warm_ms:.1f} ms warm; 4 decode steps {decode_ms:.1f} ms each; launches per "
        f"prefill {launches} (flash = {n_attn}, ssd_intra = {cfg.n_layers}: {ok}); logits "
        f"finite {finite}; tokens {torch.stack(out, 1)[0].tolist()}")
    log(f"[zamba2] peak memory {peak_mib:.0f} MiB (weights {weights_mib:.0f} MiB)")
    if rows:
        busy_ms = sum(r[0] for r in rows)
        log(f"[zamba2] one profiled prefill: device busy {busy_ms:.2f} ms "
            f"({100 * busy_ms / warm_ms:.1f}% of the {warm_ms:.1f} ms warm wall)")
        for dev_ms, count, key in sorted(rows, reverse=True)[:8]:
            log(f"[zamba2]   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} "
                f"{key[:80]}")
    else:
        log("[zamba2] the profiler reported no device time: not measured")
    if not ok:
        raise AssertionError("zamba2-2.7b prefill failed: non-finite logits, or a kernel "
                             "launch count that is not one per attention call / layer")
    return launches


def path_agreement_f32(dev) -> None:
    """Both paths on smollm-135m at full width in float32 (seeded random
    weights), 8 requests of 16 new tokens: the share of requests with equal
    tokens.  At f32 the two paths' logits differ only by summation order,
    so a low share here, unlike at bf16, would point at a fault."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config("smollm-135m"), dtype=torch.float32)
    model = build_model(cfg, device=dev)
    params = model.init_params(SEED)
    outs = {}
    for chunked in (True, False):
        eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                                       chunked_prefill=chunked), device=dev)
        reqs = main_requests(cfg.vocab)[:8]
        for r in reqs:
            r.max_new_tokens = 16
            eng.submit(r)
        eng.run_until_drained()
        outs[chunked] = {r.rid: r.output for r in reqs}
    same = sum(outs[True][r] == outs[False][r] for r in outs[True])
    first = sum(outs[True][r][0] == outs[False][r][0] for r in outs[True])
    log(f"[bucketed] float32 check, chunked vs bucketed path on {cfg.name}: {same}/8 "
        f"requests emit equal tokens, {first}/8 equal first tokens (printed, not gated)")


def scaling_loop(dev, model, params, counters, *, n_requests: int = 24,
                 tag: str = "[scaling]") -> None:
    import numpy as np
    import torch
    from repro_torch.core.scaling import make_policy
    from repro_torch.data import request_stream
    from repro_torch.launch.serve import ServeBackend
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    V = model.cfg.vocab
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
    stream = request_stream(n_requests=n_requests, seed=SEED, mean_prompt=128, mean_decode=32,
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
    log(f"{tag} appdata over the live {model.cfg.name} engine: {rep.n_done}/{len(reqs)} completed, "
        f"SLA({rep.sla_s:.0f}s) violations {100 * rep.violation_rate:.2f}%, slots peak "
        f"{rep.max_units}/8, {rep.n_decisions_up} up / {rep.n_decisions_down} down, "
        f"{eng.step_count} engine steps in {wall:.2f} s wall; launches {launches}")
    if rep.n_done != len(reqs) or not all(v > 0 for v in launches.values()):
        raise AssertionError("scaling loop did not complete every request on the kernels")


def profile_window(dev, model, params, *, chunked: bool = True, tag: str = "[profile]",
                   kind: str = "mixed iterations") -> None:
    """Device time by kernel over three engine steps of one path: one
    engine runs them unprofiled for the wall time, a twin engine with the
    same requests runs them under torch.profiler for the device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    def engine():
        eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                                       chunked_prefill=chunked), device=dev)
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
        log(f"{tag} the profiler reported no device time: not measured")
        return
    busy_ms = sum(r[0] for r in rows)
    log(f"{tag} 3 engine steps ({iters - 1} {kind} after warm-up): wall "
        f"{wall_ms:.2f} ms unprofiled ({prof_wall_ms:.2f} ms profiled); device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of the unprofiled wall")
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"{tag}   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} {key[:80]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_mixed, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, greedy_epilogue
    from repro_torch.kernels.ssd.ops import ssd_intra
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
        for fn, line in ptxas_report(lib.with_suffix(".log").read_text()):
            log(f"[build] {name} {fn}: {line}")
    for name in ("flash_attention", "paged_mixed_attention"):
        log(f"[build] lib{name}.so: {hmma_count(libs[name])}")

    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    records = [check_attention(dev, flush), check_lmhead(dev, flush),
               check_paged_decode(dev, flush), check_greedy(dev, flush),
               check_flash(dev, flush), check_dense_decode(dev, flush),
               check_ssd_intra(dev, flush)]
    del scratch
    small_reference(dev)
    small_reference(dev, chunked=False)

    counters = (decode_attention_mixed, fused_lmhead_greedy)
    bucketed_counters = (flash_attention_dyn, decode_attention_paged, greedy_epilogue)
    cfg = get_config("smollm-135m")
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    launches, chunked_tokens = main_path(dev, model, params, counters)
    launches.update(bucketed_path(dev, model, params, bucketed_counters, chunked_tokens))
    path_agreement_f32(dev)
    scaling_loop(dev, model, params, counters)
    profile_window(dev, model, params)
    profile_window(dev, model, params, chunked=False, tag="[profile bucketed]",
                   kind="decode steps")

    # the ssm path: mamba2-1.3b through the dense-cache engine
    ssm_reference(dev)
    ssm_counters = (ssd_intra, greedy_epilogue)
    del model, params
    torch.cuda.empty_cache()
    ssm_model = build_model(get_config("mamba2-1.3b"))              # on the GPU
    ssm_params = ssm_model.init_params(SEED)
    ssm_launches, ssm_wall_s = ssm_path(dev, ssm_model, ssm_params, ssm_counters)
    ssm_prefill_profile(dev, ssm_model, ssm_params, ssm_wall_s)
    dense_launches = mha_decode_path(dev, decode_attention)
    scaling_loop(dev, ssm_model, ssm_params, ssm_counters, n_requests=12, tag="[scaling ssm]")
    profile_window(dev, ssm_model, ssm_params, tag="[profile ssm]", kind="decode steps")

    # the hybrid at full width: zamba2-2.7b prefill on the card
    del ssm_model, ssm_params
    torch.cuda.empty_cache()
    zamba_path(dev, (flash_attention_dyn, ssd_intra))

    by_kernel = {"paged_mixed_attention": launches["decode_attention_mixed"],
                 "lmhead_greedy": launches["fused_lmhead_greedy"],
                 "paged_decode_attention": launches["decode_attention_paged"],
                 "greedy_epilogue": launches["greedy_epilogue"],
                 "flash_attention": launches["flash_attention_dyn"],
                 "ssd_intra": ssm_launches["ssd_intra"],
                 "dense_decode_attention": dense_launches}
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
