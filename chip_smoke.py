#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build every hand-written CUDA kernel from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel); print
   each kernel's registers and spills, and the HMMA (tensor-core) count in
   the SASS of the three libraries with bf16 tensor-core bodies (flash,
   paged mixed attention, the lm-head), none of which may be 0;
3. hold each kernel against its plain PyTorch version at the serving
   shapes of smollm-135m (the SSD intra-chunk kernel at mamba2-1.3b's
   prefill shape, the dense decode-attention kernel at zamba2-2.7b's shared
   attention; the three attention kernels also at qwen2.5-3b's and
   gemma3-4b's head shapes, flash and paged mixed at zamba2-2.7b's; paged
   decode at the batches 1 .. 8 the bucketed engine compacts to and at
   split and window edges; the lm-head also untied, at qwen2.5-3b's width
   and with ties across its persistent blocks; the dense decode-attention
   kernel also timed at gemma3-4b's local shape; the SSD kernel beside a
   per-head and a per-group library call and the bound of each; the greedy
   epilogue at every ported config's vocabulary, B 8 and 1, f32 and bf16,
   strided and unaligned rows, timed with the L2 flushed and warm after the
   matmul that writes its logits), and time the kernel, the plain version
   and a PyTorch library yardstick beside the least time the card could
   take; likewise at the moe / vlm families' shapes: paged mixed attention
   at olmoe-1b-7b's (16 / 16 heads of 128, group 1), pixtral-12b's,
   mixtral-8x22b's (window 4096) and smollm-360m's heads, the lm-head at
   olmoe's, mixtral's and pixtral's untied heads and smollm-360m's tied
   one, paged decode attention at olmoe's heads at page sizes 8, 16, 32
   and 64 (only 16, the engine's, is a record), the greedy epilogue at
   olmoe's vocabulary (50304), and flash attention at olmoe's heads (timed),
   mixtral's (window 4096 and 64) and pixtral's;
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
   kernel);
8. the replica fleet's float32 reference (smollm-135m ``SMOKE``, weights
   written by the port's ``CheckpointManager``): a one-replica fleet on the
   card equals the bare engine on the card (tokens, done_s, completion
   order, step counts), and the ``kill-under-load`` ``ChaosDrill`` of
   tests/test_fleet.py passes on the card with the CPU's tokens;
8b. the fleet at full width (smollm-135m ``CONFIG``, bf16, seeded weights
   through a checkpoint, ``ServeConfig(max_batch=8, max_len=1024)``
   replicas sharing the card): (i) ``FleetBackend`` under the target
   policy, 1 to 3 replicas, over a bursty stream, one replica killed once
   two serve; (ii) two replicas on phase 5's requests, the newest drained
   mid-flight by ``FleetExecutor.drain``, tokens bit-identical to an
   undrained run.  Every request completes exactly once, pages are
   conserved, the measured provisioning delay is above 0, replicas peak at
   2 or more, a respawn follows the kill, and both main-path kernels
   launch (counters zeroed before each run); it prints each spawn's
   seconds (load, place, build, probe), peak memory and throughput;
9a. float32 references of the new families: olmoe-smoke and mixtral-smoke
   at capacity factor 1.25 through the engine on both paths, card against
   CPU token for token (dropped pairs printed), and pixtral-smoke from
   embeddings (forward, prefill, decode_step) within 1e-4;
9b. olmoe-1b-7b ``CONFIG`` at bf16, full width and depth, seeded weights:
   phase 5's requests on the chunked path, then the bucketed one; paged
   mixed attention launches 16 times and the lm-head once per verify_step,
   no plain version runs, a second chunked drain gives the same tokens;
   dropped pairs, peak memory, a profiled window
   (the expert ``bmm``s' and the MoE layers' shares of device time) and
   the ``appdata`` scaling loop;
9c. mixtral-8x22b at full width and 2 of its 56 layers (prefill of 4 x 512
   tokens, 8 verify_steps at positions past 512), pixtral-12b at full
   width and depth (prefill from embeddings, decode steps from embeddings
   and from tokens, 2 verify_steps), smollm-360m through the engine; each
   with its launches and its cuts;
9d. the autotune sweeps (page size, span width) at smollm-135m's and
   olmoe-1b-7b's heads and the row ``pick_defaults`` would choose, which
   is not applied.
10a. training references at float32 with ``remat="block"``: the smoke
   configs of smollm-135m, mamba2-1.3b and whisper-small, one step's loss
   and every gradient leaf on the card against the CPU, then a 5-step loss
   curve each;
10b. smollm-135m ``CONFIG`` (bf16) trained 30 steps on the TokenStream at
   B 8 x S 512 with a train-state checkpoint after step 15, then restored
   from it and steps 15-29 trained again in the same process: the loss
   falls and the resumed losses repeat the first run's; ms per step,
   tokens/s, peak memory and the 6ND share;
10c. qwen2.5-3b ``CONFIG`` 3 steps at B 4 x S 512 and mamba2-1.3b
   ``CONFIG`` 2 steps at B 2 x S 512: ms per step and peak memory;
10d. whisper-small ``CONFIG`` at model level: prefill from (2, 1500, 768)
   frame embeddings and a 32-token prompt, 16 decode steps, one train
   step.  No kernel launches during any train step (every counter is
   read around each step): training runs the plain route, as the JAX
   package trains with its kernels off;
11. the sharded train step on a one-rank NCCL mesh (``file://`` store,
   1x1 ("data", "model")): qwen2.5-3b ``CONFIG`` at full width, 4 of 36
   layers, B 4 x S 512: 3 ``sharded_step``s equal 3 plain steps from the
   same state bit for bit (losses, parameters, moments); a train-state
   checkpoint restored onto the mesh by ``restore_resharded`` bit for bit,
   with one copy's peak device memory; the parameters restored by
   ``CheckpointManager.restore_latest(template, shardings)`` bit for bit
   against ``restore_resharded`` of the same file; ``compress_allreduce_pod`` over a
   one-rank pod group exact; ``measure_provision_delay`` at dp 1, tp 1;
   then, under torch's fake backend, the parameters restored onto a (2, 4)
   mesh as rank 6, holding only that rank's blocks on the card;
12. the expert-parallel MoE (``distributed/moe_ep.py``) and the dry run
   (``launch/dryrun.py``): 12a one MoE layer at full width, T 4 x 512,
   olmoe-1b-7b ``CONFIG`` at 4 and 16 model ranks (EP) and mixtral-8x22b
   ``CONFIG`` at 16 (TP: the hidden dim cut) and 4 (EP), every rank's
   partial computed in this process with no collective and summed, held
   against the one-device ``moe_ffn`` at f32 and bf16 (dropped pairs
   equal), with each one's device ms; 12b the sharded step with the
   expert-parallel mesh set on a one-rank NCCL mesh, olmoe-1b-7b at full
   width and 4 of 16 layers, B 4 x S 512, 3 steps equal to 3 plain steps
   bit for bit; 12c ``python -m repro_torch.launch.dryrun`` in child
   processes on the host (meta tensors, fake backend; started before 12a)
   for olmoe-1b-7b train_4k on both production meshes, mixtral-8x22b
   decode_32k, mamba2-1.3b long_500k and qwen2.5-3b prefill_32k: every
   record ``ok``;
13. the tensor-parallel (Megatron) layout, on gloo ranks that are
   processes sharing the one card: 13a the sharded step at mesh (1, 2),
   qwen2.5-3b ``CONFIG`` at full width and 4 of 36 layers, B 4 x S 512,
   its f32 loss and every gradient leaf against the one-device step, then
   3 bf16 steps (ms a step, peak memory a rank); 13b ``prefill`` on the
   rank's blocks with the flash-attention kernel on each rank's 8 query
   heads over its one kv head (group 8, D 128), against the f32 prefill
   within the one-device kernel prefill's error plus bf16 tolerance (two
   planted faults must fail that gate), the kernel launched on both ranks
   and no plain version called; 13c one f32 ``decode_step`` at mesh
   (1, 4), where qwen2.5-3b's two kv heads put the cache's sequence on
   ``model``, against the one-device step;
14. the port's last modules: 14a the flash kernel causal and not (window
   -1 and 64, float32 and bf16) against its plain version at whisper-small's
   encoder shape (B 2, S 1500, 12 / 12 heads of 64) and smollm-135m's (B 8,
   S 512, 9 / 3), then the bf16 non-causal kernel at the whisper shape
   timed beside the plain version, non-causal sdpa and the bound (the
   ``flash_attention[noncausal, whisper-small enc]`` record); 14b
   ``attention.mha_prefill(use_kernel=True)`` in both modes against the
   plain route, one launch a call (the record's launches: its non-causal
   calls); 14c ``examples/torch/quickstart.py`` on the card in a child
   process (240 s at most); 14d ``python -m repro_torch.lint --selftest``
   and a run over its default paths on the host (started after phase 2),
   both exit 0;
15. the configurations the card had not served: 15a gemma3-4b ``CONFIG``
   at bf16, full width and depth (5:1 local / global, window 1024, heads
   of 256, untied 262144-word head), ``ServeConfig(max_batch=8,
   max_len=2048)``, 16 requests with prompts of 64 .. 1536 tokens (at least
   half the rows past position 1024) on the chunked path twice (the same
   tokens) and on the bucketed path: completion, pages conserved, paged
   mixed attention 34 launches and the lm-head one a ``verify_step``;
   flash 34 a prefill group, paged decode 34 a decode step, the greedy
   epilogue one a step; each attention kernel's launches also counted by
   window, 29 at 1024 and 5 at -1 a step; no plain version; then at
   float32, layers 0-5,
   two rows prefilled to 1400 tokens and 16 ``verify_step``s on the card
   against the CPU (tokens identical, logprobs within 1e-4), with a
   planted fault (the local layers' window dropped on the card) that must
   fail that gate; then ``python -m repro_torch.launch.serve --arch
   gemma3-4b --max-len 2048 --policy appdata`` as a child (3 of its 5 rows
   pass position 1024); 15b qwen2.5-3b
   ``CONFIG`` serving on the chunked path (36 launches a ``verify_step``);
   15c smollm-135m with an int8 KV cache on both paths (every paged
   kernel call on int8 pages with scales) and its float32 references, card
   against CPU; 15d ``paged=False`` on smollm-135m (flash one a layer a
   prefill, the greedy epilogue one a prefill and a step) and its float32
   reference; 15e ``python -m repro_torch.launch.train --microbatches 2``
   as a child (the loss falls), ``microbatches=2`` and ``remat="dots"``
   against 1 and ``"block"`` at float32 (loss and gradients within 1e-5),
   and both remat policies timed at full width.  Phase 3 checks and times
   the kernels at 15a's shapes first (``kernel[gemma3-4b local]`` and
   ``[gemma3-4b global]`` records, and ``lmhead_greedy[gemma3-4b]`` with a
   tie across its persistent blocks).  ``python3 tools/config_phase.py``
   runs phase 15 alone.

The second-to-last line of stdout is the ``kernels`` JSON record (the greedy
epilogue's launches are phase 5b's plus phase 5c's; a record named
``kernel[config]`` is that kernel at the config's shape, its launches from
phase 9b's or 9c's run of that config, or 15a's at that window), the last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import tempfile
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


def timed_ms(fn, *, reps: int = 20, flush=None, hold: int = HOLD_CYCLES) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, from CUDA events
    around each call; ``flush()`` (not timed) evicts the L2 cache before
    each call, as the serving loop finds it after the other layers ran.  A
    spin kernel (``torch.cuda._sleep``, ``hold`` cycles) holds the stream
    before the start event, so the host has enqueued ``fn``'s kernels
    before the clock starts: the time is the device's, not the host's
    enqueue time, where the host enqueues them within the hold."""
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_spans(fn, *, reps: int = 20, flush=None):
    """The kernels of one ``fn()`` call in launch order, each as (name, mean
    device time in us), and the mean gap from each kernel's end to the next
    one's start, from torch.profiler's device timestamps over ``reps`` calls
    (each after ``flush()``, whose fill kernel is left out).  A programmatic
    dependent's span includes its wait.  Where the calls do not launch the
    same number of kernels, one mean per kernel name and no gaps; None if
    the trace holds no kernel."""
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
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and "FillFunctor" not in e.name and "Memset" not in e.name),
                 key=lambda e: e.time_range.start)
    if not evs:
        return None

    def name(e):
        return e.name.replace("void ", "").replace("(anonymous namespace)::", "")

    if len(evs) % reps:
        spans = {}
        for e in evs:
            spans[name(e)] = spans.get(name(e), 0.0) + e.time_range.elapsed_us() / reps
        return list(spans.items()), []
    k = len(evs) // reps
    calls = [evs[i * k:(i + 1) * k] for i in range(reps)]
    spans = [(name(calls[0][j]), sum(c[j].time_range.elapsed_us() for c in calls) / reps)
             for j in range(k)]
    gaps = [sum(c[j + 1].time_range.start - c[j].time_range.end for c in calls) / reps
            for j in range(k - 1)]
    return spans, gaps


def device_us(fn, *, reps: int = 20, flush=None) -> str:
    """:func:`kernel_spans` as "name us; ...; gaps us, ..." with names cut
    to 40 characters."""
    res = kernel_spans(fn, reps=reps, flush=flush)
    if res is None:
        return "not measured (the profiler reported no device time)"
    spans, gaps = res
    text = "; ".join(f"{k[:40]} {us:.2f} us" for k, us in spans)
    if gaps:
        text += "; gaps " + ", ".join(f"{g:.2f}" for g in gaps) + " us"
    return text


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


def hmma_count(lib: Path) -> tuple[int | None, str]:
    """The number of HMMA (tensor-core) instructions in a library's SASS,
    from ``cuobjdump -sass``, and a line that says so; a missing tool gives
    None and is reported as such."""
    import shutil
    tool = next((str(p) for p in (Path("/usr/local/cuda/bin/cuobjdump"),) if p.exists()),
                shutil.which("cuobjdump"))
    if tool is None:
        return None, "HMMA count not read (no cuobjdump)"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        return None, f"HMMA count not read (cuobjdump exit {res.returncode})"
    n = sum(1 for line in res.stdout.splitlines() if "HMMA" in line)
    return n, f"{n} HMMA instructions in the SASS (cuobjdump -sass)"


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
    32-query chunks (256 query rows a kv head: the bf16 kernel's row tiles);
    gemma3-4b's heads are :func:`check_gemma_kernels`'."""
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
    del qwen, chunk32, cases

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


def lmhead_case(dev, N, d, V, *, tied=True, seed=SEED + 1):
    """Seeded bf16 h (N, d) and head w (d, V): tied ``embed.T`` of a (V, d)
    embedding, or an untied (d, V) matrix with contiguous rows."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((N, d), generator=g, device=dev).bfloat16()
    embed = (torch.randn((V, d), generator=g, device=dev) * 0.02).bfloat16()
    return h, (embed.T if tied else embed.T.contiguous())


def check_lmhead_case(label, h, w) -> float:
    """The bf16 lm-head on (h, w) against its plain version: tokens equal on
    rows with a clear top-1 (gap > 1e-4), logprob within 1e-3; returns the
    logprob error."""
    import torch
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, lmhead_greedy_plain
    tok, lp = fused_lmhead_greedy(h, w)
    torch.cuda.synchronize()
    tok_p, lp_p = lmhead_greedy_plain(h, w)
    top2 = (h.float() @ w.float()).topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4      # summation order differs
    lp_err = (lp - lp_p).abs().max().item()
    same = bool(torch.equal(tok[clear], tok_p[clear]))
    log(f"[kernels] lmhead_greedy bf16 {label}: {int(clear.sum())}/{h.shape[0]} rows with a "
        f"clear top-1, tokens equal on them: {same}; max |lp - plain| = {lp_err:.3e} "
        f"(tol 1e-3)")
    if not (same and lp_err <= 1e-3 and clear.float().mean() > 0.9):
        raise AssertionError(f"lmhead_greedy {label} disagrees with its plain version")
    return lp_err


def lmhead_library(h, w):
    """The library yardstick of the lm-head: matmul, then max and logsumexp."""
    import torch

    def lib():
        x = torch.matmul(h, w)
        return x.max(dim=-1), torch.logsumexp(x.float(), dim=-1)
    return lib


def check_lmhead(dev, flush) -> dict:
    """fused lm-head at the serving shape: 128 rows (8 x 16 span positions),
    d = 576, the tied 49152 x 576 bf16 embedding as the head; the untied
    (d, V) layout; qwen2.5-3b's width and untied head (d 2048, V 151936)
    at N 128 and 256 (two row tiles); a ragged N and V; and exact ties, one placed in the
    tiles of two different persistent blocks.  Tokens must equal the plain
    version's on rows with a clear top-1 (gap > 1e-4), logprob within
    1e-3."""
    import torch
    from repro_torch.kernels.sampling.ops import (
        LMHEAD_TILE_V, _kernel, _sm_count, fused_lmhead_greedy, lmhead_greedy_plain)

    check = check_lmhead_case
    N, d, V = 128, 576, 49152
    h, w = lmhead_case(dev, N, d, V)
    lp_err = check("smollm-135m tied 128 x 576 x 49152", h, w)
    check("smollm-135m untied (d, V)", *lmhead_case(dev, N, d, V, tied=False))
    check("ragged N 130, V 4099", *lmhead_case(dev, 130, d, 4099, seed=SEED + 19))
    qwen = {}                                      # the config's untied (d, V) head
    for n_rows in (128, 256):
        qwen[n_rows] = lmhead_case(dev, n_rows, 2048, 151936, tied=False, seed=SEED + 20)
        check(f"qwen2.5-3b untied {n_rows} x 2048 x 151936", *qwen[n_rows])

    # exact ties: integer-valued inputs make every logit exact in f32; row 0's
    # maximum sits at columns 200 and 40000, in two different blocks' tiles
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    hi = torch.randint(-2, 3, (N, d), generator=g, device=dev).bfloat16()
    ei = torch.randint(-1, 2, (V, d), generator=g, device=dev).bfloat16()
    ei[200] = ei[40000] = torch.sign(hi[0].float()).bfloat16()
    blocks = _kernel()[1](1, N, V, _sm_count(0))
    tok_t, lp_t = fused_lmhead_greedy(hi, ei.T)
    torch.cuda.synchronize()
    tok_tp, lp_tp = lmhead_greedy_plain(hi, ei.T)
    two_blocks = (200 // LMHEAD_TILE_V) % blocks != (40000 // LMHEAD_TILE_V) % blocks
    tie_ok = (torch.equal(tok_t, tok_tp) and int(tok_t[0]) == 200 and two_blocks
              and (lp_t - lp_tp).abs().max().item() <= 1e-3)
    log(f"[kernels] lmhead_greedy ties: row 0 -> {int(tok_t[0])} (first maximal index 200; "
        f"40000 in block {(40000 // LMHEAD_TILE_V) % blocks} of {blocks}, 200 in block "
        f"{(200 // LMHEAD_TILE_V) % blocks}), all rows equal to plain: "
        f"{bool(torch.equal(tok_t, tok_tp))}")
    if not tie_ok:
        raise AssertionError("lmhead_greedy breaks ties differently from argmax")

    ms = timed_ms(lambda: fused_lmhead_greedy(h, w), flush=flush)
    plain_ms = timed_ms(lambda: lmhead_greedy_plain(h, w), flush=flush)
    library = lmhead_library
    library_ms = timed_ms(library(h, w), flush=flush)
    n_bytes = V * d * 2 + N * d * 2 + N * 8
    flops = 2.0 * N * d * V
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"[kernels] lmhead_greedy bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"matmul+max+logsumexp {library_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); kernel/library "
        f"{ms / library_ms:.3f}, kernel/bound {ms / b_ms:.2f}; {blocks} persistent blocks")
    log(f"[kernels] lmhead_greedy bf16 device time by kernel: "
        f"{device_us(lambda: fused_lmhead_greedy(h, w), flush=flush)}")
    hu, wu = lmhead_case(dev, N, d, V, tied=False)
    log(f"[kernels] lmhead_greedy bf16 untied: kernel "
        f"{timed_ms(lambda: fused_lmhead_greedy(hu, wu), flush=flush):.4f} ms, library "
        f"{timed_ms(library(hu, wu), flush=flush):.4f} ms")
    for n_rows, (hq, wq) in qwen.items():
        q_ms = timed_ms(lambda: fused_lmhead_greedy(hq, wq), flush=flush)
        q_lib = timed_ms(library(hq, wq), flush=flush)
        q_b, _ = bound_ms(wq.numel() * 2 + hq.numel() * 2 + n_rows * 8, 2.0 * hq.numel() * 151936)
        log(f"[kernels] lmhead_greedy bf16 qwen2.5-3b N {n_rows}: kernel {q_ms:.4f} ms, library "
            f"{q_lib:.4f} ms, bound {q_b:.4f} ms; kernel/library {q_ms / q_lib:.3f}, "
            f"kernel/bound {q_ms / q_b:.2f}")
    del qwen
    return {"name": "lmhead_greedy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lmhead_greedy.cu",
            "replaces": "src/repro/kernels/sampling/kernel.py:139",
            "max_abs_err": lp_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_flash(dev, flush) -> list[dict]:
    """flash attention at the bucketed prefill shape of smollm-135m: 8 rows
    of a 512 bucket, 9 query / 3 kv heads of 64; f32 and bf16, window -1
    and 64 (a local layer); likewise at olmoe-1b-7b's (16 / 16 heads of
    128, group 1: phase 9b's bucketed prefill); and, for correctness only,
    zamba2-2.7b's shared attention (B 4, S 512, 32 / 32 heads of 80),
    qwen2.5-3b's heads (16 / 2 of 128), and phase 9c's prefills:
    mixtral-8x22b's (B 4, S 512, 48 / 8 of 128, window 4096 and 64) and
    pixtral-12b's (B 2, S 256, 32 / 8 of 128).  The records are the bf16
    causal calls at smollm-135m's and olmoe-1b-7b's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain

    def inputs(B, S, Hq, Hkv, D, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn((B, S, Hq, D), generator=g, device=dev),
                torch.randn((B, S, Hkv, D), generator=g, device=dev),
                torch.randn((B, S, Hkv, D), generator=g, device=dev))

    timed = {"smollm-135m": inputs(8, 512, 9, 3, 64, SEED + 2),
             "olmoe-1b-7b": inputs(8, 512, 16, 16, 128, SEED + 70)}
    cases = [("smollm-135m", timed["smollm-135m"], (-1, 64)),
             ("olmoe-1b-7b", timed["olmoe-1b-7b"], (-1, 64)),
             ("zamba2-2.7b", inputs(4, 512, 32, 32, 80, SEED + 14), (-1,)),
             ("qwen2.5-3b", inputs(4, 512, 16, 2, 128, SEED + 15), (-1, 64)),
             ("mixtral-8x22b", inputs(4, 512, 48, 8, 128, SEED + 71), (4096, 64)),
             ("pixtral-12b", inputs(2, 256, 32, 8, 128, SEED + 72), (-1,))]
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

    records = []
    for shape, (q, k, v) in timed.items():
        B, S, Hq, D = q.shape
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
        log(f"[kernels] flash_attention bf16 {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound "
            f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        log(f"[kernels] flash_attention bf16 {shape}: kernel/library {ms / library_ms:.3f}, "
            f"kernel/bound {ms / b_ms:.1f}")
        log(f"[kernels] flash_attention bf16 {shape} device time by kernel: "
            f"{device_us(lambda: flash_attention_dyn(qq, kk, vv, -1), flush=flush)}; "
            f"sdpa: {device_us(lib, flush=flush)}")
        records.append({"name": "flash_attention" if shape == "smollm-135m"
                        else f"flash_attention[{shape}]", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
                        "max_abs_err": errs[(shape, "bfloat16", -1)], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms})
    return records


def decode_inputs(dev, B, Hq, Hkv, D, ps, n, lengths, seed):
    """:func:`paged_inputs` at T = 1: one query a row at ``lengths - 1``;
    returns (variants, table, lengths, live pages a row)."""
    variants, tbl, starts, n_live = paged_inputs(dev, B, 1, Hq, Hkv, D, ps, n,
                                                 [x - 1 for x in lengths], seed)
    return variants, tbl, starts + 1, n_live


# the bucketed decode shape's lengths: 64, 448, 512 and 640 end on a split
# boundary (4 pages of 16 a split), the others inside a page
DECODE_LENGTHS = [64, 97, 160, 255, 321, 448, 512, 640]


def check_paged_decode(dev, flush) -> dict:
    """paged decode attention at the bucketed decode shape of smollm-135m:
    8 rows of one query, lengths 64 .. 640, 9 query / 3 kv heads of 64,
    16-token pages, 64 pages a row; bf16 and int8 pages, window -1, 64 (on
    a page boundary) and 40 (inside a page); the batches 1, 2 and 4 the
    bucketed engine compacts to; rows of 1, 64 and 128 keys (a live range
    ending on a split boundary); and qwen2.5-3b's head shape (16 / 2 of
    128; gemma3-4b's are :func:`check_gemma_kernels`').  Timed beside sdpa
    over the gathered pages and the mixed kernel at T = 1."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, choose_pages_per_split, decode_attention_mixed, decode_attention_paged,
        paged_decode_attention_plain)
    from repro_torch.serving.kvcache import _vector_mask, paged_gather

    B, Hq, Hkv, D, ps, n = 8, 9, 3, 64, 16, 64
    variants, tbl, lengths, n_live = decode_inputs(dev, B, Hq, Hkv, D, ps, n, DECODE_LENGTHS,
                                                   SEED + 3)
    cases = [("smollm-135m", variants, tbl, lengths, (-1, 64, 40))]
    for b in (1, 2, 4):
        cases.append((f"smollm-135m B {b}", *decode_inputs(
            dev, b, Hq, Hkv, D, ps, n, DECODE_LENGTHS[-b:], SEED + 21 + b)[:3], (-1, 40)))
    cases.append(("smollm-135m split edges", *decode_inputs(
        dev, 4, Hq, Hkv, D, ps, n, [1, 64, 128, 129], SEED + 25)[:3], (-1, 64, 7)))
    cases.append(("qwen2.5-3b", *decode_inputs(dev, 8, 16, 2, 128, ps, n, DECODE_LENGTHS,
                                               SEED + 26)[:3], (-1,)))
    errs = {}
    for shape, var, tb, lens, windows in cases:
        for name in ("bfloat16", "int8"):
            qq, kk, vv, sc = var[name]
            for window in windows:
                args = (qq, kk, vv, tb, lens)
                out = decode_attention_paged(*args, window=window, **sc)
                torch.cuda.synchronize()
                ref = paged_decode_attention_plain(*args, window=window, **sc)
                err = (out.float() - ref.float()).abs().max().item()
                log(f"[kernels] paged_decode_attention {shape} {name} window={window}: "
                    f"max |kernel - plain| = {err:.3e} (tol 2e-2)")
                if not (err <= 2e-2 and torch.isfinite(out).all()):
                    raise AssertionError(f"paged_decode_attention {shape} {name} "
                                         f"window={window} disagrees with its plain version: "
                                         f"{err}")
                errs[(shape, name, window)] = err
    del cases

    q, kb, vb, _ = variants["bfloat16"]
    args = (q, kb, vb, tbl, lengths)
    ms = timed_ms(lambda: decode_attention_paged(*args, window=-1), flush=flush)
    q8, k8, v8, sc8 = variants["int8"]
    int8_ms = timed_ms(lambda: decode_attention_paged(q8, k8, v8, tbl, lengths, window=-1,
                                                      **sc8), flush=flush)
    plain_ms = timed_ms(lambda: paged_decode_attention_plain(*args, window=-1), flush=flush)
    mixed_ms = timed_ms(lambda: decode_attention_mixed(q, kb, vb, tbl, lengths - 1, window=-1),
                        flush=flush)
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
    pps = choose_pages_per_split(B, Hkv, n, ps, _sm_count(0))
    live_splits = sum(-(-nl // pps) for nl in n_live) * Hkv
    log(f"[kernels] paged_decode_attention bf16: kernel {ms:.4f} ms (int8 pages {int8_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), "
        f"mixed kernel at T = 1 {mixed_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    log(f"[kernels] paged_decode_attention bf16: kernel/library {ms / library_ms:.3f}, "
        f"kernel/mixed {ms / mixed_ms:.3f}, kernel/bound {ms / b_ms:.1f}; split plan {pps} "
        f"pages a split, {-(-n // pps)} splits a row, {B * Hkv * -(-n // pps)} pass-1 blocks of "
        f"which {live_splits} hold live pages")
    log(f"[kernels] paged_decode_attention bf16 device time by kernel: "
        f"{device_us(lambda: decode_attention_paged(*args, window=-1), flush=flush)}; "
        f"int8: {device_us(lambda: decode_attention_paged(q8, k8, v8, tbl, lengths, window=-1, **sc8), flush=flush)}; "
        f"sdpa: {device_us(lib, flush=flush)}")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:288",
            "max_abs_err": errs[("smollm-135m", "bfloat16", -1)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


# (config, vocabulary, d_model): the greedy epilogue's rows at each ported config
GREEDY_VOCABS = (("smollm-135m", 49152, 576), ("mamba2-1.3b", 50280, 2048),
                 ("zamba2-2.7b", 32000, 2560), ("qwen2.5-3b", 151936, 2048),
                 ("gemma3-4b", 262144, 2560), ("olmoe-1b-7b", 50304, 2048))
# the configs whose (8, V) f32 row is reported as a record: smollm-135m's
# phase 5b, olmoe-1b-7b's bucketed drain of phase 9b, gemma3-4b's of 15a
GREEDY_RECORDS = {"smollm-135m": "greedy_epilogue", "olmoe-1b-7b": "greedy_epilogue[olmoe-1b-7b]",
                  "gemma3-4b": "greedy_epilogue[gemma3-4b]"}


def timed_after_ms(prep, fn, *, reps: int = 20) -> float:
    """Mean device time of ``fn()`` run right after ``prep()`` on the stream,
    as the serving loop runs the epilogue after the matmul that writes its
    logits: the L2 cache holds what ``prep`` wrote.  The events bracket
    ``fn`` only; the stream is held as in :func:`timed_ms`."""
    import torch
    for _ in range(3):
        prep()
        fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(HOLD_CYCLES)
        prep()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_greedy(dev, flush) -> list[dict]:
    """Greedy epilogue: small vocabularies first (V 999 and 4099, B 1 and 9,
    f32 and bf16, rows contiguous, strided as ``logits[:, -1]`` of a
    (B, 3, V) tensor, and starting off a 16-byte boundary an odd stride
    apart), exact ties inside a slice and across a slice boundary, then each
    ported config's vocabulary at B 8 and 1 in f32 and bf16: tokens equal
    to the plain version's, logprob within 1e-4.  Each of those is timed
    with the L2 flushed and warm right after the ``torch.matmul`` that writes
    its logits (the serving order), and its device time by kernel printed:
    one kernel a call.  The records are (8, V) f32, flushed, at smollm-135m's
    and olmoe-1b-7b's vocabularies (:data:`GREEDY_RECORDS`)."""
    import torch
    from repro_torch.kernels.sampling.ops import (
        _epilogue_kernel, _sm_count, greedy_cluster_plan, greedy_epilogue,
        greedy_epilogue_plain, greedy_max_cluster)

    active = _epilogue_kernel()[1]
    max_c = greedy_max_cluster(0)
    log(f"[kernels] greedy_epilogue: cudaOccupancyMaxActiveClusters {active(16)} clusters "
        f"of 16 CTAs, {active(8)} of 8; the plan's largest cluster {max_c}")

    def check(label, x, first=None):
        tok, lp = greedy_epilogue(x)
        torch.cuda.synchronize()
        tok_p, lp_p = greedy_epilogue_plain(x)
        err = (lp - lp_p).abs().max().item()
        if not (torch.equal(tok, tok_p) and err <= 1e-4 and bool((lp <= 0).all())
                and (first is None or int(tok[0]) == first)):
            raise AssertionError(f"greedy_epilogue {label} disagrees with its plain version "
                                 f"(max |lp - plain| {err:.3e})")
        return err

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for V in (999, 4099):
        errs = []
        for dt in dtypes.values():
            for B in (1, 9):
                full = (torch.randn((B, 3, V + 1), generator=g, device=dev) * 3.0).to(dt)
                for layout, x in (("contiguous", full[:, 0, :V].contiguous()),
                                  ("strided", full[:, -1, :V]), ("unaligned", full[:, 1, 1:])):
                    errs.append(check(f"V {V} B {B} {dt} {layout}", x))
        log(f"[kernels] greedy_epilogue V {V}: f32 and bf16, B 1 and 9, rows contiguous, "
            f"strided (B, 3, V)[:, -1] and unaligned: tokens equal, max |lp - plain| "
            f"{max(errs):.3e} (tol 1e-4)")
    B, V = 8, 49152
    C, width, _ = greedy_cluster_plan(B, V, _sm_count(0), max_c)
    xi = torch.randint(-4, 5, (B, V), generator=g, device=dev).float()
    xi[0, 7] = xi[0, 3000] = xi[0, V - 1] = 9.0          # inside rank 0's slice first
    xi[1, width - 1] = xi[1, width] = xi[1, V - 1] = 9.0  # across a slice boundary
    check("ties", xi, first=7)
    tok_t, _ = greedy_epilogue(xi)
    log(f"[kernels] greedy_epilogue ties: row 0 -> {int(tok_t[0])} (first maximal index 7), "
        f"row 1 -> {int(tok_t[1])} (first maximal index {width - 1}, the last of rank 0's "
        f"slice of {width}; {width} opens rank 1's)")
    if int(tok_t[1]) != width - 1:
        raise AssertionError("greedy_epilogue breaks a tie across slices differently from argmax")

    rec = {}
    for name, V, d in GREEDY_VOCABS:
        for dname, dt in dtypes.items():
            w = (torch.randn((d, V), generator=g, device=dev) * d ** -0.5).to(dt)
            for B in (8, 1):
                x = (torch.randn((B, V), generator=g, device=dev) * 3.0).to(dt)
                err = check(f"{name} B {B} {dname}", x)
                h = torch.randn((B, d), generator=g, device=dev).to(dt)
                ms = timed_ms(lambda: greedy_epilogue(x), flush=flush)
                warm_ms = timed_after_ms(lambda: torch.matmul(h, w, out=x),
                                         lambda: greedy_epilogue(x))
                by_kernel = device_us(lambda: greedy_epilogue(x), flush=flush)
                if by_kernel.count(" us") > 1:
                    raise AssertionError(f"greedy_epilogue launched more than one kernel: "
                                         f"{by_kernel}")
                n_bytes = x.numel() * x.element_size() + B * 8
                b_ms, b_by = bound_ms(n_bytes, 4.0 * B * V, F32_FLOPS_PER_S)
                plan = greedy_cluster_plan(B, V, _sm_count(0), max_c, x.element_size())
                log(f"[kernels] greedy_epilogue {name} ({B}, {V}) {dname}: flushed {ms:.4f} ms, "
                    f"warm after the matmul {warm_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                    f"{n_bytes / 1e6:.2f} MB; flushed/bound {ms / b_ms:.1f}), clusters of "
                    f"{plan[0]} CTAs of {plan[2]} threads x slices of {plan[1]}, max |lp - plain| "
                    f"{err:.2e}; "
                    f"device time by kernel: {by_kernel}")
                if name in GREEDY_RECORDS and (B, dname) == (8, "f32"):
                    rec[name] = dict(x=x, err=err, ms=ms, b_ms=b_ms, b_by=b_by)
            del w
    records = []
    for name, r in rec.items():
        x = r["x"]
        plain_ms = timed_ms(lambda: greedy_epilogue_plain(x), flush=flush)

        def lib():
            return x.max(dim=-1), torch.logsumexp(x, dim=-1)

        library_ms = timed_ms(lib, flush=flush)
        log(f"[kernels] greedy_epilogue {name} f32 {tuple(x.shape)}: kernel {r['ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms, max+logsumexp {library_ms:.4f} ms, bound "
            f"{r['b_ms']:.5f} ms; kernel/library {r['ms'] / library_ms:.3f}")
        records.append({"name": GREEDY_RECORDS[name], "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/greedy_epilogue.cu",
                        "replaces": "src/repro/kernels/sampling/kernel.py:63",
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": plain_ms,
                        "bound_ms": r["b_ms"], "bound_by": r["b_by"], "library_ms": library_ms})
    return records


def check_ssd_intra(dev, flush) -> dict:
    """SSD intra-chunk term at mamba2-1.3b's width: 64 heads of 64, state
    128, chunk 256, one group (Bh/Ch an expand view over heads, as
    ``ssd_chunked`` passes them, so the kernel computes the scores once for
    all heads).  Checked and timed at the shapes phase 5c's prefills give it
    (b 1, nc 1 and 2: prompts of 64 .. 512 tokens), at the shape phase 5e's
    zamba2-2.7b prefills give it (b 4, nc 2, 80 heads of 64, state 64,
    expand view) and at a 2048-token prompt (nc 8), which is the record's
    shape; plus a ragged smoke shape with two groups (materialised by
    repeat_interleave, so a group a head).  Each is timed beside two
    library calls: the JAX layout's (scores per head from the expanded
    views) and the group-aware one (scores once from the group tensors,
    broadcast over heads), and two bounds: the JAX layout's work (B and C
    read, and C.B^T computed, once per head) and the work the inputs
    require (once per group).  The record carries the group-aware bound
    and library time.  f32 throughout; tolerance 1e-5 of the output's
    largest magnitude (f32 sums over up to q * n products in another
    order)."""
    import torch
    from repro_torch.kernels.ssd.ops import _groups, ssd_intra, ssd_intra_grids, ssd_intra_plain

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
        xb, _, Bh, Ch = args
        b, nc, q, h, p = xb.shape
        G = _groups(Bh, Ch)[2]
        blocks1, blocks2 = ssd_intra_grids(b * nc, q, h, p, G)
        out = ssd_intra(*args)
        torch.cuda.synchronize()
        ref = ssd_intra_plain(*args)
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        log(f"[kernels] ssd_intra {name} {tuple(xb.shape)}: {G} group(s) of {h // G} heads "
            f"(from the head strides {Bh.stride(3)}, {Ch.stride(3)}): C.B^T computed "
            f"{G} time(s) a chunk, {blocks1} score blocks then {blocks2} head blocks; "
            f"max |kernel - plain| = {err:.3e} (tol {tol:.3e})")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"ssd_intra {name} disagrees with its plain version: {err}")
        errs[name] = err

    for name, args in widths.items():
        xb, acs, Bh, Ch = args
        b, nc, q, h, p = xb.shape
        n = Bh.shape[-1]
        Bg, Cg, G = _groups(Bh, Ch)
        ms = timed_ms(lambda: ssd_intra(*args), flush=flush)
        plain_ms = timed_ms(lambda: ssd_intra_plain(*args), flush=flush)
        tri = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
        a = acs.permute(0, 1, 3, 2)                                    # (b, nc, h, q)
        xt = xb.permute(0, 1, 3, 2, 4)                                 # (b, nc, h, q, p)

        def lib_heads():
            scores = torch.matmul(Ch.permute(0, 1, 3, 2, 4), Bh.permute(0, 1, 3, 4, 2))
            L = torch.where(tri, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
            return torch.matmul(scores * L, xt)                        # (b, nc, h, q, p)

        def lib_group():        # one group: (b, nc, 1, q, q) scores broadcast over heads
            scores = torch.matmul(Cg.permute(0, 1, 3, 2, 4), Bg.permute(0, 1, 3, 4, 2))
            L = torch.where(tri, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
            return torch.matmul(scores * L, xt)

        ref = ssd_intra_plain(*args)
        lib_err = max((f().permute(0, 1, 3, 2, 4) - ref).abs().max().item()
                      for f in (lib_heads, lib_group))
        heads_ms = timed_ms(lib_heads, flush=flush)
        library_ms = timed_ms(lib_group, flush=flush)
        # least time: each input read once and y written once; flops: C.B
        # and P.x over the causal pairs, f32 on the CUDA cores (the JAX
        # function is f32 end to end).  The JAX layout charges B, C and C.B
        # once per head; the inputs require them once per group.
        bc, pairs = b * nc, q * (q + 1) // 2
        xy_bytes = 4 * (2 * bc * q * h * p + bc * q * h)
        heads_b_ms, heads_by = bound_ms(xy_bytes + 4 * 2 * bc * q * h * n,
                                        2.0 * (n + p) * bc * h * pairs, F32_FLOPS_PER_S)
        n_bytes = xy_bytes + 4 * 2 * bc * q * G * n
        flops = 2.0 * n * bc * G * pairs + 2.0 * p * bc * h * pairs
        b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
        log(f"[kernels] ssd_intra f32 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library per head {heads_ms:.4f} ms, library per group {library_ms:.4f} ms "
            f"(two matmuls + masked exp; |library - plain| {lib_err:.2e}); bound per group "
            f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), bound "
            f"in the JAX layout {heads_b_ms:.5f} ms ({heads_by}: "
            f"{(xy_bytes + 8 * bc * q * h * n) / 1e6:.2f} MB, "
            f"{2.0 * (n + p) * bc * h * pairs / 1e9:.3f} GFLOP), at 3.35 TB/s and "
            f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s f32")
        log(f"[kernels] ssd_intra f32 {name}: kernel/library per head {ms / heads_ms:.3f}, "
            f"per group {ms / library_ms:.3f}; bound/kernel {100 * b_ms / ms:.1f}% (per "
            f"group), {100 * heads_b_ms / ms:.1f}% (JAX layout)")
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
    at 1e-4 on the first two; bf16 on all three at :func:`bf16_tol`.  The
    bf16 kernel is timed at the first two (the record: zamba2's)."""
    import torch
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

    rec = dense_decode_timing(dev, flush, "zamba2", *(t.bfloat16() for t in zamba), 3000, None)
    dense_decode_timing(dev, flush, "gemma3 local", *(t.bfloat16() for t in gemma), 3000, 1024)
    del zamba, gemma
    return {"name": "dense_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dense_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
            "max_abs_err": errs["zamba2 bf16"], **rec}


def dense_decode_timing(dev, flush, shape, q, k, v, pos, window) -> dict:
    """The bf16 dense kernel at one shape: its time, its plain version's,
    sdpa's over the visible span, and its bound; prints them with the split
    plan."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        _dense_span, _sm_count, choose_dense_pages_per_split, decode_attention,
        decode_attention_plain, dense_live_pages)

    B, S, Hkv, D = k.shape
    Hq = q.shape[2]
    w = window or -1
    lo, hi = _dense_span(S, pos, w)
    ms = timed_ms(lambda: decode_attention(q, k, v, pos, window=window), flush=flush)
    plain_ms = timed_ms(lambda: decode_attention_plain(q, k, v, pos, window=w), flush=flush)
    qt, kt, vt = q.transpose(1, 2), k[:, lo:hi].transpose(1, 2), v[:, lo:hi].transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=Hq != Hkv)

    lib_err = (lib().transpose(1, 2).float()
               - decode_attention_plain(q, k, v, pos, window=w).float()).abs().max().item()
    library_ms = timed_ms(lib, flush=flush)
    # least time: the K and V of the visible positions read once, q read and
    # out written once; flops: QK^T and PV over the visible keys
    n_bytes = 2 * B * (hi - lo) * Hkv * D * 2 + 2 * q.numel() * 2
    flops = 4.0 * B * Hq * (hi - lo) * D
    b_ms, b_by = bound_ms(n_bytes, flops)
    pps = choose_dense_pages_per_split(B, Hkv, S, pos, w, _sm_count(0))
    plo, phi = dense_live_pages(S, pos, w)
    live = (phi - 1) // pps - plo // pps + 1
    log(f"[kernels] dense_decode_attention bf16 {shape} (B {B}, S {S}, {Hq}/{Hkv} x {D}, pos "
        f"{pos}, window {window}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa over "
        f"the visible span {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP); "
        f"kernel/library {ms / library_ms:.3f}, kernel/bound {ms / b_ms:.2f}; split plan "
        f"{pps} pages of 64 keys a split, {live} live splits, {B * Hkv * live} pass-1 blocks")
    log(f"[kernels] dense_decode_attention bf16 {shape} device time by kernel: "
        f"{device_us(lambda: decode_attention(q, k, v, pos, window=window), flush=flush)}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


# the moe / vlm families' main-path shapes (config, Hq, Hkv, D, window): the
# first two are timed and reported, the rest checked
FAMILY_MIXED = (("olmoe-1b-7b", 16, 16, 128, -1), ("pixtral-12b", 32, 8, 128, -1),
                ("mixtral-8x22b", 48, 8, 128, 4096), ("smollm-360m", 15, 5, 64, -1))
# (config, d, V, tied) of the families' lm-heads, every one timed and reported
FAMILY_HEADS = (("olmoe-1b-7b", 2048, 50304, False), ("mixtral-8x22b", 6144, 32768, False),
                ("pixtral-12b", 5120, 131072, False), ("smollm-360m", 960, 49152, True))
SWEEP_PAGE_SIZES = (8, 16, 32, 64)
OLMOE_HEADS = (16, 16, 128)          # olmoe-1b-7b's (Hq, Hkv, D): MHA, group 1


def record(name, source, replaces, err, ms, plain_ms, b_ms, b_by, library_ms) -> dict:
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def paged_timing(fn, plain, args, q, kk, tbl, rows_at, ps, flush, **kw):
    """(kernel ms, plain ms, sdpa ms, bound ms, bound_by) of one paged
    attention call on bf16 pages: ``rows_at`` (B,) are each row's first
    query positions (``starts``, or ``lengths - 1`` at T = 1).  The bound
    reads once each page a query of the row can see (inside the window),
    q once and writes out once; its flops are QK^T and PV over the keys
    each query attends."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import live_pages
    from repro_torch.serving.kvcache import _span_mask, paged_gather

    B, T, Hq, D = q.shape
    Hkv = kk.shape[2]
    window = kw.get("window", -1)
    ms = timed_ms(lambda: fn(*args, **kw), flush=flush)
    plain_ms = timed_ms(lambda: plain(*args, **kw), flush=flush)
    kd = paged_gather(kk, tbl).transpose(1, 2)                 # (B, Hkv, S, D)
    vd = paged_gather(args[2], tbl).transpose(1, 2)
    mask = _span_mask(kd.shape[2], rows_at, T, window)[:, None]
    qt = q.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True)

    library_ms = timed_ms(lib, flush=flush)
    pages = sum(hi - lo for lo, hi in (live_pages(int(s), T, ps, tbl.shape[1], window)
                                       for s in rows_at.tolist()))
    n_bytes = (2 * q.numel() * q.element_size() + pages * 2 * ps * Hkv * D * 2
               + tbl.numel() * 4 + B * 4)
    keys = sum(min(int(s) + t + 1, window if window > 0 else int(s) + t + 1)
               for s in rows_at.tolist() for t in range(T))
    b_ms, b_by = bound_ms(n_bytes, 4.0 * keys * Hq * D)
    return ms, plain_ms, library_ms, b_ms, b_by


def check_family_kernels(dev, flush) -> list[dict]:
    """Phase 3 at the shapes the moe and vlm families and smollm-360m give
    the main path's kernels: paged mixed attention at each config's heads
    (8 rows of 16 queries over a 64-entry table of 16-token pages; f32,
    bf16 and int8 pages; the config's window and 100), the bf16 lm-head at
    each config's head, and paged decode attention at olmoe-1b-7b's heads
    at the page sizes the autotune sweep times (8 rows, lengths 64 .. 640;
    bf16 and int8; window -1 and 100).  Each is checked against its plain
    version, then timed beside the plain version, its library call and its
    bound.  Page sizes other than 16 run on no main path (the engine pages
    by 16), so only page size 16 is a record; the others are printed."""
    import torch
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, choose_pages_per_split, decode_attention_mixed, decode_attention_paged,
        paged_decode_attention_plain, paged_mixed_attention_plain)
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, lmhead_greedy_plain

    records = []
    for i, (arch, Hq, Hkv, D, window) in enumerate(FAMILY_MIXED):
        B, T, ps, n = 8, 16, 16, 64
        var, tbl, starts, _ = paged_inputs(
            dev, B, T, Hq, Hkv, D, ps, n, [0, 17, 130, 255, 511, 640, 893, 1000], SEED + 40 + i)
        errs = {}
        for name in ("float32", "bfloat16", "int8"):
            qq, kk, vv, sc = var[name]
            for w in (window, 100):
                out = decode_attention_mixed(qq, kk, vv, tbl, starts, window=w, **sc)
                torch.cuda.synchronize()
                ref = paged_mixed_attention_plain(qq, kk, vv, tbl, starts, window=w, **sc)
                err = (out.float() - ref.float()).abs().max().item()
                tol = 1e-4 if name == "float32" else 2e-2
                log(f"[kernels] paged_mixed_attention {arch} ({Hq}/{Hkv} heads of {D}) {name} "
                    f"window={w}: max |kernel - plain| = {err:.3e} (tol {tol})")
                if not (err <= tol and torch.isfinite(out).all()):
                    raise AssertionError(f"paged_mixed_attention {arch} {name} window={w} "
                                         f"disagrees with its plain version: {err}")
                errs[(name, w)] = err
        if arch not in ("olmoe-1b-7b", "pixtral-12b"):
            continue
        qq, kk, vv, _ = var["bfloat16"]
        ms, plain_ms, lib_ms, b_ms, b_by = paged_timing(
            decode_attention_mixed, paged_mixed_attention_plain, (qq, kk, vv, tbl, starts),
            qq, kk, tbl, starts, ps, flush, window=window)
        pps = choose_pages_per_split(B, Hkv, n, ps, _sm_count(0))
        log(f"[kernels] paged_mixed_attention bf16 {arch}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
            f"kernel/library {ms / lib_ms:.3f}, kernel/bound {ms / b_ms:.1f}; split plan {pps} "
            f"pages a split, {B * Hkv * -(-n // pps)} pass-1 blocks, {T * Hq // Hkv} query rows "
            f"a kv head")
        records.append(record(f"paged_mixed_attention[{arch}]", "paged_mixed_attention.cu",
                              "src/repro/kernels/decode_attention/kernel.py:234",
                              errs[("bfloat16", window)], ms, plain_ms, b_ms, b_by, lib_ms))
        del var

    for i, (arch, d, V, tied) in enumerate(FAMILY_HEADS):
        N = 128
        h, w = lmhead_case(dev, N, d, V, tied=tied, seed=SEED + 50 + i)
        err = check_lmhead_case(f"{arch} {'tied' if tied else 'untied'} {N} x {d} x {V}", h, w)
        ms = timed_ms(lambda: fused_lmhead_greedy(h, w), flush=flush)
        plain_ms = timed_ms(lambda: lmhead_greedy_plain(h, w), flush=flush)
        lib_ms = timed_ms(lmhead_library(h, w), flush=flush)
        b_ms, b_by = bound_ms(V * d * 2 + N * d * 2 + N * 8, 2.0 * N * d * V)
        log(f"[kernels] lmhead_greedy bf16 {arch}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"matmul+max+logsumexp {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
            f"{(V * d * 2) / 1e6:.1f} MB of head); kernel/library {ms / lib_ms:.3f}, "
            f"kernel/bound {ms / b_ms:.2f}")
        records.append(record(f"lmhead_greedy[{arch}]", "lmhead_greedy.cu",
                              "src/repro/kernels/sampling/kernel.py:139",
                              err, ms, plain_ms, b_ms, b_by, lib_ms))
        del h, w

    Hq, Hkv, D = OLMOE_HEADS
    for ps in SWEEP_PAGE_SIZES:
        B, n = 8, 1024 // ps
        var, tbl, lengths, _ = decode_inputs(dev, B, Hq, Hkv, D, ps, n, DECODE_LENGTHS,
                                                  SEED + 60 + ps)
        errs = {}
        for name in ("bfloat16", "int8"):
            qq, kk, vv, sc = var[name]
            for w in (-1, 100):
                out = decode_attention_paged(qq, kk, vv, tbl, lengths, window=w, **sc)
                torch.cuda.synchronize()
                ref = paged_decode_attention_plain(qq, kk, vv, tbl, lengths, window=w, **sc)
                err = (out.float() - ref.float()).abs().max().item()
                log(f"[kernels] paged_decode_attention olmoe-1b-7b page size {ps} {name} "
                    f"window={w}: max |kernel - plain| = {err:.3e} (tol 2e-2)")
                if not (err <= 2e-2 and torch.isfinite(out).all()):
                    raise AssertionError(f"paged_decode_attention page size {ps} {name} "
                                         f"window={w} disagrees with its plain version: {err}")
                errs[(name, w)] = err
        qq, kk, vv, _ = var["bfloat16"]
        ms, plain_ms, lib_ms, b_ms, b_by = paged_timing(
            decode_attention_paged, paged_decode_attention_plain, (qq, kk, vv, tbl, lengths),
            qq, kk, tbl, lengths - 1, ps, flush, window=-1)
        pps = choose_pages_per_split(B, Hkv, n, ps, _sm_count(0))
        log(f"[kernels] paged_decode_attention bf16 olmoe-1b-7b page size {ps}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}); kernel/library {ms / lib_ms:.3f}, kernel/bound {ms / b_ms:.1f}; split "
            f"plan {pps} pages a split")
        if ps == 16:
            records.append(record("paged_decode_attention[olmoe-1b-7b]",
                                  "paged_decode_attention.cu",
                                  "src/repro/kernels/decode_attention/kernel.py:288",
                                  errs[("bfloat16", -1)], ms, plain_ms, b_ms, b_by, lib_ms))
        del var
    return records


# gemma3-4b's attention heads (Hq, Hkv, D) and local window; phase 15a's
# engine runs 29 local and 5 global layers a step (``lm.layer_windows``)
GEMMA_HEADS = (8, 4, 256)
GEMMA_WINDOW = 1024
# phase 15a's rows: starts (paged mixed) and lengths (paged decode) over
# 128-page rows of 16 tokens, most past the window
GEMMA_STARTS = [0, 17, 130, 1010, 1100, 1500, 1893, 2032]
GEMMA_LENGTHS = [64, 300, 1024, 1025, 1500, 1893, 2000, 2048]


def check_gemma_kernels(dev, flush) -> list[dict]:
    """Phase 3 at the shapes phase 15a gives the kernels on gemma3-4b
    (8 / 4 heads of 256, window 1024 on the local layers, -1 on the
    global ones, ``max_len`` 2048): the bf16 lm-head on the untied
    2560 x 262144 head at N 128 (the chunked step's 8 x 16 rows), with an
    exact tie across two persistent blocks; flash attention at the
    bucketed prefill's largest group, B 8 x S 2048; paged mixed attention
    at 8 rows of 16 queries and paged decode attention at 8 rows of one,
    over 128-page rows (f32, bf16 and int8 pages).  Each is checked
    against its plain version at both windows, then timed (bf16) beside
    the plain version, its library call and its bound; the records are
    ``kernel[gemma3-4b local]`` and ``[gemma3-4b global]`` (the lm-head's
    ``lmhead_greedy[gemma3-4b]``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_mixed, decode_attention_paged, paged_decode_attention_plain,
        paged_mixed_attention_plain)
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn, flash_attention_plain
    from repro_torch.kernels.sampling.ops import (
        LMHEAD_TILE_V, _kernel, _sm_count, fused_lmhead_greedy, lmhead_greedy_plain)

    Hq, Hkv, D = GEMMA_HEADS
    windows = {"local": GEMMA_WINDOW, "global": -1}
    records = []
    paged_src = "src/repro/kernels/decode_attention/kernel.py"

    # the lm-head: seeded, then an exact tie in two different blocks' tiles
    N, d, V = 128, 2560, 262144
    h, w = lmhead_case(dev, N, d, V, tied=False, seed=SEED + 80)
    err = check_lmhead_case(f"gemma3-4b untied {N} x {d} x {V}", h, w)
    g = torch.Generator(device=dev).manual_seed(SEED + 81)
    hi = torch.randint(-2, 3, (N, d), generator=g, device=dev, dtype=torch.int8).bfloat16()
    wi = torch.randint(-1, 2, (d, V), generator=g, device=dev, dtype=torch.int8).bfloat16()
    wi[:, 300] = wi[:, 200000] = torch.sign(hi[0].float()).bfloat16()
    blocks = _kernel()[1](1, N, V, _sm_count(0))
    tok_t, lp_t = fused_lmhead_greedy(hi, wi)
    torch.cuda.synchronize()
    tok_p, lp_p = lmhead_greedy_plain(hi, wi)
    b_a, b_b = (300 // LMHEAD_TILE_V) % blocks, (200000 // LMHEAD_TILE_V) % blocks
    tie_ok = (torch.equal(tok_t, tok_p) and int(tok_t[0]) == 300 and b_a != b_b
              and (lp_t - lp_p).abs().max().item() <= 1e-3)
    log(f"[kernels] lmhead_greedy gemma3-4b ties: row 0 -> {int(tok_t[0])} (first maximal index "
        f"300 in block {b_a} of {blocks}, 200000 in block {b_b}), all rows equal to plain: "
        f"{bool(torch.equal(tok_t, tok_p))}")
    if not tie_ok:
        raise AssertionError("lmhead_greedy at gemma3-4b's head breaks ties differently from "
                             "argmax")
    del hi, wi
    ms = timed_ms(lambda: fused_lmhead_greedy(h, w), flush=flush)
    plain_ms = timed_ms(lambda: lmhead_greedy_plain(h, w), flush=flush)
    lib_ms = timed_ms(lmhead_library(h, w), flush=flush)
    b_ms, b_by = bound_ms(V * d * 2 + N * d * 2 + N * 8, 2.0 * N * d * V)
    log(f"[kernels] lmhead_greedy bf16 gemma3-4b: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"matmul+max+logsumexp {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
        f"{(V * d * 2) / 1e6:.1f} MB of head); kernel/library {ms / lib_ms:.3f}, kernel/bound "
        f"{ms / b_ms:.2f}; {blocks} persistent blocks")
    records.append(record("lmhead_greedy[gemma3-4b]", "lmhead_greedy.cu",
                          "src/repro/kernels/sampling/kernel.py:139", err, ms, plain_ms, b_ms,
                          b_by, lib_ms))
    del h, w

    # flash attention at the bucketed prefill's bucket 2048, 8 rows
    B, S = 8, 2048
    g = torch.Generator(device=dev).manual_seed(SEED + 82)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev) for H in (Hq, Hkv, Hkv))
    errs = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
        for window in windows.values():
            out = flash_attention_dyn(qq, kk, vv, window)
            torch.cuda.synchronize()
            ref = flash_attention_plain(qq, kk, vv, window)
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-4 if name == "float32" else 2e-2
            log(f"[kernels] flash_attention gemma3-4b B {B} S {S} {name} window={window}: "
                f"max |kernel - plain| = {err:.3e} (tol {tol})")
            if not (err <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"flash_attention gemma3-4b {name} window={window} "
                                     f"disagrees with its plain version: {err}")
            errs[(name, window)] = err
            del out, ref
    qq, kk, vv = q.bfloat16(), k.bfloat16(), v.bfloat16()
    del q, k, v
    qt, kt, vt = qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
    pos = torch.arange(S, device=dev)
    for kind, window in windows.items():
        ms = timed_ms(lambda: flash_attention_dyn(qq, kk, vv, window), flush=flush)
        plain_ms = timed_ms(lambda: flash_attention_plain(qq, kk, vv, window), flush=flush)
        if window > 0:
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
            pairs = sum(min(i + 1, window) for i in range(S))
        else:
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
            pairs = S * (S + 1) // 2
        lib_ms = timed_ms(lib, flush=flush)
        n_bytes = (2 * qq.numel() + kk.numel() + vv.numel()) * qq.element_size()
        b_ms, b_by = bound_ms(n_bytes, 4.0 * D * Hq * B * pairs)
        log(f"[kernels] flash_attention bf16 gemma3-4b {kind} (window {window}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}: {n_bytes / 1e6:.2f} MB, {4.0 * D * Hq * B * pairs / 1e9:.3f} GFLOP); "
            f"kernel/library {ms / lib_ms:.3f}, kernel/bound {ms / b_ms:.1f}")
        records.append(record(f"flash_attention[gemma3-4b {kind}]", "flash_attention.cu",
                              "src/repro/kernels/flash_attention/kernel.py:77",
                              errs[("bfloat16", window)], ms, plain_ms, b_ms, b_by, lib_ms))
    del qq, kk, vv, qt, kt, vt

    # paged mixed attention (16 queries a row) and paged decode (one), 128-page rows
    ps, n = 16, 128
    cases = (("paged_mixed_attention", decode_attention_mixed, paged_mixed_attention_plain,
              paged_inputs(dev, 8, 16, Hq, Hkv, D, ps, n, GEMMA_STARTS, SEED + 83), 0, 234),
             ("paged_decode_attention", decode_attention_paged, paged_decode_attention_plain,
              decode_inputs(dev, 8, Hq, Hkv, D, ps, n, GEMMA_LENGTHS, SEED + 84), 1, 288))
    for kname, fn, plain, (var, tbl, rows, _), at_t1, line in cases:
        errs = {}
        names = ("float32", "bfloat16", "int8") if not at_t1 else ("bfloat16", "int8")
        for name in names:
            qq, kk, vv, sc = var[name]
            for window in windows.values():
                out = fn(qq, kk, vv, tbl, rows, window=window, **sc)
                torch.cuda.synchronize()
                ref = plain(qq, kk, vv, tbl, rows, window=window, **sc)
                err = (out.float() - ref.float()).abs().max().item()
                tol = 1e-4 if name == "float32" else 2e-2
                log(f"[kernels] {kname} gemma3-4b (128-page rows) {name} window={window}: "
                    f"max |kernel - plain| = {err:.3e} (tol {tol})")
                if not (err <= tol and torch.isfinite(out).all()):
                    raise AssertionError(f"{kname} gemma3-4b {name} window={window} disagrees "
                                         f"with its plain version: {err}")
                errs[(name, window)] = err
        qq, kk, vv, _ = var["bfloat16"]
        for kind, window in windows.items():
            ms, plain_ms, lib_ms, b_ms, b_by = paged_timing(
                fn, plain, (qq, kk, vv, tbl, rows), qq, kk, tbl, rows - at_t1, ps, flush,
                window=window)
            log(f"[kernels] {kname} bf16 gemma3-4b {kind} (window {window}): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
                f"kernel/library {ms / lib_ms:.3f}, kernel/bound {ms / b_ms:.1f}")
            records.append(record(f"{kname}[gemma3-4b {kind}]", f"{kname}.cu",
                                  f"{paged_src}:{line}", errs[("bfloat16", window)], ms,
                                  plain_ms, b_ms, b_by, lib_ms))
        del var
    return records


# ---------------------------------------------------------------------------------
# phases 4-7: the serving paths
# ---------------------------------------------------------------------------------

def to_device(tree, dev):
    """A tree of tensors (dicts and lists) moved to ``dev``."""
    from repro_torch.pytree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


# phase 4's score tolerance, card against CPU at float32, with the native and
# the int8 KV cache alike
REF_SCORE_TOL = 1e-4


def small_reference(dev, *, chunked: bool = True, kv: str = "native",
                    paged: bool = True) -> None:
    """Smoke config at float32: the engine on the card (kernels) and on the
    CPU (plain versions) emit identical greedy tokens in the same step
    count, scores within :data:`REF_SCORE_TOL`; with ``kv`` "int8" over an
    int8 KV cache (phase 15c), with ``paged=False`` through the dense-cache
    fallback (phase 15d)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32,
                              kv_cache_dtype=kv)
    outs, steps = {}, {}
    for where in ("cpu", "cuda"):
        model = build_model(cfg, device=where)
        params = to_device(build_model(cfg, device="cpu").init_params(SEED), where)
        eng = ServingEngine(model, params, ServeConfig(max_batch=4, max_len=64, page_size=8,
                                                       chunk_size=8, draft_len=4,
                                                       chunked_prefill=chunked, paged=paged),
                            device=where)
        rng = np.random.default_rng(SEED)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 24))),
                               max_new_tokens=int(rng.integers(4, 16))))
        eng.run_until_drained()
        if paged:
            eng.kv.check_invariants()
        elif eng.paged:
            raise AssertionError("paged=False built a paged engine")
        outs[where] = {r.rid: (r.output, r.score) for r in eng.completed}
        steps[where] = eng.step_count
    same = all(outs["cpu"][r][0] == outs["cuda"][r][0] for r in outs["cpu"])
    dscore = max(abs(outs["cpu"][r][1] - outs["cuda"][r][1]) for r in outs["cpu"])
    path = ("dense-cache" if not paged else "chunked" if chunked else "bucketed")
    log(f"[reference] smoke f32 {path} engine, kv cache {kv}, card vs CPU: tokens identical "
        f"{same}, step counts {steps['cuda']} / {steps['cpu']}, max |score diff| {dscore:.2e} "
        f"(tol {REF_SCORE_TOL})")
    if not (same and len(outs["cuda"]) == 6 and steps["cuda"] == steps["cpu"]
            and dscore < REF_SCORE_TOL):
        raise AssertionError(f"the {path} engine ({kv} kv cache) on the card disagrees with "
                             f"the CPU reference")


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


def main_path(dev, model, params, counters, *, requests=main_requests, max_len: int = 1024,
              tag: str = "[main]") -> tuple[dict, dict]:
    """Phase 5 (or ``requests(vocab)`` at ``max_len``, printed under
    ``tag``); returns (launches, {rid: tokens})."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=max_len), device=dev)
    reqs = requests(cfg.vocab)
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
    log(f"{tag} {cfg.name} {str(cfg.dtype).removeprefix('torch.')}, {cfg.n_layers} layers, "
        f"d={cfg.d_model}, kv cache {cfg.kv_cache_dtype}: {len(eng.completed)}"
        f"/{len(reqs)} requests, {sum(len(r.prompt) for r in reqs)} prompt + {emitted} "
        f"emitted tokens in {wall:.3f} s ({emitted / wall:.1f} emitted tok/s, "
        f"{eng.step_count} mixed iterations of {1e3 * wall / eng.step_count:.2f} ms, "
        f"span {eng.span}); launches {launches}")
    log(f"{tag} speculation {json.dumps(eng.speculation_stats)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not ok:
        raise AssertionError("main path failed: incomplete requests, bad outputs, a "
                             "page leak, or a kernel that never launched")
    return launches, {r.rid: r.output for r in reqs}


def token_share(reqs, tokens: dict) -> tuple[int, int]:
    """(positions where ``reqs``' outputs equal ``tokens[rid]``, positions)."""
    same = sum(a == b for r in reqs for a, b in zip(r.output, tokens[r.rid]))
    return same, sum(len(r.output) for r in reqs)


def bucketed_path(dev, model, params, counters, chunked_tokens, *, requests=main_requests,
                  max_len: int = 1024, tag: str = "[bucketed]") -> dict:
    """Phase 5b: phase 5's requests on the bucketed-prefill path (or
    ``requests(vocab)`` at ``max_len``, printed under ``tag``).  At bf16 a
    near-tie argmax may differ between the two paths' summation orders, so
    the share of requests (and of tokens) equal to ``chunked_tokens`` is
    printed, not gated."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=max_len,
                                                   chunked_prefill=False), device=dev)
    reqs = requests(cfg.vocab)
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
    same_tok, n_tok = token_share(reqs, chunked_tokens)
    log(f"{tag} {cfg.name} {str(cfg.dtype).removeprefix('torch.')}, kv cache "
        f"{cfg.kv_cache_dtype}, chunked_prefill=False: {len(eng.completed)}/{len(reqs)} "
        f"requests, {emitted} emitted tokens in {wall:.3f} s ({emitted / wall:.1f} emitted "
        f"tok/s, {eng.step_count} engine steps of {1e3 * wall / eng.step_count:.2f} ms); "
        f"prefill occupancy {eng.prefill_occupancy:.3f}, by bucket "
        f"{json.dumps(eng.bucket_occupancy)}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"{tag} {same}/{len(reqs)} requests emit the chunked path's tokens exactly "
        f"({100 * same / len(reqs):.1f}%), {same_tok}/{n_tok} tokens "
        f"({100 * same_tok / max(n_tok, 1):.1f}%; not gated: bf16 near-ties may differ)")
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ssd = [e for e in kernels if "ssd_intra" in e.name]
    if not ssd:
        log("[ssm prefill] the profiler reported no ssd_intra device time: not measured")
        return
    # the device time of a set of kernels is the union of their spans: the
    # SSD kernel's second pass starts (and waits) while its first runs
    busy_ms, ssd_ms = union_ms(kernels), union_ms(ssd)
    by_pass = {k: sum(1 for e in ssd if k in e.name)
               for k in ("ssd_intra_scores_kernel", "ssd_intra_apply_kernel")}
    calls = max(by_pass.values())
    log(f"[ssm prefill] phase 5c's 16 prefills ({sum(p.shape[1] for p in prompts)} prompt "
        f"tokens, nc 1-2 of chunk {model.cfg.ssm.chunk}): wall {wall_ms:.2f} ms unprofiled, "
        f"device busy {busy_ms:.2f} ms (union of kernel spans); ssd_intra x{calls} calls "
        f"({', '.join(f'{k} x{v}' for k, v in by_pass.items())}) "
        f"{ssd_ms:.3f} ms device ({1e3 * ssd_ms / calls:.1f} us a call, "
        f"{100 * ssd_ms / busy_ms:.1f}% of the prefills' device time, "
        f"{100 * ssd_ms / (1e3 * path_wall_s):.2f}% of phase 5c's {path_wall_s:.3f} s wall)")
    for dev_ms, count, key in sorted(rows, reverse=True)[:6]:
        log(f"[ssm prefill]   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} "
            f"{key[:80]}")


def union_ms(events) -> float:
    """Total time covered by the profiler events' spans, in ms."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1e3


def _leaves(tree):
    from repro_torch.pytree import tree_leaves
    return tree_leaves(tree)


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


# the scaling loops' stream (phases 6, 6b and 9b's loop): 7 requests arrive
# over 30 s, on both sides of the burst at 15 s and one within 5 s of it (the
# loop gates both).  On random weights ``appdata`` never leaves one slot, so
# they run one after another; 24 (26 arrivals; 12 on mamba2) took 170 s of a
# slow host's run before phase 15 needed the time
SCALING_REQUESTS = 8
SCALING_BURST_S = 15.0


def scaling_loop(dev, model, params, counters, *, tag: str = "[scaling]") -> None:
    import numpy as np
    import torch
    from repro_torch.core.scaling import make_policy
    from repro_torch.data import request_stream
    from repro_torch.launch.serve import ServeBackend
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    V = model.cfg.vocab
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024), device=dev)
    stream = request_stream(n_requests=SCALING_REQUESTS, seed=SEED, mean_prompt=128,
                            mean_decode=32, burst_times=(SCALING_BURST_S,), horizon_s=30.0)
    arrivals = [t for t, _, _ in stream]
    near = sum(abs(t - SCALING_BURST_S) <= 5.0 for t in arrivals)
    log(f"{tag} stream: {len(arrivals)} arrivals at {[round(t, 1) for t in arrivals]} s, "
        f"{near} within 5 s of the burst at {SCALING_BURST_S:.0f} s")
    if not (near and arrivals[0] < SCALING_BURST_S < arrivals[-1]):
        raise AssertionError("the scaling stream does not span its burst")
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
                   kind: str = "mixed iterations", shares=()) -> None:
    """Device time by kernel over three engine steps of one path: one
    engine runs them unprofiled for the wall time, a twin engine with the
    same requests runs them under torch.profiler for the device time.
    ``shares``: (label, profiler key) pairs of host-side ops or
    ``record_function`` ranges whose kernels' device time is printed as a
    share of the busy time."""
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
    # the device-side copies of ``shares``' ranges are spans, not kernels
    ranges = {key for _, key in shares}
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in ranges]
    if not rows:
        log(f"{tag} the profiler reported no device time: not measured")
        return
    busy_ms = sum(r[0] for r in rows)
    log(f"{tag} 3 engine steps ({iters - 1} {kind} after warm-up): wall "
        f"{wall_ms:.2f} ms unprofiled ({prof_wall_ms:.2f} ms profiled); device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of the unprofiled wall")
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"{tag}   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} {key[:80]}")
    for label, key in shares:
        # host-side events: each one's device time is its kernels' and its children's
        evs = [e for e in prof.events() if e.name == key and e.device_type == DeviceType.CPU]
        ms = sum(e.device_time_total for e in evs) / 1e3
        log(f"{tag} {label} ({key}): " + (
            f"{ms:.3f} ms of device time over {len(evs)} calls, {100 * ms / busy_ms:.1f}% of "
            f"device busy" if ms > 0 else "not measured (no device time under it)"))
    epi = [(dev_ms, count) for dev_ms, count, key in rows if "greedy_epilogue_kernel" in key]
    if epi:
        epi_ms, epi_n = sum(r[0] for r in epi), sum(r[1] for r in epi)
        log(f"{tag} greedy epilogue: {epi_ms:.3f} ms of device time over {epi_n} launches (one "
            f"a decode step or prefill), {1e3 * epi_ms / epi_n:.2f} us a launch, "
            f"{100 * epi_ms / busy_ms:.2f}% of device busy")


# ---------------------------------------------------------------------------------
# phase 8: the replica fleet
# ---------------------------------------------------------------------------------

class _Hold:
    """A policy that votes zero delta forever: the only scaling activity
    left is fault healing (the drill's policy in tests/test_fleet.py)."""

    name = "hold"

    def reset(self):
        pass

    def decide(self, obs):
        from repro_torch.core.autoscaler.base import Decision
        return Decision(0, "hold")

    def describe(self):
        return "hold"


def fleet_requests(vocab, n, *, arrival, decode, seed):
    """tests/test_fleet.py's request shape: prompts of 8, 16 or 24 tokens."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival_s=arrival(i),
                    prompt=rng.integers(0, vocab, 8 + (i % 3) * 8).astype(np.int32),
                    max_new_tokens=decode(i)) for i in range(n)]


def spawn_line(rep) -> str:
    parts = ", ".join(f"{k[:-2]} {v:.3f}" for k, v in rep.spawn_parts.items())
    return f"replica{rep.rix} {rep.spawn_s:.3f} s ({parts})"


def fleet_reference(dev, ckpt_dir: str) -> None:
    """Phase 8, float32 smoke config, weights written by the port's
    CheckpointManager: (a) a one-replica fleet on the card equals the bare
    engine on the card (tokens, done_s, completion order, step counts);
    (b) the kill-under-load ChaosDrill of tests/test_fleet.py passes on the
    card, and its completed tokens equal the same drill's on the CPU."""
    import dataclasses
    import os

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.chaos import ChaosAction, ChaosDrill, ChaosScript
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving.fleet import FleetBackend, FleetRouter, ReplicaPool

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32)
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    mgr.save(build_model(cfg, device="cpu").init_params(SEED), step=1)
    serve_cfg = ServeConfig(max_batch=4, max_len=128, decode_steps=4)

    model = build_model(cfg, device=dev)
    pool = ReplicaPool(model, mgr, serve_cfg)
    replica, _ = pool.spawn()
    pool.serving.append(replica)
    probe_steps = replica.eng.step_count
    bare = ServingEngine(model, replica.eng.params, serve_cfg, device=dev)
    router = FleetRouter(pool)
    arrival, decode = (lambda i: float(i // 3)), (lambda i: 4 + i % 5)
    fleet_reqs = fleet_requests(cfg.vocab, 10, arrival=arrival, decode=decode, seed=7)
    bare_reqs = fleet_requests(cfg.vocab, 10, arrival=arrival, decode=decode, seed=7)
    heads = [0, 0]
    for t in range(200):
        while heads[0] < 10 and fleet_reqs[heads[0]].arrival_s <= t:
            router.submit(fleet_reqs[heads[0]])
            heads[0] += 1
        router.dispatch(float(t))
        replica.step(float(t), decode_steps=2)
        while heads[1] < 10 and bare_reqs[heads[1]].arrival_s <= t:
            bare.submit(bare_reqs[heads[1]])
            heads[1] += 1
        bare.step(now=float(t), decode_steps=2)
        if not router.backlog and not replica.eng.n_in_system and not bare.n_in_system:
            break
    same = ([(r.rid, r.output, r.done_s) for r in replica.eng.completed]
            == [(r.rid, r.output, r.done_s) for r in bare.completed]
            and len(bare.completed) == 10)
    steps_same = replica.eng.step_count - probe_steps == bare.step_count
    log(f"[fleet ref] smoke f32, one replica on the card vs the bare engine on the card: "
        f"tokens, done_s and completion order identical {same}, step counts "
        f"({bare.step_count}) identical {steps_same}; spawn {spawn_line(replica)}")
    if not (same and steps_same):
        raise AssertionError("a one-replica fleet on the card differs from the bare engine")

    completed = {}
    for i, where in enumerate(("cpu", dev.type)):
        built = []

        def make_backend(*, on_step, audit_path, where=where, built=built):
            pool = ReplicaPool(build_model(cfg, device=where), mgr, serve_cfg)
            reqs = fleet_requests(cfg.vocab, 10, arrival=lambda i: float(i // 2),
                                  decode=lambda i: 4 + i % 3, seed=21)
            be = FleetBackend(pool, reqs, sla_s=60.0, horizon_s=8.0, policy=_Hold(),
                              starting_replicas=2, max_replicas=3, adapt_period_s=2.0,
                              app_window_s=4.0, decode_steps=2, calibrate=False,
                              on_step=on_step, audit_path=audit_path)
            built.append(be)
            return be

        drill = ChaosDrill("kill-under-load", make_backend,
                           ChaosScript([ChaosAction(3.0, "kill", count=1)], seed=5),
                           audit_path=os.path.join(ckpt_dir, f"drill-{i}-{where}.jsonl"))
        report = drill.run()
        completed[where] = {r.rid: r.output for r in built[-1].completed}
        log(f"[fleet ref] {where}: {report.summary()}; fired {report.fired}")
        if not (report.ok and report.fired and report.n_completed == 10):
            raise AssertionError(f"the kill-under-load drill failed on {where}")
    same = completed["cpu"] == completed[dev.type]
    log(f"[fleet ref] kill-under-load drill, card vs CPU: completed tokens identical {same}")
    if not same:
        raise AssertionError("the drill's tokens on the card differ from the CPU's")


def fleet_path(dev, counters, ckpt_dir: str, phase5_tokens: dict) -> dict:
    """Phase 8b: smollm-135m at full width in bf16, seeded weights saved
    through the port's CheckpointManager, replicas of
    ``ServeConfig(max_batch=8, max_len=1024)`` sharing the card.
    (i) scale-up and healing: FleetBackend under the target policy, 1 to 3
    replicas, over a bursty stream; a ChaosScript kills one replica once at
    least two serve.  (ii) drain: two replicas take phase 5's requests, one
    is drained mid-flight, and the tokens equal an undrained run's bit for
    bit.  Returns each run's launches."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.chaos import (
        ChaosAction, ChaosScript, check_exactly_once, check_kv_conservation)
    from repro_torch.core.scaling import CapacityPlan, UnitPool
    from repro_torch.data import request_stream
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeConfig
    from repro_torch.serving.fleet import (
        FLEET_POOL, FleetBackend, FleetExecutor, FleetRouter, ReplicaPool)

    cfg = get_config("smollm-135m")
    model = build_model(cfg, device=dev)
    mgr = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    mgr.save(model.init_params(SEED), step=1)
    mgr.wait()
    log(f"[fleet] {cfg.name} bf16 checkpoint ({os.path.getsize(mgr.latest()) / 2**20:.1f} MiB)"
        f" written in {time.perf_counter() - t0:.3f} s")
    serve_cfg = ServeConfig(max_batch=8, max_len=1024)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    V = cfg.vocab
    failures = []

    # (i) scale-up and healing under the target policy
    stream = request_stream(n_requests=48, seed=SEED, mean_prompt=128, mean_decode=32,
                            burst_times=(10.0,), horizon_s=30.0)
    reqs = [Request(rid=i, arrival_s=t,
                    prompt=np.random.default_rng(i).integers(0, V, min(p, 512)).astype(np.int32),
                    max_new_tokens=max(min(d, 256), 1))
            for i, (t, p, d) in enumerate(stream)]
    chaos = {}

    def kill_when_two_serve(be, t):
        if "script" not in chaos and len(be.pool.serving) >= 2:
            chaos["script"] = ChaosScript([ChaosAction(t, "kill", count=1)], seed=SEED)
            chaos["spawned_before"] = be.pool._next_rix
        if "script" in chaos:
            chaos["script"].on_step(be, t)

    pool = ReplicaPool(model, mgr, serve_cfg)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    be = FleetBackend(pool, reqs, sla_s=20.0, horizon_s=30.0, starting_replicas=1,
                      max_replicas=3, on_step=kill_when_two_serve)
    rep = be.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    replicas = pool.serving + pool.retired
    tokens = sum(len(r.output) for r in be.completed)
    measured = rep.pool_provision_delay_s.get(FLEET_POOL, 0.0)
    fired = chaos["script"].fired if "script" in chaos else []
    respawned = "script" in chaos and pool._next_rix > chaos["spawned_before"]
    log(f"[fleet] (i) target policy, 1..3 replicas: {rep.n_done}/{len(reqs)} completed, "
        f"{tokens} tokens in {wall:.3f} s wall ({tokens / wall:.1f} tok/s aggregate, spawns "
        f"included); SLA({rep.sla_s:.0f}s) violations {100 * rep.violation_rate:.2f}%; "
        f"replicas peak {rep.max_units}/3, units_t {rep.units_t.tolist()} (virtual s); "
        f"{rep.n_decisions_up} up / {rep.n_decisions_down} down; measured provisioning "
        f"delay {measured:.3f} s; migrated backlog peak {rep.extra['migrated_backlog_peak']}; "
        f"kill {fired}, respawned after it {respawned}; launches {launches}")
    for r in replicas:
        state = "serving" if r in pool.serving else ("drained" if r.draining else "retired")
        log(f"[fleet]   spawn {spawn_line(r)}; {state}; {r.tokens} tokens in {r.busy_s:.3f} s "
            f"busy = {r.tokens_per_busy_s:.1f} tok/busy-s")
    log(f"[fleet] peak memory {peak_mib:.0f} MiB with {len(replicas)} engines resident "
        f"(retired engines keep their KV pools and params; {base_mib:.0f} MiB before the "
        f"fleet); replicas share one card and one host thread, so the wall-clock "
        f"aggregate is not expected to scale with the replica count")
    violations = (check_exactly_once([r.rid for r in reqs], be.completed)
                  + check_kv_conservation(pool, drained=True))
    if violations:
        failures.append(f"(i) invariants: {[str(v) for v in violations]}")
    if not (rep.n_done == len(reqs) and measured > 0.0 and rep.max_units >= 2
            and fired and respawned and all(v > 0 for v in launches.values())):
        failures.append("(i): incomplete requests, no measured delay, fewer than two "
                        "replicas, no kill or respawn, or a kernel that never launched")
    launches_i = launches

    # (ii) drain under load: the same fleet drained and undrained
    runs = {}
    for drained in (False, True):
        pool = ReplicaPool(model, mgr, serve_cfg)
        for _ in range(2):
            r, _ = pool.spawn()
            pool.serving.append(r)
        executor = FleetExecutor(pool, CapacityPlan(
            (UnitPool(FLEET_POOL, min_units=1, max_units=2),), starting_units=2))
        router = FleetRouter(pool)
        reqs = main_requests(V)
        for r in reqs:
            router.submit(r)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        moved = 0
        for t in range(100_000):
            if drained and t == 4:             # the executor drains the newest
                victim = pool.serving[-1]
                moved = sum(victim.eng.pos[s] > 0 for s in victim.eng.active)
                in_flight = len(victim.eng.active)
                if executor.drain(FLEET_POOL, 1, float(t)) != 1 or victim in pool.serving:
                    raise AssertionError("the executor did not drain the newest replica")
            router.dispatch(float(t))
            for r in pool.serving:
                r.step(float(t), decode_steps=2)
            if not router.backlog and not any(r.eng.n_in_system for r in pool.serving):
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        done = [q for r in pool.serving + pool.retired for q in r.eng.completed]
        violations = (check_exactly_once([q.rid for q in reqs], done)
                      + check_kv_conservation(pool, drained=True))
        emitted = sum(len(q.output) for q in done)
        runs[drained] = {q.rid: q.output for q in done}
        what = (f"drained replica{pool.retired[0].rix} at t=4 with {in_flight} in flight, "
                f"{moved} of them with committed KV migrated" if drained else "undrained")
        log(f"[fleet] (ii) 2 replicas, phase 5's {len(reqs)} requests, {what}: {len(done)} "
            f"completed, {emitted} tokens in {wall:.3f} s ({emitted / wall:.1f} tok/s), "
            f"{t + 1} fleet steps; launches {launches}")
        if violations:
            failures.append(f"(ii) {what} invariants: {[str(v) for v in violations]}")
        if not all(v > 0 for v in launches.values()):
            failures.append(f"(ii) {what}: a kernel never launched")
        if drained and not moved:
            failures.append("(ii): the drain migrated no committed KV")
    same = runs[True] == runs[False] and len(runs[True]) == 16
    like5 = sum(runs[False][rid] == toks for rid, toks in phase5_tokens.items())
    log(f"[fleet] (ii) drained vs undrained tokens bit-identical {same}; {like5}/16 requests "
        f"emit phase 5's single-engine tokens (printed, not gated)")
    if not same:
        failures.append("(ii): the drained run's tokens differ from the undrained run's")
    log(f"[fleet] peak memory over phase 8b {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if failures:
        raise AssertionError("fleet phase failed: " + "; ".join(failures))
    return {"scale-up": launches_i, "drain": launches}


# ---------------------------------------------------------------------------------
# phase 9: the moe and vlm families, smollm-360m and the autotune sweeps
# ---------------------------------------------------------------------------------

class moe_drops:
    """Counts the (token, expert) pairs the MoE layers drop, on the device
    (no host sync per layer): ``calls`` MoE layers ran over ``pairs`` pairs;
    :meth:`dropped` sums the drops once, at the end."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._plain = moe, moe.dispatch
        self.calls, self.pairs, self._drops = 0, 0, []

        def counting(experts, C, n_experts):
            plan = self._plain(experts, C, n_experts)
            self.calls += 1
            self.pairs += experts.numel()
            self._drops.append((~plan[3]).sum())
            return plan

        moe.dispatch = counting
        return self

    def __exit__(self, *exc):
        self._moe.dispatch = self._plain

    def dropped(self) -> int:
        import torch
        return int(torch.stack(self._drops).sum()) if self._drops else 0


class no_plain:
    """Counts calls of the main-path kernels' plain versions while it is
    entered (each wrapper would call its plain version only for CPU
    tensors); ``calls`` must stay 0 on the card."""
    NAMES = (("repro_torch.kernels.decode_attention.ops",
              ("paged_mixed_attention_plain", "paged_decode_attention_plain")),
             ("repro_torch.kernels.sampling.ops",
              ("lmhead_greedy_plain", "greedy_epilogue_plain")),
             ("repro_torch.kernels.flash_attention.ops", ("flash_attention_plain",)))

    def __enter__(self):
        import importlib
        self.calls = 0
        self._saved = []
        for mod_name, names in self.NAMES:
            mod = importlib.import_module(mod_name)
            for name in names:
                plain = getattr(mod, name)

                def counted(*a, _plain=plain, **kw):
                    self.calls += 1
                    return _plain(*a, **kw)

                self._saved.append((mod, name, plain))
                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, plain in self._saved:
            setattr(mod, name, plain)


def family_references(dev) -> None:
    """Phase 9a, float32 references: olmoe-smoke and mixtral-smoke at the
    published capacity factor 1.25 through the engine on the chunked and
    the bucketed paths, on the card (kernels) and on the CPU (plain
    versions): identical tokens, completion order and step counts, scores
    within 1e-4; the dropped pairs are printed.  pixtral-smoke ``forward``,
    ``prefill`` and a ``decode_step`` from embeddings, card against CPU
    within 1e-4."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.common import MoEConfig
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    for arch in ("olmoe-1b-7b", "mixtral-8x22b"):
        base = get_smoke_config(arch)
        m = base.moe
        cfg = dataclasses.replace(base, dtype=torch.float32,
                                  moe=MoEConfig(m.n_experts, m.top_k, m.d_expert, 1.25))
        cpu_params = build_model(cfg, device="cpu").init_params(SEED)
        for chunked in (True, False):
            runs = {}
            for where in ("cpu", "cuda"):
                kw = dict(max_batch=4, max_len=64, page_size=8, chunked_prefill=chunked)
                if chunked:
                    kw.update(chunk_size=8, draft_len=4)
                eng = ServingEngine(build_model(cfg, device=where), to_device(cpu_params, where),
                                    ServeConfig(**kw), device=where)
                rng = np.random.default_rng(SEED)
                for i in range(6):
                    eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                                                  int(rng.integers(4, 30))),
                                       max_new_tokens=int(rng.integers(4, 16))))
                with moe_drops() as drops:
                    eng.run_until_drained()
                eng.kv.check_invariants()
                runs[where] = ([(r.rid, r.output) for r in eng.completed], eng.step_count,
                               {r.rid: r.score for r in eng.completed}, drops.dropped(),
                               drops.pairs)
            same = runs["cpu"][:2] == runs["cuda"][:2]
            dscore = max(abs(runs["cpu"][2][r] - runs["cuda"][2][r]) for r in runs["cpu"][2])
            log(f"[reference] {cfg.name} f32 capacity factor 1.25 "
                f"{'chunked' if chunked else 'bucketed'} engine, card vs CPU: tokens, completion "
                f"order and step count ({runs['cuda'][1]}) identical {same}, max |score diff| "
                f"{dscore:.2e}; dropped pairs {runs['cuda'][3]} of {runs['cuda'][4]} on the "
                f"card, {runs['cpu'][3]} on the CPU")
            if not (same and len(runs["cuda"][0]) == 6 and dscore < 1e-4):
                raise AssertionError(f"the {arch} engine on the card disagrees with the CPU")

    cfg = dataclasses.replace(get_smoke_config("pixtral-12b"), dtype=torch.float32)
    params = build_model(cfg, device="cpu").init_params(SEED)
    rng = np.random.default_rng(SEED + 30)
    embeds = torch.from_numpy(rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32))
    step = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    outs = {}
    for where in ("cpu", "cuda"):
        model = build_model(cfg, device=where)
        p = to_device(params, where)
        logits, _ = model.forward(p, {"embeds": embeds.to(where)})
        last, cache = model.prefill(p, {"embeds": embeds.to(where)}, max_len=48)
        dec, _ = model.decode_step(p, cache, step.to(where), 37)
        outs[where] = [t.cpu() for t in (logits, last, dec)]
    err = max((a - b).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    log(f"[reference] pixtral-smoke f32 forward, prefill and decode_step from embeddings, card "
        f"vs CPU: max |logit diff| {err:.2e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("pixtral-smoke from embeddings on the card disagrees with the CPU")


def moe_profile(dev, model, params) -> None:
    """Phase 9b's profiled window: :func:`profile_window` on the olmoe
    engine, with each MoE layer and its dispatch plan under
    ``record_function`` ranges, then the device time of the expert ``bmm``s
    and of the rest of the MoE layers (router, sort, dispatch, combine) as
    shares of the device's busy time."""
    import torch
    from repro_torch.models import lm, moe

    plain_ffn, plain_dispatch = lm.moe_ffn, moe.dispatch

    def ffn(*a, **kw):
        with torch.profiler.record_function("moe_ffn"):
            return plain_ffn(*a, **kw)

    def dispatch(*a, **kw):
        with torch.profiler.record_function("moe_dispatch"):
            return plain_dispatch(*a, **kw)

    lm.moe_ffn, moe.dispatch = ffn, dispatch
    try:
        profile_window(dev, model, params, tag="[profile olmoe]",
                       shares=(("MoE layers", "moe_ffn"), ("expert bmm", "aten::bmm"),
                               ("sort-based dispatch plan", "moe_dispatch")))
    finally:
        lm.moe_ffn, moe.dispatch = plain_ffn, plain_dispatch


def olmoe_path(dev, counters, bucketed_counters) -> dict:
    """Phase 9b: olmoe-1b-7b ``CONFIG`` at bf16, full width and depth, seeded
    random weights; phase 5's 16 requests on the chunked path, then on the
    bucketed path (``ServeConfig(max_batch=8, max_len=1024)``).  Every
    request completes, pages are conserved, the main-path kernels launch
    (paged mixed attention 16 times and the lm-head once per verify_step)
    and no plain version runs; peak memory is printed.  A second chunked
    drain must give the same tokens; it counts the dropped pairs, so the
    first drain's throughput is taken without the counter.  The bucketed
    drain counts its drops with the counter on (one reduction a MoE layer
    inside its timed window).  Then a profiled window and the ``appdata``
    scaling loop.  Returns the launches of both paths."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("olmoe-1b-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"[olmoe] {cfg.name} bf16: {cfg.n_layers} layers, d={cfg.d_model}, {cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k} of d_expert {cfg.moe.d_expert}, capacity factor "
        f"{cfg.moe.capacity_factor}; {weights_gb:.2f} GB of weights drawn in "
        f"{time.perf_counter() - t0:.1f} s; reduced: none")
    with no_plain() as plain:
        launches, tokens = main_path(dev, model, params, counters)
    verifies = launches["fused_lmhead_greedy"]
    per_step_ok = launches["decode_attention_mixed"] == cfg.n_layers * verifies
    log(f"[olmoe] chunked (no drop counter): {verifies} verify_steps, paged mixed attention "
        f"{launches['decode_attention_mixed']} launches ({cfg.n_layers} a verify_step: "
        f"{per_step_ok}), lm-head {verifies} (1 a verify_step); plain-version calls "
        f"{plain.calls}")
    if not (per_step_ok and plain.calls == 0):
        raise AssertionError("olmoe chunked path: a launch count off one per layer per "
                             "verify_step, or a plain version ran on the card")
    # the combine's fixed order and the trash page's last-writer rule make a
    # second drain of the same requests give the same bits
    with moe_drops() as drops:
        _, again = main_path(dev, model, params, counters)
    log(f"[olmoe] a second chunked drain of the same requests (drop counter on): tokens "
        f"identical {again == tokens}; dropped pairs {drops.dropped()} of {drops.pairs} "
        f"({drops.dropped() / max(verifies, 1):.1f} a verify_step, "
        f"{100 * drops.dropped() / max(drops.pairs, 1):.2f}%)")
    if again != tokens:
        raise AssertionError("olmoe chunked path: two runs of the bf16 engine differ")
    with no_plain() as plain, moe_drops() as drops:
        b_launches = bucketed_path(dev, model, params, bucketed_counters, tokens)
    log(f"[olmoe] bucketed (drop counter on): plain-version calls {plain.calls}; dropped "
        f"pairs {drops.dropped()} of {drops.pairs} over {drops.calls} MoE layer calls; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB (the paths batch tokens "
        f"differently and MoE routing depends on the batch: their agreement is not gated)")
    if plain.calls:
        raise AssertionError("olmoe bucketed path: a plain version ran on the card")
    moe_profile(dev, model, params)
    scaling_loop(dev, model, params, counters, tag="[scaling olmoe]")
    return {"chunked": launches, "bucketed": b_launches}


def paged_pool(cfg, dev, B: int, n: int, ps: int = 16):
    """An empty paged pool of ``B * n + 1`` pages in cfg.dtype and a table
    giving row b the pages ``1 + b * n .. (b + 1) * n``."""
    import torch
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (L, B * n + 1, ps, Hkv, hd)
    pages = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    tbl = torch.arange(1, B * n + 1, dtype=torch.int32, device=dev).reshape(B, n)
    return pages, tbl


def family_paths(dev, counters) -> dict:
    """Phase 9c: the other new configs at full width on the card.
    mixtral-8x22b at 2 of its 56 layers: ``prefill`` of 4 x 512 tokens, then
    8 ``verify_step``s of 16 tokens over a paged pool at positions 512 ..
    639 (its 4096-token window passed to the kernel).  pixtral-12b at full
    depth: ``prefill`` from (2, 256, 5120) embeddings, 4 ``decode_step``s
    from (2, 1, 5120) embeddings and 4 from tokens over a paged pool, then 2
    ``verify_step``s.  smollm-360m through the engine on phase 5's requests
    (chunked).  Each model is freed before the next is built; each run's
    cuts are printed beside it.  Returns launches per config."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.kvcache import write_prefill_pages

    out = {}
    ps = 16

    def zero():
        for c in counters:
            c.launches = 0

    def launched():
        return {c.__name__: c.launches for c in counters}

    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, n_layers=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init_params(SEED)
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    B, S, T, steps = 4, 512, 16, 8
    toks = torch.from_numpy(np.random.default_rng(SEED + 31).integers(
        0, cfg.vocab, (B, S))).to(dev)
    zero()
    with no_plain() as plain, moe_drops() as drops:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pages, tbl = paged_pool(cfg, dev, B, (S + steps * T) // ps)
        write_prefill_pages(pages, cache, tbl[:, :S // ps])
        del cache
        span = torch.cat([logits[:, 0].argmax(-1, keepdim=True),
                          torch.from_numpy(np.random.default_rng(SEED + 32).integers(
                              0, cfg.vocab, (B, T - 1))).to(dev)], dim=1)
        finite = bool(torch.isfinite(logits).all())
        t0 = time.perf_counter()
        for i in range(steps):
            pos = torch.full((B,), S + i * T, dtype=torch.int32, device=dev)
            tok, lp, pages = model.verify_step(params, pages, span, pos, block_table=tbl)
            finite = finite and bool(torch.isfinite(lp).all() and (lp <= 0).all())
            span = tok.long()
        torch.cuda.synchronize()
        verify_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = launched()
    ok = (finite and plain.calls == 0 and launches["flash_attention_dyn"] == cfg.n_layers
          and launches["decode_attention_mixed"] == cfg.n_layers * steps
          and launches["fused_lmhead_greedy"] == steps
          and bool(((span >= 0) & (span < cfg.vocab)).all()))
    log(f"[mixtral] {cfg.name} bf16 at full width (d={cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, window {cfg.window}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_expert {cfg.moe.d_expert}); "
        f"reduced: n_layers {full.n_layers} -> {cfg.n_layers} (the full model's 140.6 B "
        f"parameters do not fit one 80 GB card); {weights_gb:.2f} GB of weights")
    log(f"[mixtral] prefill of {B} x {S} tokens {prefill_ms:.1f} ms (cold); {steps} "
        f"verify_steps of {T} tokens at positions {S} .. {S + steps * T - 1}, "
        f"{verify_ms:.2f} ms each; launches {launches}; plain-version calls {plain.calls}; "
        f"dropped pairs {drops.dropped()} of {drops.pairs}; finite {finite}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not ok:
        raise AssertionError("mixtral-8x22b at full width failed: non-finite outputs, a "
                             "plain version, or launch counts off one per layer per call")
    out["mixtral-8x22b"] = launches
    del model, params, pages, logits
    torch.cuda.empty_cache()

    cfg = get_config("pixtral-12b")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init_params(SEED)
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    B, S, T = 2, 256, 16
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    embeds = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    step_embeds = torch.randn((8, B, 1, cfg.d_model), generator=g, device=dev)
    zero()
    with no_plain() as plain:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"embeds": embeds})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pages, tbl = paged_pool(cfg, dev, B, (S + 8 + 2 * T) // ps)
        write_prefill_pages(pages, cache, tbl[:, :S // ps])
        del cache
        finite = bool(torch.isfinite(logits).all())
        tok = logits[:, 0].argmax(-1)
        t0 = time.perf_counter()
        for i in range(8):
            x = step_embeds[i] if i < 4 else tok[:, None]
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, pages = model.decode_step(params, pages, x, pos, block_table=tbl)
            finite = finite and bool(torch.isfinite(logits).all())
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / 8
        span = torch.cat([tok[:, None], tok[:, None].expand(B, T - 1)], dim=1)
        for i in range(2):
            pos = torch.full((B,), S + 8 + i * T, dtype=torch.int32, device=dev)
            tok_v, lp, pages = model.verify_step(params, pages, span, pos, block_table=tbl)
            finite = finite and bool(torch.isfinite(lp).all() and (lp <= 0).all())
            span = tok_v.long()
    launches = launched()
    L = cfg.n_layers
    ok = (finite and plain.calls == 0 and launches["flash_attention_dyn"] == L
          and launches["decode_attention_paged"] == 8 * L
          and launches["decode_attention_mixed"] == 2 * L
          and launches["fused_lmhead_greedy"] == 2)
    log(f"[pixtral] {cfg.name} bf16 at full width and depth ({L} layers, d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, input mode "
        f"{cfg.input_mode}); reduced: none (the vision encoder is the config's stub: "
        f"embeddings come in); {weights_gb:.2f} GB of weights")
    log(f"[pixtral] prefill from ({B}, {S}, {cfg.d_model}) embeddings {prefill_ms:.1f} ms "
        f"(cold); 8 decode_steps (4 from embeddings, 4 from tokens) {decode_ms:.2f} ms each; "
        f"2 verify_steps of {T}; launches {launches}; plain-version calls {plain.calls}; "
        f"finite {finite}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not ok:
        raise AssertionError("pixtral-12b at full width failed: non-finite outputs, a "
                             "plain version, or launch counts off one per layer per call")
    out["pixtral-12b"] = launches
    del model, params, pages, logits
    torch.cuda.empty_cache()

    cfg = get_config("smollm-360m")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init_params(SEED)
    log(f"[smollm-360m] {cfg.name} bf16 at full width and depth through the engine; "
        f"reduced: none")
    with no_plain() as plain:
        launches, _ = main_path(dev, model, params,
                                [c for c in counters if c.__name__ in
                                 ("decode_attention_mixed", "fused_lmhead_greedy")])
    if plain.calls:
        raise AssertionError("smollm-360m: a plain version ran on the card")
    out["smollm-360m"] = launches
    del model, params
    torch.cuda.empty_cache()
    return out


def autotune_sweeps(dev) -> None:
    """Phase 9d: ``sweep_page_size`` (8, 16, 32, 64) and ``sweep_span_width``
    (1 .. 32) at smollm-135m's and olmoe-1b-7b's attention heads (8 rows
    of 1024 keys, bf16), and the row ``pick_defaults`` would choose.  The
    run does not apply it: ``DEFAULTS["cuda"]`` must be unchanged."""
    from repro_torch.kernels.decode_attention import autotune

    for arch, (Hq, Hkv, D) in (("smollm-135m", (9, 3, 64)), ("olmoe-1b-7b", OLMOE_HEADS)):
        shape = dict(total_tokens=1024, B=8, Hq=Hq, Hkv=Hkv, D=D, reps=20, device=dev)
        page_rows = autotune.sweep_page_size(SWEEP_PAGE_SIZES, **shape)
        span_rows = autotune.sweep_span_width((1, 2, 4, 8, 16, 32), **shape)
        log(f"[autotune] {arch} ({Hq}/{Hkv} heads of {D}, 8 rows of 1024 keys) page size: "
            + "; ".join(f"{r['page_size']}: {r['us_per_step']:.2f} us" for r in page_rows))
        log(f"[autotune] {arch} span width: "
            + "; ".join(f"{r['span_width']}: {r['us_per_step']:.2f} us "
                        f"({r['us_per_token']:.3f} us a token)" for r in span_rows))
        log(f"[autotune] {arch} pick_defaults would choose "
            f"{json.dumps(autotune.pick_defaults(page_rows, span_rows=span_rows))} "
            f"(not applied)")
    unchanged = autotune.DEFAULTS["cuda"] == {"page_size": 16, "chunk_size": 16,
                                              "draft_len": 3, "lmhead_block_v": 128}
    log(f"[autotune] DEFAULTS['cuda'] {json.dumps(autotune.DEFAULTS['cuda'])}, unchanged "
        f"{unchanged}")
    if not unchanged:
        raise AssertionError("the sweep changed DEFAULTS['cuda']")


# ---------------------------------------------------------------------------------
# phase 10: training on the card
# ---------------------------------------------------------------------------------

# the tolerances of phase 10a, card against CPU at float32 (f32 sums in other
# orders than the CPU's): the loss (relative), each gradient leaf (absolute,
# over the leaf's largest magnitude) and each loss of the 5-step curve (relative)
REF_LOSS_TOL, REF_GRAD_TOL, REF_CURVE_TOL = 1e-5, 1e-4, 1e-4
RESUME_TOL = 2e-2               # phase 10b: |loss difference| of the resumed run


def train_batches(cfg, n: int, B: int, S: int, seed: int):
    """``n`` batches of the TokenStream (vocab, S, B, seed) as CPU tensors,
    with seeded (B, enc_len, d) frame embeddings for the audio family."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, TokenStream
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        if cfg.family == "audio":
            b["enc_embeds"] = torch.from_numpy(
                rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32))
        out.append(b)
    return out


def no_launch_during(counters, what: str, fn):
    """``fn()``, failing if any kernel's launch counter moved meanwhile."""
    before = {c.__name__: c.launches for c in counters}
    out = fn()
    moved = {k: c.launches - before[k] for c, k in zip(counters, before)
             if c.launches != before[k]}
    if moved:
        raise AssertionError(f"{what}: kernels launched during a train step: {moved}")
    return out


def train_references(dev, counters) -> None:
    """Phase 10a: the smoke configs of smollm-135m, mamba2-1.3b and
    whisper-small at float32 with ``remat="block"``, seeded weights: one
    ``loss_and_grads`` on the card against the CPU (the loss, every
    gradient leaf over its largest magnitude), then 5 train steps each
    (every loss), within ``REF_*_TOL``."""
    import dataclasses

    import torch
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.training.train_step import loss_and_grads

    failures = []
    for arch in ("smollm-135m", "mamba2-1.3b", "whisper-small"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32, remat="block")
        params = build_model(cfg, device="cpu").init_params(SEED)
        batches = train_batches(cfg, 5, 4, 64, SEED + 20)
        opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5)
        out = []
        for where in ("cpu", dev):
            model = build_model(cfg, device=where)
            p = to_device(params, where)

            def run():
                loss, _, g = loss_and_grads(model.loss_fn, p,
                                            {k: v.to(where) for k, v in batches[0].items()})
                step = make_train_step(model, opt)
                q, o, losses = p, adamw_init(p), []
                for b in batches:
                    q, o, met = step(q, o, b)
                    losses.append(float(met["loss"]))
                return float(loss), {k: t.cpu() for k, t in _flatten(g).items()}, losses

            out.append(no_launch_during(counters, f"10a {arch}", run))
        (l_cpu, g_cpu, c_cpu), (l_gpu, g_gpu, c_gpu) = out
        g_err = max(float((g_gpu[k] - r).abs().max()) / max(float(r.abs().max()), 1e-6)
                    for k, r in g_cpu.items())
        l_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        c_err = max(abs(a - b) / abs(b) for a, b in zip(c_gpu, c_cpu))
        ok = l_err <= REF_LOSS_TOL and g_err <= REF_GRAD_TOL and c_err <= REF_CURVE_TOL
        log(f"[train ref] {cfg.name} f32: loss card {l_gpu:.6f} cpu {l_cpu:.6f} (rel {l_err:.2e}, "
            f"tol {REF_LOSS_TOL}); {len(g_cpu)} gradient leaves, worst scaled error {g_err:.2e} "
            f"(tol {REF_GRAD_TOL}); 5-step curve card {[round(x, 5) for x in c_gpu]} worst rel "
            f"{c_err:.2e} (tol {REF_CURVE_TOL}): {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append(arch)
    if failures:
        raise AssertionError(f"training references failed: {failures}")


def step_stats(cfg, B: int, S: int, ms: float) -> str:
    n = cfg.param_count()
    tokens = B * S
    share = 6 * n * tokens / (ms * 1e-3) / BF16_FLOPS_PER_S
    return (f"{ms:.1f} ms/step, {tokens / (ms * 1e-3):.0f} tokens/s, 6ND share "
            f"{100 * share:.1f}% of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s (N {n / 1e6:.1f} M)")


def step_split(model, params, opt, batch, opt_cfg) -> tuple[float, float]:
    """Host ms of one train step's gradient pass (``loss_and_grads``) and
    of its AdamW update (in place), each between two synchronisations."""
    import torch
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.training.train_step import loss_and_grads
    batch = {k: v.to(model.device) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(model.loss_fn, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(params, grads, opt, opt_cfg, donate=True)
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def profile_train_step(tag: str, fn, step_ms: float) -> None:
    """One call of ``fn`` (a train step) under torch.profiler: the kernels
    launched, the device busy time (summed kernel time) as a share of the
    unprofiled ``step_ms``, and the kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f"{tag} the profiler reported no device time: not measured")
        return
    busy_ms = sum(r[0] for r in rows)
    log(f"{tag} one profiled step: {sum(r[1] for r in rows)} kernels, device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / step_ms:.1f}% of the {step_ms:.1f} ms "
        f"unprofiled step")
    for dev_ms, count, key in sorted(rows, reverse=True)[:10]:
        log(f"{tag}   {dev_ms:9.3f} ms {100 * dev_ms / busy_ms:5.1f}%  x{count:<6d} {key[:80]}")


def train_full(dev, counters, ckpt_dir: str) -> None:
    """Phase 10b: smollm-135m ``CONFIG`` (bf16, remat "block") trained on
    the TokenStream at B 8 x S 512 for 30 steps (AdamW, lr 1e-3, cosine
    over 30, warm-up 5), a train-state checkpoint after step 15; then, in
    the same process, the state restored from that file and steps 15-29
    trained again.  Both runs use deterministic index backwards
    (``torch.use_deterministic_algorithms``), so the resumed run can repeat
    the first one's bits.  Gates: no kernel launch in any step; every
    resumed loss within ``RESUME_TOL`` of the uninterrupted run's (whether
    they are bit-identical is printed); the mean of the last 5 losses below
    the first 5's.  Prints ms per step (of 7 plain steps after the runs),
    tokens/s, peak memory, the 6ND share, a step split into its gradient
    pass and its AdamW update, and one profiled step."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step

    cfg = get_config("smollm-135m")
    B, S, steps, at = 8, 512, 30, 15
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)                                   # on the GPU
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps),
                           donate=True)
    batches = train_batches(cfg, steps, B, S, SEED)
    mgr = CheckpointManager(ckpt_dir, keep=2)

    def run(params, opt, lo):
        losses, times = [], []
        for i in range(lo, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = no_launch_during(counters, "10b",
                                                lambda: step(params, opt, batches[i]))
            losses.append(float(met["loss"]))                  # syncs
            times.append((time.perf_counter() - t0) * 1e3)
            if i + 1 == at and lo == 0:
                mgr.save({"params": params, "opt": opt}, step=at)
        return params, opt, losses, times

    params = model.init_params(SEED)
    # deterministic index backward (the embedding's gradient) so the resumed
    # run can repeat the first one's bits; warn_only: cuBLAS keeps its default
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params, opt, losses, times = run(params, adamw_init(params), 0)
            mgr.wait()
            peak_mib = torch.cuda.max_memory_allocated() / 2**20
            template = {"params": params, "opt": opt}
            t0 = time.perf_counter()
            state, meta = mgr.restore_latest(template)
            restore_s = time.perf_counter() - t0
            del template, params, opt
            params, opt, resumed, _ = run(state["params"], state["opt"], at)
    finally:
        torch.use_deterministic_algorithms(False)
    det_ms = float(np.mean(times[3:]))
    # the speed of a plain step: 8 more steps without the deterministic
    # index backwards, the first of them not counted
    plain = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = no_launch_during(counters, "10b", lambda: step(params, opt, batches[i]))
        float(met["loss"])
        plain.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.mean(plain[1:]))
    diffs = [abs(a - b) for a, b in zip(resumed, losses[at:])]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    ok = meta.get("step") == at and max(diffs) <= RESUME_TOL and last5 < first5
    log(f"[train] {cfg.name} bf16 B {B} x S {S}, {steps} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (mean of first 5 {first5:.4f}, last 5 {last5:.4f}); "
        f"{step_stats(cfg, B, S, ms)} (7 steps after the run; with the deterministic "
        f"index backwards {det_ms:.1f} ms, steps 3-29; first step {times[0]:.0f} ms); "
        f"peak memory {peak_mib:.0f} MiB")
    log(f"[train] resumed from the step-{at} checkpoint (restore {restore_s:.1f} s): "
        f"steps {at}-{steps - 1} losses {[round(x, 4) for x in resumed]}; first equal "
        f"{resumed[0] == losses[at]}, max |difference| {max(diffs):.2e} (tol {RESUME_TOL}), "
        f"bit-identical {diffs == [0.0] * len(diffs)}: {'ok' if ok else 'FAILED'}")
    # where a step's time goes, outside the gated runs and without the
    # deterministic index backwards
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    split = [step_split(model, params, opt, batches[i], opt_cfg) for i in range(3)]
    grad_ms, opt_ms = (float(np.median([x[j] for x in split])) for j in (0, 1))
    log(f"[train] {cfg.name} a step split: gradient pass {grad_ms:.1f} ms, AdamW update "
        f"{opt_ms:.1f} ms ({len(_leaves(params))} leaves)")
    profile_train_step("[train profile]", lambda: step(params, opt, batches[0]),
                       grad_ms + opt_ms)
    if not ok:
        raise AssertionError("smollm-135m training failed: the loss did not fall, or the "
                             "resumed run did not repeat the uninterrupted one")


def train_wide(dev, counters) -> None:
    """Phase 10c: qwen2.5-3b ``CONFIG`` (bf16) for 3 steps at B 4 x S 512
    and mamba2-1.3b ``CONFIG`` for 2 steps at B 2 x S 512, parameters and
    optimizer state updated in place; finite losses, no kernel launch.
    Prints ms per step (the steps after the first), peak memory, the 6ND
    share, and one more step split into its gradient pass and its AdamW
    update."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step

    for arch, B, S, n in (("qwen2.5-3b", 4, 512, 3), ("mamba2-1.3b", 2, 512, 2)):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)                               # on the GPU
        # the training CLI's schedule: lr 1e-3 after a 5-step warm-up
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=n),
                               donate=True)
        params = model.init_params(SEED)
        opt = adamw_init(params)
        losses, times = [], []
        for b in train_batches(cfg, n, B, S, SEED + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = no_launch_during(counters, f"10c {arch}",
                                                lambda: step(params, opt, b))
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        ms = sum(times[1:]) / len(times[1:])
        grad_ms, opt_ms = step_split(model, params, opt, b,
                                     AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=n))
        log(f"[train wide] {cfg.name} bf16 B {B} x S {S}, {n} steps: losses "
            f"{[round(x, 4) for x in losses]}; {step_stats(cfg, B, S, ms)} (first step "
            f"{times[0]:.0f} ms); peak memory {peak_mib:.0f} MiB; one more step split: "
            f"gradient pass {grad_ms:.1f} ms, AdamW update {opt_ms:.1f} ms")
        del params, opt, step, model
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{arch}: non-finite training loss {losses}")


def whisper_full(dev, counters) -> None:
    """Phase 10d: whisper-small ``CONFIG`` (bf16) at model level: ``prefill``
    from (2, 1500, 768) seeded frame embeddings and a 32-token prompt, 16
    ``decode_step``s at one scalar position, then one train step at B 2 x
    S 32 against the same audio.  Finite logits and loss, no kernel launch
    (whisper has none).  Prints ms per decode step and peak memory."""
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step

    cfg = get_config("whisper-small")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    rng = np.random.default_rng(SEED + 30)
    B, P, n_dec = 2, 32, 16
    enc = torch.from_numpy(rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P)).astype(np.int32))

    def serve():
        logits, cache = model.prefill(params, {"enc_embeds": enc.to(dev),
                                               "tokens": tokens.to(dev)}, max_len=P + n_dec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [logits[:, 0].argmax(-1)]
        finite = bool(torch.isfinite(logits).all())
        for i in range(n_dec):
            logits, cache = model.decode_step(params, cache, out[-1][:, None], P + i)
            out.append(logits[:, 0].argmax(-1))
        torch.cuda.synchronize()
        finite = finite and bool(torch.isfinite(logits).all())
        return (time.perf_counter() - t0) * 1e3 / n_dec, finite, torch.stack(out, 1)

    no_launch_during(counters, "10d serve", serve)                # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec_ms, finite, out = no_launch_during(counters, "10d serve", serve)
    serve_ms = (time.perf_counter() - t0) * 1e3
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=1),
                           donate=True)
    batch = {"enc_embeds": enc, "tokens": tokens, "targets": tokens}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, met = no_launch_during(counters, "10d train",
                                      lambda: step(params, adamw_init(params), batch))
    loss = float(met["loss"])
    train_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"[whisper] {cfg.name} bf16 ({cfg.n_enc_layers}+{cfg.n_layers} layers, d "
        f"{cfg.d_model}): prefill of {B} x {cfg.enc_len} frames + {P} tokens and {n_dec} "
        f"decode steps in {serve_ms:.1f} ms, {dec_ms:.2f} ms per decode step; tokens "
        f"{out[0].tolist()}; logits finite {finite}; one train step (B {B} x S {P}) "
        f"{train_ms:.0f} ms, loss {loss:.4f}; peak memory {peak_mib:.0f} MiB")
    if not (finite and math.isfinite(loss)):
        raise AssertionError("whisper-small: non-finite logits or loss")



# ---------------------------------------------------------------------------------
# phase 11: the sharded train step on a one-rank NCCL mesh
# ---------------------------------------------------------------------------------

SHARDED_LAYERS = 4              # qwen2.5-3b's 36 layers cut for the train-state file


def sharded_train(dev, counters, tmp: str) -> None:
    """Phase 11: NCCL at world size 1 from a ``file://`` store, a 1x1
    ("data", "model") mesh, and qwen2.5-3b ``CONFIG`` (bf16, full width,
    ``SHARDED_LAYERS`` of its 36 layers) at phase 10c's B 4 x S 512:
    ``shard_params`` and ``train_state_shardings``; 3 steps of
    ``sharded_step`` against 3 plain steps from the same state, in place,
    both with deterministic index backwards (gate: losses, parameters and
    moments equal bit for bit: at one rank every gather and reduction is an
    identity); a train-state checkpoint of the sharded state, then
    ``restore_resharded`` onto the mesh (gate: bit for bit); the parameters
    saved by a ``CheckpointManager`` and restored by its
    ``restore_latest(template, shardings)`` (gate: bit for bit against
    ``restore_resharded`` of the same file);
    ``compress_allreduce_pod`` over the one-rank pod group of a 1x1x1 mesh,
    twice, the second with the first's residual (gate: the reduction equals
    ``dequant(quant(g + e))`` and the residual ``g + e`` minus it, exactly);
    ``measure_provision_delay`` at dp 1, tp 1; then :func:`fake_restore`
    of the parameters onto a (2, 4) mesh.  No kernel launches in a train
    step.  Prints each step's ms, the save, restore and provision seconds,
    the restores' peak device memory, and the phase's.  The process group
    is destroyed in a ``finally``."""
    import dataclasses
    import warnings

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager, restore_resharded, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.elastic.remesh import measure_provision_delay
    from repro_torch.distributed.compression import (
        _dequantize, _quantize, compress_allreduce_pod, init_error_state)
    from repro_torch.distributed.sharding import (
        place, shard_params, sharded_loss_and_grads, sharded_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.training import make_train_step, train_state_shardings

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=SHARDED_LAYERS)
    B, S, n = 4, 512, 3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=0, world_size=1)
    failures = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        model = build_model(cfg)                               # on the GPU
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=n),
                               donate=True)
        batches = train_batches(cfg, n, B, S, SEED + 2)
        p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batches[0])
        host = tree_map(lambda t: t.cpu(), model.init_params(SEED))
        run = sharded_step(step, (p_sh, o_sh, b_sh))

        def train(fn, params, opt, what):
            losses, times = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, met = no_launch_during(counters, what,
                                                    lambda: fn(params, opt, b))
                losses.append(float(met["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            return params, opt, losses, times

        # deterministic index backwards, as in phase 10b, so the two runs
        # can give the same bits
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                params = tree_map(lambda t: t.to(dev, copy=True), host)
                p1, o1, l1, t1 = train(step, params, adamw_init(params), "11 plain")
                params = tree_map(lambda t: t.to(dev, copy=True), host)
                sp = shard_params(params, mesh)
                so = tree_map(place, adamw_init(params), o_sh)
                del params
                sp, so, l2, t2 = train(run, sp, so, "11 sharded")
        finally:
            torch.use_deterministic_algorithms(False)
        same_p = all(torch.equal(a.full_tensor(), b)
                     for a, b in zip(tree_leaves(sp), tree_leaves(p1)))
        same_o = all(torch.equal(a.full_tensor(), b)
                     for a, b in zip(tree_leaves(so), tree_leaves(o1)))
        ok = l1 == l2 and same_p and same_o
        log(f"[sharded] {cfg.name} bf16 ({cfg.n_layers} of 36 layers, d {cfg.d_model}, vocab "
            f"{cfg.vocab}) B {B} x S {S} on a 1x1 NCCL mesh: plain losses {l1}, ms "
            f"{[round(x, 1) for x in t1]}; sharded losses {l2}, ms "
            f"{[round(x, 1) for x in t2]}; losses equal {l1 == l2}, parameters equal "
            f"{same_p}, moments equal {same_o}: {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append("sharded step != plain step")
        del p1, o1

        # a train-state checkpoint, restored onto the mesh
        state = {"params": sp, "opt": so}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "state.npz"),
                               tree_map(lambda t: t.full_tensor().cpu(), state), step=n)
        save_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        restored, meta = restore_resharded(path, state, {"params": p_sh, "opt": o_sh})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_peak = torch.cuda.max_memory_allocated() - base
        same = all(torch.equal(a.full_tensor(), b.full_tensor()) and a.dtype == b.dtype
                   and a.placements == b.placements
                   for a, b in zip(tree_leaves(restored), tree_leaves(state)))
        n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(restored))
        one_copy = restore_peak <= 1.01 * n_bytes + 64 * 2**20
        ok = same and one_copy and meta.get("step") == n
        log(f"[sharded] train-state checkpoint ({n_bytes / 1e9:.2f} GB, "
            f"{len(tree_leaves(state))} leaves): save {save_s:.2f} s, restore_resharded "
            f"{restore_s:.2f} s, equal bit for bit {same}; the restore's peak device memory "
            f"{restore_peak / 2**20:.0f} MiB for {n_bytes / 2**20:.0f} MiB of blocks (one "
            f"copy, within 1% and 64 MiB: {one_copy}): {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append("restore_resharded")
        del restored, state, so
        # the parameters through a CheckpointManager: restore_latest with the
        # mesh's shardings is restore_resharded of its newest file
        mgr = CheckpointManager(os.path.join(tmp, "params"), async_save=False)
        mgr.save(tree_map(lambda t: t.full_tensor(), sp), step=n)
        params_path = mgr.latest()
        t0 = time.perf_counter()
        latest, latest_meta = mgr.restore_latest(sp, p_sh)
        latest_s = time.perf_counter() - t0
        want, want_meta = restore_resharded(params_path, sp, p_sh)
        same = (latest_meta == want_meta and latest_meta.get("step") == n
                and all(torch.equal(a.to_local(), b.to_local()) and a.dtype == b.dtype
                        and a.placements == b.placements
                        for a, b in zip(tree_leaves(latest), tree_leaves(want))))
        log(f"[sharded] CheckpointManager.restore_latest(template, shardings) of the "
            f"parameters ({len(tree_leaves(latest))} leaves, {latest_s:.2f} s) against "
            f"restore_resharded of the same file: bit for bit {same}: "
            f"{'ok' if same else 'FAILED'}")
        if not same:
            failures.append("restore_latest(shardings) != restore_resharded")
        del latest, want

        # int8 compression over the one-rank pod group
        pod_mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        _, grads = sharded_loss_and_grads(step, sp, batches[0], (p_sh, b_sh))
        grads = tree_map(lambda g: g.to_local(), grads)
        err = init_error_state(grads)
        exact = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            red, new_err = compress_allreduce_pod(grads, err, group=pod_mesh.get_group("pod"))
            for g, e, r, ne in zip(*(tree_leaves(t) for t in (grads, err, red, new_err))):
                x = g.float() + e
                d = _dequantize(*_quantize(x))
                exact &= torch.equal(r, d) and torch.equal(ne, x - d)
            err = new_err
        torch.cuda.synchronize()
        comp_ms = (time.perf_counter() - t0) * 1e3 / 2
        log(f"[sharded] compress_allreduce_pod over a one-rank pod group ({len(tree_leaves(grads))} "
            f"leaves): reduction = dequant(quant(g + e)) and exact residuals over two rounds "
            f"{exact}, {comp_ms:.1f} ms a round with the checks: {'ok' if exact else 'FAILED'}")
        if not exact:
            failures.append("compress_allreduce_pod")
        del grads, err, red, new_err

        secs, new_mesh, _ = measure_provision_delay(model, sp, devices=[0], model_parallel=1)
        log(f"[sharded] measure_provision_delay at dp 1, tp 1 (mesh "
            f"{tuple(new_mesh.shape)}): {secs:.3f} s; peak memory over phase 11 "
            f"{max(peak, torch.cuda.max_memory_allocated()) / 2**20:.0f} MiB; card "
            f"{card_line()}")
        if not secs > 0:
            failures.append("provision delay")
        del sp, model
    finally:
        dist.destroy_process_group()
    if not fake_restore(cfg, params_path, n):
        failures.append("restore_resharded onto (2, 4)")
    if failures:
        raise AssertionError("sharded training failed: " + "; ".join(failures))



def fake_restore(cfg, path: str, step: int) -> bool:
    """Phase 11's restore onto a (2, 4) ("data", "model") mesh on the card,
    as rank 6 (coordinate (1, 2)) of 8 under torch's fake backend, which
    moves no data (no other rank runs): ``restore_resharded`` of ``path``
    (``cfg``'s parameters), each local block against the whole leaf's block
    cut on the host, and the restore's peak device memory against the bytes
    of this rank's blocks (gate: within 1% and 64 MiB: the file is read
    into host memory and only the blocks reach the card).  Its own process
    group, destroyed in a ``finally``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.checkpoint import load_checkpoint, restore_resharded
    from repro_torch.distributed import param_sharding
    from repro_torch.models import build_model
    from repro_torch.pytree import tree_leaves

    coord = (1, 2)
    template = build_model(cfg, device="meta").abstract_params()
    torch.cuda.empty_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=6, world_size=8)
    try:
        mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
        sh = param_sharding(template, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tree, meta = restore_resharded(path, template, sh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        ok_coord = tuple(mesh.get_coordinate()) == coord
    finally:
        dist.destroy_process_group()
    ref, _ = load_checkpoint(path, template, device="cpu")
    equal = True
    for t, r, s in zip(tree_leaves(tree), tree_leaves(ref), tree_leaves(sh)):
        want = r
        for mdim, pl in enumerate(s.placements):
            if pl.is_shard():
                k = want.shape[pl.dim] // mesh.size(mdim)
                want = want.narrow(pl.dim, coord[mdim] * k, k)
        equal &= t.dtype == r.dtype and torch.equal(t.to_local().cpu(), want)
    local = sum(t.to_local().numel() * t.element_size() for t in tree_leaves(tree))
    whole = sum(r.numel() * r.element_size() for r in tree_leaves(ref))
    blocks_only = peak <= 1.01 * local + 64 * 2**20
    ok = equal and ok_coord and blocks_only and meta.get("step") == step
    log(f"[sharded] restore_resharded of {cfg.name}'s parameters ({whole / 2**20:.0f} MiB) "
        f"onto a (2, 4) mesh as rank 6 under the fake backend: {secs:.2f} s; blocks equal "
        f"{equal}; peak device memory {peak / 2**20:.0f} MiB for {local / 2**20:.0f} MiB of "
        f"this rank's blocks (within 1% and 64 MiB: {blocks_only}): "
        f"{'ok' if ok else 'FAILED'}")
    return ok


# ---------------------------------------------------------------------------------
# phase 12: the expert-parallel MoE and the dry run
# ---------------------------------------------------------------------------------

EP_CASES = (("olmoe-1b-7b", 4), ("olmoe-1b-7b", 16), ("mixtral-8x22b", 16),
            ("mixtral-8x22b", 4))          # (config, model ranks); EP where E % mp == 0
EP_TOKENS = 4 * 512
EP_F32_TOL = 1e-5               # 12a at f32: the summed partials, over the largest |output|
EP_LAYERS = 4                   # 12b: olmoe-1b-7b's 16 layers cut for the step
EP_HOLD_CYCLES = 100_000_000    # ~50 ms: 12a's host enqueues up to 16 bodies meanwhile
DRYRUN_CELLS = (("olmoe-1b-7b", "train_4k", "both"), ("mixtral-8x22b", "decode_32k", "single"),
                ("mamba2-1.3b", "long_500k", "single"), ("qwen2.5-3b", "prefill_32k", "single"))


def dryrun_start(tmp: str) -> list:
    """Phase 12c's children, one per cell of ``DRYRUN_CELLS``, started at
    once: ``python -m repro_torch.launch.dryrun`` on the host (meta
    tensors, the fake backend: no card), each into its own file."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for i, (arch, shape, mesh) in enumerate(DRYRUN_CELLS):
        out = os.path.join(tmp, f"dryrun-{i}.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", mesh, "--out", out]
        procs.append((subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), out,
                      time.perf_counter()))
    return procs


def dryrun_finish(procs) -> None:
    """Phase 12c: wait for the children (300 s each at most, then killed),
    gate every record on ``status`` ``ok`` and print its per-rank argument
    bytes, FLOPs, collective bytes, fit and dominant roofline term."""
    failures = []
    for proc, out, t0 in procs:
        try:
            text, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failures.append(f"{out}: timed out")
        secs = time.perf_counter() - t0
        recs = [json.loads(line) for line in Path(out).read_text().splitlines()] \
            if os.path.exists(out) else []
        if proc.returncode != 0 or not recs:
            failures.append(f"{out}: exit {proc.returncode}: {text[-1500:]}")
        for r in recs:
            ok = r.get("status") == "ok"
            if not ok:
                failures.append(f"{r['arch']} {r['shape']} {r['mesh']}: {r.get('error')}")
                log(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: {r.get('status')} "
                    f"{r.get('error', '')[:300]}: FAILED")
                continue
            m, c = r["memory"], r["collectives"]
            peak = "n/a" if m["peak_bytes"] is None else f"{m['peak_bytes'] / 1e9:.3f}"
            log(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']} ({r['devices']} fake ranks, "
                f"{r['wall_s']} s; child {secs:.1f} s): argument {m['argument_bytes'] / 1e9:.3f} "
                f"GB, peak {peak} GB, fits {r['fits']}; flops {r['cost']['flops']:.4e}; collective bytes "
                f"{c['total_bytes']:.4e} {c['count_by_kind']}; dominant "
                f"{r['roofline']['dominant']}: ok")
    if failures:
        raise AssertionError("dry run failed: " + "; ".join(failures))


def ep_blocks(params: dict, r: int, mp: int, ep: bool) -> dict:
    """Rank r's contiguous blocks of a whole MoE layer: the expert dim cut
    (EP) or the FFN hidden dim (TP)."""
    E, _, F_ = params["w_gate"].shape
    if ep:
        n = E // mp
        cut = {k: params[k][r * n:(r + 1) * n] for k in ("w_gate", "w_up", "w_down")}
    else:
        n = F_ // mp
        cut = {"w_gate": params["w_gate"][:, :, r * n:(r + 1) * n],
               "w_up": params["w_up"][:, :, r * n:(r + 1) * n],
               "w_down": params["w_down"][:, r * n:(r + 1) * n]}
    return {"router": params["router"], **{k: v.contiguous() for k, v in cut.items()}}


def ep_bodies(dev) -> None:
    """Phase 12a: one MoE layer of each ``EP_CASES`` config at full width
    (``CONFIG``'s widths, capacity factor and top-k), seeded weights whose
    values are bf16-representable, the router float32, ``EP_TOKENS`` tokens;
    every rank's partial (``moe_ep._local_moe`` in EP mode,
    ``_local_moe_tp`` in TP mode) computed in this process, with no
    collective, and summed in rank order in the input's dtype (the
    partials are cast before the sum, as the JAX body casts them before its
    psum).  Gates: at f32, the sum within ``EP_F32_TOL`` of the one-device
    ``moe_ffn``'s largest magnitude; at bf16, the sum's error against the
    f32 layer of the same values within the one-device bf16 layer's error
    plus :func:`bf16_tol` (a TP sum adds up to mp - 1 bf16 roundings; its
    distance to the bf16 layer is printed beside ``bf16_tol``); the dropped
    pairs of every rank's plan equal to the one-device layer's.  Prints the
    device ms of the one-device layer and of the partials' sum, with the
    card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import moe_ep
    from repro_torch.models import moe

    failures = []
    for arch in dict(EP_CASES):
        cfg = get_config(arch).moe
        d, E, F_ = get_config(arch).d_model, cfg.n_experts, cfg.d_expert
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        rn = lambda *s, scale: (torch.randn(s, generator=gen, device=dev) * scale).to(
            torch.bfloat16).float()
        w32 = {"router": rn(d, E, scale=d ** -0.5), "w_gate": rn(E, d, F_, scale=d ** -0.5),
               "w_up": rn(E, d, F_, scale=d ** -0.5), "w_down": rn(E, F_, d, scale=F_ ** -0.5)}
        x32 = rn(EP_TOKENS, d, scale=1.0)
        with torch.no_grad():
            ref32, _ = moe.moe_ffn(x32, w32, cfg)
        scale = ref32.abs().max().item()
        for mp in (m for a, m in EP_CASES if a == arch):
            ep = E % mp == 0
            body = moe_ep._local_moe if ep else moe_ep._local_moe_tp
            for dt in (torch.float32, torch.bfloat16):
                w = {k: v if k == "router" else v.to(dt) for k, v in w32.items()}
                x = x32.to(dt)
                blocks = [ep_blocks(w, r, mp, ep) for r in range(mp)]

                def one():
                    return moe.moe_ffn(x, w, cfg, aux=False)[0]

                def summed():
                    total = None
                    for r in range(mp):
                        out = body(x, blocks[r], cfg, r, mp, aux=False)[0]
                        total = out if total is None else total + out
                    return total

                with torch.no_grad():
                    with moe_drops() as drops_one:
                        ref = one()
                    with moe_drops() as drops_ranks:
                        got = summed()
                    per_rank = [int(n) for n in drops_ranks._drops]
                    n_one = drops_one.dropped()
                    ms_one = timed_ms(one, reps=3, hold=EP_HOLD_CYCLES)
                    ms_sum = timed_ms(summed, reps=3, hold=EP_HOLD_CYCLES)
                err_one = (got.float() - ref.float()).abs().max().item()
                if dt == torch.float32:
                    ok = err_one <= EP_F32_TOL * scale
                    gate = f"{err_one / scale:.2e} of the largest |output| (<= {EP_F32_TOL:g})"
                else:
                    e_sum = (got.float() - ref32).abs().max().item()
                    e_ref = (ref.float() - ref32).abs().max().item()
                    tol = bf16_tol(ref32)
                    ok = e_sum <= e_ref + tol
                    gate = (f"against the f32 layer {e_sum / scale:.2e}, the bf16 layer's "
                            f"{e_ref / scale:.2e} (+ bf16_tol {tol / scale:.0e}); against the "
                            f"bf16 layer {err_one / scale:.2e}")
                ok &= per_rank == [n_one] * mp and torch.isfinite(got).all().item()
                log(f"[moe_ep] {arch} {str(dt).removeprefix('torch.')} mp {mp} "
                    f"{'EP' if ep else 'TP'} ({E // mp if ep else E} experts of hidden "
                    f"{F_ if ep else F_ // mp} a rank), T {EP_TOKENS}: partials summed "
                    f"{gate}; dropped pairs one-device {n_one}, each rank's plan "
                    f"{sorted(set(per_rank))}; device ms one-device {ms_one:.3f}, sum of "
                    f"{mp} partials {ms_sum:.3f}: {'ok' if ok else 'FAILED'}")
                if not ok:
                    failures.append(f"{arch} mp {mp} {dt}")
                del blocks, w, x
        del w32, x32, ref32
        torch.cuda.empty_cache()
    log(f"[moe_ep] card {card_line()}")
    if failures:
        raise AssertionError("expert-parallel bodies failed: " + "; ".join(failures))


def ep_sharded_train(dev, counters, tmp: str) -> None:
    """Phase 12b: NCCL at world size 1 from a ``file://`` store, a 1x1
    ("data", "model") mesh set as the expert-parallel mesh
    (``moe_ep.set_ep_mesh``), and olmoe-1b-7b ``CONFIG`` (bf16, full width,
    ``EP_LAYERS`` of its 16 layers) at B 4 x S 512: 3 ``sharded_step``s,
    the experts kept as the rank's blocks and every MoE layer through
    ``moe_ffn_ep``, against 3 plain steps from the same state, in place,
    both with deterministic index backwards (gate: losses, parameters and
    moments equal bit for bit: at one rank every sum over ``model`` is an
    identity; ``moe_ffn_ep`` ran in every MoE layer of each EP step's
    forward, and again in its recompute under ``remat``).  No
    kernel launches in a train step.  Prints ms a step for both and the
    peak memory.  The EP mesh is unset and the process group destroyed in
    a ``finally``."""
    import dataclasses
    import warnings

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed.sharding import place, shard_params, sharded_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.training import make_train_step, train_state_shardings

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=EP_LAYERS)
    B, S, n = 4, 512, 3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=0, world_size=1)
    plain_ep, calls = moe_ep.moe_ffn_ep, []

    def counted(*a, **kw):
        calls.append(1)
        return plain_ep(*a, **kw)

    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        model = build_model(cfg)                               # on the GPU
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=n),
                               donate=True)
        batches = train_batches(cfg, n, B, S, SEED + 3)
        p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batches[0])
        host = tree_map(lambda t: t.cpu(), model.init_params(SEED))
        run = sharded_step(step, (p_sh, o_sh, b_sh))

        def train(fn, params, opt, what):
            losses, times = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, met = no_launch_during(counters, what,
                                                    lambda: fn(params, opt, b))
                losses.append(float(met["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            return params, opt, losses, times

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                params = tree_map(lambda t: t.to(dev, copy=True), host)
                p1, o1, l1, t1 = train(step, params, adamw_init(params), "12b plain")
                params = tree_map(lambda t: t.to(dev, copy=True), host)
                sp = shard_params(params, mesh)
                so = tree_map(place, adamw_init(params), o_sh)
                del params
                moe_ep.set_ep_mesh(mesh)
                moe_ep.moe_ffn_ep = counted
                sp, so, l2, t2 = train(run, sp, so, "12b EP sharded")
        finally:
            torch.use_deterministic_algorithms(False)
            moe_ep.set_ep_mesh(None)
            moe_ep.moe_ffn_ep = plain_ep
        same_p = all(torch.equal(a.full_tensor(), b)
                     for a, b in zip(tree_leaves(sp), tree_leaves(p1)))
        same_o = all(torch.equal(a.full_tensor(), b)
                     for a, b in zip(tree_leaves(so), tree_leaves(o1)))
        want_calls = n * EP_LAYERS * (2 if cfg.remat != "none" else 1)   # remat reruns
        took_ep = len(calls) == want_calls
        ok = l1 == l2 and same_p and same_o and took_ep
        log(f"[moe_ep] {cfg.name} bf16 ({cfg.n_layers} of 16 layers, d {cfg.d_model}, "
            f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}) B {B} x S {S} on a 1x1 NCCL "
            f"mesh set as the EP mesh: plain losses {l1}, ms {[round(x, 1) for x in t1]}; EP "
            f"sharded losses {l2}, ms {[round(x, 1) for x in t2]}; moe_ffn_ep calls "
            f"{len(calls)} (want {want_calls}: each layer's forward, again under remat); losses "
            f"equal {l1 == l2}, parameters equal "
            f"{same_p}, moments equal {same_o}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; card {card_line()}: "
            f"{'ok' if ok else 'FAILED'}")
        del sp, so, p1, o1, model
    finally:
        dist.destroy_process_group()
    if not ok:
        raise AssertionError("EP sharded step != plain step")


def moe_ep_phase(dev, counters) -> None:
    """Phase 12: the dry run's children start first and run on the host
    while 12a and 12b use the card; then 12c reads them."""
    import torch
    with tempfile.TemporaryDirectory(prefix="moe-ep-") as tmp:
        procs = dryrun_start(tmp)
        try:
            ep_bodies(dev)
            torch.cuda.empty_cache()
            ep_sharded_train(dev, counters, tmp)
        finally:
            dryrun_finish(procs)


# ---------------------------------------------------------------------------------
# phase 13: the tensor-parallel (Megatron) layout, gloo ranks on the one card
# ---------------------------------------------------------------------------------

TP_TOL = {"loss": 1e-6, "grad": 1e-5, "decode": 1e-5}   # 13a and 13c at f32, as on the CPU
TP_STEPS = 3                    # 13a's timed bf16 steps
TP_DECODE = (4, 512, 300)       # 13c: rows, cache length, the decoded position
TP_FAULTS = ("other kv head", "wo unsummed")     # 13b's planted faults


def tp_phase(parts=("13a", "13b", "13c")) -> None:
    """Phase 13: the tensor-parallel layout on gloo ranks, processes that
    share this one card (NCCL refuses two ranks on one device; gloo
    carries CUDA tensors): 13a and 13b on two ranks, a (1, 2) mesh, 13c on
    four, a (1, 4) mesh (:func:`tp_rank`); each process group is destroyed
    in a ``finally``, and a failing gate in any rank fails the phase."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp-") as tmp:
        for group, world in ((("13a", "13b"), 2), (("13c",), 4)):
            todo = [p for p in group if p in parts]
            if not todo:
                continue
            out = os.path.join(tmp, f"tp-{world}.json")
            mp.spawn(tp_rank, args=(todo, world, os.path.join(tmp, f"store-{world}"), out),
                     nprocs=world, join=True)
            failures = json.loads(Path(out).read_text())
            if failures:
                raise AssertionError("tensor-parallel phase failed: " + "; ".join(failures))
    log(f"[tp] phase 13 ({', '.join(parts)}) in {time.perf_counter() - t0:.1f} s; card "
        f"{card_line()}")


def tp_rank(rank: int, parts, world: int, store: str, out: str) -> None:
    """One gloo rank of phase 13 on the card; rank 0 writes the failures
    (every rank's, gathered) to ``out``."""
    import warnings

    import torch
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        failures = []
        if "13a" in parts:
            failures += tp_train(rank, world)
        if "13b" in parts:
            failures += tp_prefill(rank, world)
        if "13c" in parts:
            failures += tp_decode(rank, world)
        every = [None] * world
        dist.all_gather_object(every, failures)
        if rank == 0:
            Path(out).write_text(json.dumps([f for fs in every for f in fs]))
    finally:
        dist.destroy_process_group()


def _tp_model(dtype):
    """qwen2.5-3b ``CONFIG`` at full width, ``SHARDED_LAYERS`` of its 36
    layers (phase 11's cut), on the card, and its seeded weights (every
    rank draws the same)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=SHARDED_LAYERS, dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init_params(SEED)


def _kernel_counters():
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_mixed, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, greedy_epilogue
    from repro_torch.kernels.ssd.ops import ssd_intra
    return (flash_attention_dyn, decode_attention_mixed, decode_attention_paged,
            decode_attention, greedy_epilogue, fused_lmhead_greedy, ssd_intra)


def _rel_err(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def tp_train(rank: int, world: int) -> list:
    """13a: the tensor-parallel sharded step at mesh (1, ``world``) on
    qwen2.5-3b (:func:`_tp_model`), B 4 x S 512.  At f32 its loss and every
    gradient leaf against the one-device step on the card (gates: 1e-6
    relative; 1e-5 of each leaf's largest magnitude); no kernel launches.
    Then at bf16, ``TP_STEPS`` sharded steps (AdamW in place): ms a step
    and each rank's peak memory, printed by rank 0."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.sharding import (
        gather_whole, place, shard_params, sharded_loss_and_grads, sharded_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.training import make_train_step, train_state_shardings

    failures = []
    mesh = make_mesh((1, world), ("data", "model"))
    cfg, model, params = _tp_model(torch.float32)
    batches = train_batches(cfg, TP_STEPS, 4, 512, SEED + 4)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TP_STEPS))
    p_sh, o_sh, b_sh = train_state_shardings(model, mesh, batches[0])
    sp = shard_params(params, mesh)
    loss, grads = no_launch_during(_kernel_counters(), "13a", lambda: sharded_loss_and_grads(
        step, sp, batches[0], (p_sh, b_sh)))
    grads = [gather_whole(g) for g in tree_leaves(grads)]     # gloo: no DTensor collective
    del sp
    loss1, grads1 = step.grads_of(params, {k: v.to(model.device) for k, v in batches[0].items()})
    l_err = abs(float(loss) - float(loss1)) / abs(float(loss1))
    g_err = max(_rel_err(a, b) for a, b in zip(grads, tree_leaves(grads1)))
    ok = l_err <= TP_TOL["loss"] and g_err <= TP_TOL["grad"]
    if rank == 0:
        log(f"[tp] 13a {cfg.name} f32 ({cfg.n_layers} of 36 layers, d {cfg.d_model}, "
            f"16 / 2 heads) B 4 x S 512 at mesh (1, {world}), gloo ranks on one card, layout "
            f"{tensor_parallel.layout(cfg, world)}: loss {float(loss):.7f} against the "
            f"one-device {float(loss1):.7f} ({l_err:.2e} relative, <= {TP_TOL['loss']:g}); "
            f"gradients {g_err:.2e} of the largest magnitude (<= {TP_TOL['grad']:g}): "
            f"{'ok' if ok else 'FAILED'}")
    if not ok:
        failures.append(f"13a rank {rank}: f32 step against one device")
    del params, grads, grads1, model
    torch.cuda.empty_cache()

    cfg, model, params = _tp_model(torch.bfloat16)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TP_STEPS),
                           donate=True)
    sp = shard_params(params, mesh)
    so = tree_map(place, adamw_init(params), o_sh)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = sharded_step(step, (p_sh, o_sh, b_sh))
    times, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        sp, so, met = no_launch_during(_kernel_counters(), "13a bf16", lambda: run(sp, so, b))
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peaks = [None] * world
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 2**20)
    finite = all(x == x and abs(x) < 1e4 for x in losses)
    if rank == 0:
        log(f"[tp] 13a bf16 at mesh (1, {world}): sharded steps losses {losses}, ms "
            f"{[round(x, 1) for x in times]}; peak memory a rank (MiB) "
            f"{[round(x) for x in peaks]}: {'ok' if finite else 'FAILED'}")
    if not finite:
        failures.append(f"13a rank {rank}: bf16 losses {losses}")
    del sp, so, model
    torch.cuda.empty_cache()
    return failures


def tp_prefill(rank: int, world: int) -> list:
    """13b: ``prefill`` with the kernels (``use_kernel``, the default) on
    the rank's blocks at mesh (1, ``world``), qwen2.5-3b bf16
    (:func:`_tp_model`), 4 prompts of 512 tokens: each rank runs the
    flash-attention kernel on its 8 query heads over its one kv head (group
    8 at D 128) in every layer.  Gates: the flash kernel launched once a
    layer on every rank and no plain version called; the rank's
    vocabulary block of the last logits and its kv heads of the cache
    within :func:`bf16_tol` of the one-device kernel prefill's error, both
    against the f32 prefill of the same (bf16) weights, as phase 12a holds
    a bf16 sum over ranks: the row-parallel sums round each rank's bf16
    partial once more than one device's product does.  The distance to the
    one-device bf16 prefill is printed beside ``bf16_tol``.  The gate must
    also fail two planted faults (:data:`TP_FAULTS`), each a prefill on the
    same blocks: the rank's query heads reading the other rank's kv head,
    and the row-parallel ``wo`` left unsummed over ``model``."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.sharding import model_dim, shard_params
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.pytree import tree_map

    failures = []
    mesh = make_mesh((1, world), ("data", "model"))
    _, model32, _ = _tp_model(torch.float32)
    cfg, model, params = _tp_model(torch.bfloat16)
    toks = train_batches(cfg, 1, 4, 512, SEED + 5)[0]["tokens"].to(model.device)
    kv = cfg.n_kv_heads // world
    with torch.no_grad():
        ref32 = model32.prefill(tree_map(lambda t: t.float(), params), {"tokens": toks})
        del model32
        ref = model.prefill(params, {"tokens": toks})
        local = tree_map(lambda t: t.to_local(), shard_params(params, mesh))
        other = (rank + 1) % world          # the planted fault's kv head: the next rank's
        swapped = {**local, "blocks": [
            {**lb, **{n: b[n].chunk(world, model_dim(n))[other] for n in ("wk", "wv", "bk", "bv") if n in b}}
            for lb, b in zip(local["blocks"], params["blocks"])]}
        del params
        before = flash_attention_dyn.launches
        with no_plain() as plain, tensor_parallel.tp_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.prefill(local, {"tokens": toks})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = flash_attention_dyn.launches - before

    def blocks(out):         # a one-device prefill's vocabulary block and kv heads of the rank
        logits, cache = out
        return {"logits": logits.chunk(world, -1)[rank],
                **{k: cache[k][:, :, :, rank * kv:(rank + 1) * kv] for k in ("k", "v")}}

    def dist_(a, b):
        return (a.float() - b.float()).abs().max().item()

    mine = {"logits": got[0], "k": got[1]["k"], "v": got[1]["v"]}
    one, exact = blocks(ref), blocks(ref32)
    errs = {k: (dist_(mine[k], exact[k]), dist_(one[k], exact[k]), dist_(mine[k], one[k]),
                bf16_tol(exact[k])) for k in mine}
    gate = lambda got: all(dist_(got[k], exact[k]) <= errs[k][1] + errs[k][3] for k in errs)

    # the planted faults, each of which the gate must fail
    faults = {}
    plain_out = lm._attn_out
    for fault in TP_FAULTS:
        try:
            if fault == "wo unsummed":
                # replint-torch: disable=CPL303 -- 13b's planted fault, restored in finally
                lm._attn_out = lambda o, bp, cfg, g: o.reshape(*o.shape[:2], -1) @ bp["wo"]
            with torch.no_grad(), tensor_parallel.tp_mesh(mesh):
                bad = model.prefill(swapped if fault == "other kv head" else local,
                                    {"tokens": toks})
        finally:
            # replint-torch: disable=CPL303 -- 13b's planted fault, restored in finally
            lm._attn_out = plain_out
        bad = {"logits": bad[0], "k": bad[1]["k"], "v": bad[1]["v"]}
        faults[fault] = ({k: dist_(bad[k], exact[k]) for k in bad}, gate(bad))
        del bad
    ok = gate(mine) and not any(passed for _, passed in faults.values()) \
        and launches == cfg.n_layers and plain.calls == 0 \
        and mine["logits"].shape[-1] == cfg.vocab // world
    every = [None] * world
    dist.all_gather_object(every, {"launches": launches, "plain": plain.calls, "ms": ms,
                                   "ok": ok})
    if rank == 0:
        text = "; ".join(f"{k} {a:.3e} (one device {b:.3e}, + bf16_tol {t:.3e}; to the "
                         f"one-device bf16 {c:.3e})" for k, (a, b, c, t) in errs.items())
        log(f"[tp] 13b {cfg.name} bf16 prefill 4 x 512 at mesh (1, {world}): each rank's "
            f"flash launches {[e['launches'] for e in every]} (want {cfg.n_layers}: "
            f"{cfg.n_heads // world} query heads over {kv} kv head, group "
            f"{cfg.n_heads // cfg.n_kv_heads}, D {cfg.resolved_head_dim}), plain calls "
            f"{[e['plain'] for e in every]}, ms {[round(e['ms'], 1) for e in every]}; rank 0's "
            f"blocks against the f32 prefill: {text}; planted faults against the f32 "
            f"prefill (each must fail the gate): "
            + "; ".join(f"{f}: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
                        + (" PASSED THE GATE" if passed else " failed it")
                        for f, (d, passed) in faults.items())
            + f": {'ok' if all(e['ok'] for e in every) else 'FAILED'}")
    if not ok:
        failures.append(f"13b rank {rank}: {errs} faults {faults} launches {launches} "
                        f"plain {plain.calls}")
    del ref, ref32, got, local, swapped, model
    torch.cuda.empty_cache()
    return failures


def tp_decode(rank: int, world: int) -> list:
    """13c: one ``decode_step`` at mesh (1, ``world``) on qwen2.5-3b f32
    (:func:`_tp_model`), whose two kv heads do not divide 4: the rules put
    the cache's sequence on ``model``, so each rank holds a span of every
    row, attends over it with every query head and the partial softmaxes
    are merged across ranks.  The cache comes from the one-device prefill
    of ``TP_DECODE``'s prompts, cut to the rank's block; gates: the rank's
    vocabulary block of the logits and its block of the cache after the
    step within 1e-5 of the one-device step's largest magnitude."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.sharding import _block, cache_sharding, shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pytree import tree_map

    failures = []
    mesh = make_mesh((1, world), ("data", "model"))
    cfg, model, params = _tp_model(torch.float32)
    B, s_max, pos = TP_DECODE
    toks = train_batches(cfg, 1, B, pos + 1, SEED + 6)[0]["tokens"].to(model.device)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :pos]}, max_len=s_max)
        c_sh = cache_sharding(cache, cfg, mesh)
        local_cache = tree_map(lambda t, s: _block(t, mesh, s.placements).clone(), cache, c_sh)
        ref_logits, ref_cache = model.decode_step(params, cache, toks[:, pos:], pos)
        local = tree_map(lambda t: t.to_local(), shard_params(params, mesh))
        del params
        split = tensor_parallel.cache_split(c_sh["k"])
        with tensor_parallel.tp_mesh(mesh):
            logits, got = model.decode_step(local, local_cache, toks[:, pos:], pos,
                                            cache_split=split)
    errs = {"logits": _rel_err(logits, ref_logits.chunk(world, -1)[rank]),
            **{k: _rel_err(got[k], _block(ref_cache[k], mesh, c_sh[k].placements))
               for k in got}}
    ok = all(e <= TP_TOL["decode"] for e in errs.values())
    every = [None] * world
    dist.all_gather_object(every, (errs, ok))
    if rank == 0:
        log(f"[tp] 13c {cfg.name} f32 decode_step at position {pos} of {s_max}, B {B}, mesh "
            f"(1, {world}): cache {[str(p) for p in c_sh['k'].placements]} (the sequence on "
            f"model), every rank's error over the largest magnitude "
            f"{[{k: f'{v:.2e}' for k, v in e.items()} for e, _ in every]} (<= "
            f"{TP_TOL['decode']:g}): {'ok' if all(o for _, o in every) else 'FAILED'}")
    if not ok:
        failures.append(f"13c rank {rank}: {errs}")
    return failures


# ---------------------------------------------------------------------------------
# phase 14: flash attention's non-causal mode, mha_prefill, the examples, the lint
# ---------------------------------------------------------------------------------

# phase 3's row-5 reading against the plain version (one bf16 step in [2, 4)),
# and float32's
FLASH_TOL = {"bfloat16": 1.5625e-2, "float32": 2e-5}
# (config, B, S, Hq, Hkv, D): whisper-small's encoder (bidirectional; S 1500 is
# off the 64-row tile) and smollm-135m's bucketed prefill; the first is timed
NONCAUSAL_SHAPES = (("whisper-small enc", 2, 1500, 12, 12, 64),
                    ("smollm-135m", 8, 512, 9, 3, 64))


def lint_start() -> list:
    """Phase 14d's children, started at once on the host: the port's lint
    (``python -m repro_torch.lint``) selftest and its run over the default
    paths, on this machine's Python."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    return [(args, subprocess.Popen([sys.executable, "-m", "repro_torch.lint", *args], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
            for args in (["--selftest", "-q"], ["-q"])]


def lint_finish(procs) -> None:
    """Phase 14d: both lint runs exit 0 (selftest healthy, 0 findings)."""
    for args, proc in procs:
        try:
            text, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        last = text.strip().splitlines()[-1] if text.strip() else "(no output)"
        log(f"[lint] python -m repro_torch.lint {' '.join(args)}: exit {proc.returncode}; {last}")
        if proc.returncode != 0:
            raise AssertionError(f"repro_torch.lint {args} failed: {text[-2000:]}")


def check_flash_noncausal(dev, flush) -> dict:
    """14a: the flash kernel causal and not, window -1 and 64, float32 and
    bf16, against its plain version at ``NONCAUSAL_SHAPES``; then the bf16
    non-causal kernel at whisper-small's encoder shape timed beside the
    plain version, non-causal sdpa and the bound (and the causal kernel at
    the same shape, printed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    errs = {}
    timed = None
    for shape, B, S, Hq, Hkv, D in NONCAUSAL_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + 120)
        q_, k_, v_ = (torch.randn((B, S, h, D), generator=g, device=dev)
                      for h in (Hq, Hkv, Hkv))
        if timed is None:
            timed = (q_, k_, v_)
        for name in ("float32", "bfloat16"):
            qq, kk, vv = (t.to(getattr(torch, name)) for t in (q_, k_, v_))
            for causal in (True, False):
                for window in (-1, 64):
                    out = flash_attention(qq, kk, vv, causal=causal,
                                          window=window if window > 0 else None)
                    torch.cuda.synchronize()
                    ref = flash_attention_plain(qq, kk, vv, window, causal=causal)
                    err = (out.float() - ref.float()).abs().max().item()
                    log(f"[noncausal] flash_attention {shape} {name} causal={causal} "
                        f"window={window}: max |kernel - plain| = {err:.3e} "
                        f"(tol {FLASH_TOL[name]:g})")
                    if not (err <= FLASH_TOL[name] and torch.isfinite(out).all()):
                        raise AssertionError(f"flash_attention {shape} {name} causal={causal} "
                                             f"window={window} disagrees with its plain "
                                             f"version: {err}")
                    errs[(shape, name, causal, window)] = err

    q, k, v = (t.bfloat16() for t in timed)
    B, S, Hq, D = q.shape
    ms = timed_ms(lambda: flash_attention(q, k, v, causal=False), flush=flush)
    causal_ms = timed_ms(lambda: flash_attention(q, k, v, causal=True), flush=flush)
    plain_ms = timed_ms(lambda: flash_attention_plain(q, k, v, -1, causal=False), flush=flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=False)

    lib_err = (lib().transpose(1, 2).float()
               - flash_attention_plain(q, k, v, -1, causal=False).float()).abs().max().item()
    library_ms = timed_ms(lib, flush=flush)
    # least time: q, k, v read once, out written once; flops: QK^T and PV over
    # every (query, key) pair
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4.0 * D * Hq * B * S * S
    b_ms, b_by = bound_ms(n_bytes, flops)
    shape = NONCAUSAL_SHAPES[0][0]
    log(f"[noncausal] flash_attention bf16 {shape} (B {B}, S {S}, {Hq}/{k.shape[2]} heads of "
        f"{D}): kernel {ms:.4f} ms (causal {causal_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (|sdpa - plain| {lib_err:.2e}), bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); kernel/library "
        f"{ms / library_ms:.3f}, kernel/bound {ms / b_ms:.1f}")
    log(f"[noncausal] device time by kernel: "
        f"{device_us(lambda: flash_attention(q, k, v, causal=False), flush=flush)}; "
        f"sdpa: {device_us(lib, flush=flush)}")
    return record(f"flash_attention[noncausal, {shape}]", "flash_attention.cu",
                  "src/repro/kernels/flash_attention/kernel.py:77",
                  errs[(shape, "bfloat16", False, -1)], ms, plain_ms, b_ms, b_by, library_ms)


def mha_prefill_path(dev) -> int:
    """14b: ``attention.mha_prefill(use_kernel=True)``, the non-causal
    kernel's entry point, at whisper-small's encoder shape in bf16, both
    modes and windows, against the plain route; each call launches the
    kernel once (the counter zeroed just before, read just after).
    Returns the non-causal calls' launches."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
    from repro_torch.models.attention import mha_prefill

    shape, B, S, Hq, Hkv, D = NONCAUSAL_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 121)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev, dtype=torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    noncausal = 0
    for causal in (False, True):
        for window in (None, 64):
            flash_attention_dyn.launches = 0
            out = mha_prefill(q, k, v, causal=causal, window=window, use_kernel=True)
            torch.cuda.synchronize()
            n = flash_attention_dyn.launches
            ref = mha_prefill(q, k, v, causal=causal, window=window)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"[mha_prefill] {shape} bf16 causal={causal} window={window}: {n} flash "
                f"launch(es), max |kernel route - plain route| = {err:.3e} "
                f"(tol {FLASH_TOL['bfloat16']:g})")
            if n != 1 or not err <= FLASH_TOL["bfloat16"]:
                raise AssertionError(f"mha_prefill(use_kernel=True) causal={causal} "
                                     f"window={window}: {n} launches, error {err}")
            noncausal += 0 if causal else n
    return noncausal


def child_start(args):
    """``python <args>`` on this checkout, started in a child process:
    ``(args, start time, Popen)`` for :func:`child_finish`."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return args, time.perf_counter(), subprocess.Popen(
        [sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def child_finish(tag: str, child, timeout: float, *, show=None) -> str:
    """Waits for a :func:`child_start` child, killed past ``timeout`` seconds
    from its start; prints its exit code, seconds and the lines ``show``
    picks (default: the last four), fails unless it exits 0; returns its
    standard output."""
    args, t0, proc = child
    try:
        out, err = proc.communicate(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    lines = out.strip().splitlines()
    for line in (lines[-4:] if show is None else [x for x in lines if show(x)]):
        log(f"{tag} {line}")
    log(f"{tag} python {' '.join(args)}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{tag} python {' '.join(args)} failed: {out[-1500:]} "
                             f"{err[-1500:]}")
    return out


def child_run(tag: str, args, timeout: float, *, show=None) -> str:
    """:func:`child_start`, then :func:`child_finish`."""
    return child_finish(tag, child_start(args), timeout, show=show)


def quickstart_on_card(timeout: float = 240) -> None:
    """14c: ``examples/torch/quickstart.py`` on the card in a child process
    (the paper's policies on the port's simulator, 20 training steps of
    smollm-135m's smoke config, 6 requests served through the kernels),
    killed past ``timeout`` seconds."""
    out = child_run("[quickstart]", (str(ROOT / "examples" / "torch" / "quickstart.py"),),
                    timeout)
    if "served 6 requests" not in out or "on cuda" not in out:
        raise AssertionError(f"examples/torch/quickstart.py failed: {out[-1500:]}")


# ---------------------------------------------------------------------------------
# phase 15: the configurations the card had not served
# ---------------------------------------------------------------------------------

GEMMA_WINDOW_LAYERS = 6      # 15a's f32 window check: layers 0-5, five local, one global
GEMMA_WINDOW_PREFILL = 1400  # its prefilled positions: 376 past the 1024-token window
WINDOW_LP_TOL = 1e-4         # its gate, card against CPU: tokens equal, logprobs within
VARIANT_TOL = 1e-5           # 15e, f32: loss and each gradient leaf, relative
# 15a's serving loop.  ``--decode-steps 8`` (the engine's own cadence; the
# CLI's default is 1): at one mixed iteration an engine step, a prompt over
# 50 x 16 = 800 tokens emits nothing for more than the backend's 50
# ``--stall-steps``, is evicted and restarted, and the run never drains, in
# the JAX package's CLI too.  ``--requests 7`` (5 arrive: 2927 prompt and
# 1055 new tokens, 3 rows past position 1024): ``appdata`` keeps one slot on
# random weights, so the requests run one after another
SERVE_CLI = ("--arch", "gemma3-4b", "--batch", "8", "--max-len", "2048", "--mean-prompt",
             "768", "--mean-decode", "128", "--policy", "appdata", "--decode-steps", "8",
             "--requests", "7")
TRAIN_CLI = ("--arch", "smollm-135m", "--microbatches", "2", "--batch", "8", "--seq", "512",
             "--steps", "6")


def gemma_requests(vocab):
    """Phase 15a's 16 requests: prompts seeded in 64 .. 1536 tokens (the
    even rids from 1024 up, so at least half the rows pass position 1024,
    where the local layers' window starts to drop keys), 16 .. 64 new."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED + 150)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(
                        GEMMA_WINDOW if i % 2 == 0 else 64, 1537))),
                    max_new_tokens=int(rng.integers(16, 65))) for i in range(16)]


def counted_model(model):
    """``model`` with its ``prefill``, ``decode_step`` and ``verify_step``
    counting their calls into the returned dictionary: an engine's prefill
    groups (or single prefills), decode steps and mixed iterations."""
    import dataclasses
    calls = {"prefill": 0, "decode_step": 0, "verify_step": 0}

    def counting(name):
        fn = getattr(model, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    return dataclasses.replace(model, **{name: counting(name) for name in calls}), calls


class attention_calls:
    """Records, while entered, every attention-kernel call that
    ``models/lm.py`` makes, by wrapper name: ``launches[name][window]``, the
    launches the wrapper's own counter took during the calls at that window
    (read before and after each call), and, for the two paged wrappers,
    ``pages[name]``, the (page dtype, scales given, device) of each call."""
    NAMES = ("decode_attention_mixed", "decode_attention_paged", "flash_attention_dyn")

    def __enter__(self):
        from repro_torch.models import lm
        self._lm = lm
        self.launches = {name: {} for name in self.NAMES}
        self.pages = {name: set() for name in self.NAMES[:2]}
        self._saved = {name: getattr(lm, name) for name in self.NAMES}
        for name, fn in self._saved.items():
            def recorded(q, k, *a, _fn=fn, _name=name, **kw):
                window = int(kw["window"] if "window" in kw else a[1])  # flash: (q, k, v, window)
                if _name in self.pages:
                    self.pages[_name].add((str(k.dtype).removeprefix("torch."),
                                           kw.get("k_scale") is not None, k.device.type))
                before = _fn.launches
                out = _fn(q, k, *a, **kw)
                by_window = self.launches[_name]
                by_window[window] = by_window.get(window, 0) + _fn.launches - before
                return out
            setattr(lm, name, recorded)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._lm, name, fn)


def gemma_path(dev, counters, bucketed_counters) -> dict:
    """Phase 15a's engine: gemma3-4b ``CONFIG`` at bf16, full width and
    depth, seeded weights, ``ServeConfig(max_batch=8, max_len=2048)``; 16
    requests (:func:`gemma_requests`) on the chunked path, again (the same
    tokens), then on the bucketed path.  Every request completes, pages
    are conserved, no plain version runs; chunked: paged mixed attention
    34 launches and the lm-head one a ``verify_step``; bucketed: flash 34
    a prefill group, paged decode 34 a decode step, the greedy epilogue one
    a step (groups + decode steps).  The attention launches are also
    counted by window (:class:`attention_calls`) and gated at each window's
    layer count a step: 29 at the local window 1024, 5 at -1.  Returns the
    launches, those by window and the step counts."""
    from collections import Counter

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import layer_windows

    cfg = get_config("gemma3-4b")
    L = cfg.n_layers
    windows = layer_windows(cfg)
    per_window = Counter(windows)                              # {1024: 29, -1: 5}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    log(f"[gemma] {cfg.name} bf16: {L} layers, global at "
        f"{[i for i, w in enumerate(windows) if w < 0]}, the rest window {cfg.window}; d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"untied {cfg.d_model} x {cfg.vocab} head; {sum(t.numel() for t in leaves) / 1e9:.3f} B "
        f"parameters, {sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB, drawn "
        f"in {time.perf_counter() - t0:.1f} s; ServeConfig(max_batch=8, max_len=2048); "
        f"reduced: none")
    reqs = gemma_requests(cfg.vocab)
    past = sum(len(r.prompt) + r.max_new_tokens - 1 > GEMMA_WINDOW for r in reqs)
    log(f"[gemma] requests: prompts {min(len(r.prompt) for r in reqs)}.."
        f"{max(len(r.prompt) for r in reqs)} ({sum(len(r.prompt) for r in reqs)} tokens), "
        f"{sum(r.max_new_tokens for r in reqs)} new; {past}/16 rows pass position "
        f"{GEMMA_WINDOW}")

    def by_window(steps):
        return {w: n * steps for w, n in per_window.items()}

    counted, calls = counted_model(model)
    with no_plain() as plain, attention_calls() as seen:
        launches, tokens = main_path(dev, counted, params, counters, requests=gemma_requests,
                                     max_len=2048, tag="[gemma]")
    verifies = calls["verify_step"]
    mixed = seen.launches["decode_attention_mixed"]
    ok = (past >= 8 and launches["fused_lmhead_greedy"] == verifies
          and launches["decode_attention_mixed"] == L * verifies
          and mixed == by_window(verifies) and plain.calls == 0)
    log(f"[gemma] chunked: {verifies} verify_steps, paged mixed attention "
        f"{launches['decode_attention_mixed']} launches ({L} a verify_step: "
        f"{launches['decode_attention_mixed'] == L * verifies}), by window {mixed} "
        f"({dict(per_window)} a verify_step: {mixed == by_window(verifies)}), lm-head "
        f"{launches['fused_lmhead_greedy']} (1 a verify_step); plain-version calls "
        f"{plain.calls}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("gemma3-4b chunked path: fewer than half the rows past 1024, a "
                             "launch count off its step count or its windows' layer counts, "
                             "or a plain version ran")
    _, again = main_path(dev, counted, params, counters, requests=gemma_requests, max_len=2048,
                         tag="[gemma again]")
    log(f"[gemma] a second chunked drain of the same requests: tokens identical "
        f"{again == tokens}")
    if again != tokens:
        raise AssertionError("gemma3-4b chunked path: two drains of the bf16 engine differ")
    for name in calls:
        calls[name] = 0
    torch.cuda.reset_peak_memory_stats()
    with no_plain() as plain, attention_calls() as b_seen:
        b_launches = bucketed_path(dev, counted, params, bucketed_counters, tokens,
                                   requests=gemma_requests, max_len=2048,
                                   tag="[gemma bucketed]")
    groups, steps = calls["prefill"], calls["decode_step"]
    flash, paged = (b_seen.launches[k] for k in ("flash_attention_dyn", "decode_attention_paged"))
    ok = (b_launches["flash_attention_dyn"] == L * groups
          and b_launches["decode_attention_paged"] == L * steps
          and flash == by_window(groups) and paged == by_window(steps)
          and b_launches["greedy_epilogue"] == groups + steps and plain.calls == 0)
    log(f"[gemma bucketed] {groups} prefill groups, {steps} decode steps: flash "
        f"{b_launches['flash_attention_dyn']} launches ({L} a group), by window {flash}; paged "
        f"decode {b_launches['decode_attention_paged']} ({L} a step), by window {paged} "
        f"({dict(per_window)} a group and a step: "
        f"{flash == by_window(groups) and paged == by_window(steps)}); greedy epilogue "
        f"{b_launches['greedy_epilogue']} (one a group and a step); plain-version calls "
        f"{plain.calls}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("gemma3-4b bucketed path: a launch count off its step count or "
                             "its windows' layer counts, or a plain version ran")
    return {"chunked": launches, "bucketed": b_launches, "local": cfg.window,
            "windows": {"paged_mixed_attention": mixed, "flash_attention": flash,
                        "paged_decode_attention": paged}}


def gemma_window_check(dev, counters) -> None:
    """Phase 15a at model level: gemma3-4b at full width and float32, layers
    0-5 of 34 (five local, one global; seeded weights).  Two rows prefilled
    on the card to :data:`GEMMA_WINDOW_PREFILL` tokens (flash), their cache
    written into 16-token pages; then the card's ``verify_step`` (paged
    mixed attention, lm-head) and the CPU's (plain versions), each from its
    own copy of that cache, run 16 greedy tokens a row.  Gate: tokens
    identical, logprobs within :data:`WINDOW_LP_TOL`.  A planted fault, the
    local layers' window dropped (-1) on the card's route only, must fail
    that gate: the window acts at this width."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, lm
    from repro_torch.serving.kvcache import write_prefill_pages

    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=GEMMA_WINDOW_LAYERS,
                              dtype=torch.float32)
    B, S, n_new, ps = 2, GEMMA_WINDOW_PREFILL, 16, 16
    n, pre = -(-(S + n_new) // ps), -(-S // ps)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    tbl = (1 + torch.arange(B * n, dtype=torch.int32, device=dev)).view(B, n)
    toks = torch.from_numpy(np.random.default_rng(SEED + 151).integers(0, cfg.vocab, (B, S)))
    logits, cache = model.prefill(params, {"tokens": toks.to(dev)}, max_len=pre * ps)
    pages = write_prefill_pages(model.init_cache(B * n + 1, ps), cache, tbl[:, :pre])
    tok0 = logits[:, 0].argmax(-1)
    del cache, logits
    base = {k: v.clone() for k, v in pages.items()}
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = to_device(params, "cpu")
    torch.cuda.synchronize()
    log(f"[gemma window] {cfg.name} f32, layers 0-{cfg.n_layers - 1} of 34 (windows "
        f"{list(lm.layer_windows(cfg))}; reduced: depth 34 -> {cfg.n_layers}), {B} rows "
        f"prefilled to {S} on the card, {n}-page rows: set up in {time.perf_counter() - t0:.1f} s")

    def run(m, p, pg, where):
        tb, tok = tbl.to(where), tok0.to(where)
        pos = torch.full((B,), S, dtype=torch.int32, device=where)
        out_t, out_lp = [], []
        for _ in range(n_new):
            t, lp, pg = m.verify_step(p, pg, tok[:, None], pos, block_table=tb)
            tok = t[:, 0].long()
            out_t.append(tok.cpu())
            out_lp.append(lp[:, 0].float().cpu())
            pos = pos + 1
        return torch.stack(out_t, 1), torch.stack(out_lp, 1)

    t0 = time.perf_counter()
    cpu_t, cpu_lp = run(cpu_model, cpu_params, {k: v.cpu() for k, v in base.items()}, "cpu")
    cpu_s = time.perf_counter() - t0
    for c in counters:
        c.launches = 0
    gpu_t, gpu_lp = run(model, params, pages, dev)
    launches = {c.__name__: c.launches for c in counters}
    err = (gpu_lp - cpu_lp).abs().max().item()
    ok = (torch.equal(gpu_t, cpu_t) and err <= WINDOW_LP_TOL
          and launches["decode_attention_mixed"] == cfg.n_layers * n_new
          and launches["fused_lmhead_greedy"] == n_new)
    log(f"[gemma window] {n_new} verify_steps a row from position {S}: tokens card = CPU "
        f"{torch.equal(gpu_t, cpu_t)}, max |logprob card - CPU| {err:.3e} (tol "
        f"{WINDOW_LP_TOL}); card launches {launches}; the CPU's plain route "
        f"{cpu_s:.1f} s: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("gemma3-4b past its window: the card disagrees with the CPU")

    # the planted fault: the local layers' window dropped on the card's route
    real = lm.decode_attention_mixed

    def no_window(q, *a, window=-1, **kw):
        return real(q, *a, window=-1 if q.is_cuda else window, **kw)

    lm.decode_attention_mixed = no_window
    try:
        bad_t, bad_lp = run(model, params, base, dev)
    finally:
        lm.decode_attention_mixed = real
    bad_err = (bad_lp - cpu_lp).abs().max().item()
    caught = not (torch.equal(bad_t, cpu_t) and bad_err <= WINDOW_LP_TOL)
    log(f"[gemma window] planted fault (window -1 on the card's local layers): tokens equal "
        f"{torch.equal(bad_t, cpu_t)} ({int((bad_t == cpu_t).sum())}/{bad_t.numel()}), max "
        f"|logprob - CPU| {bad_err:.3e}: the gate {'fails it' if caught else 'MISSED it'}")
    if not caught:
        raise AssertionError("gemma3-4b window check: the planted no-window fault passed")


def cli_rows_past_window() -> tuple[int, int]:
    """(rows, rows that pass position 1024) of :data:`SERVE_CLI`'s requests,
    drawn as ``launch.serve`` draws them: its stream at its default seed and
    60 s horizon, prompts capped at ``max_len // 2``, budgets at
    ``max_len // 4``."""
    from repro_torch.data import request_stream
    opt = dict(zip(SERVE_CLI[::2], SERVE_CLI[1::2]))
    max_len = int(opt["--max-len"])
    stream = request_stream(n_requests=int(opt["--requests"]), seed=0,
                            mean_prompt=int(opt["--mean-prompt"]),
                            mean_decode=int(opt["--mean-decode"]), burst_times=(30.0,),
                            horizon_s=60.0)
    rows = [(min(p, max_len // 2), max(min(d, max_len // 4), 1)) for _, p, d in stream]
    return len(rows), sum(p + d - 1 > GEMMA_WINDOW for p, d in rows)


def cli_children(tmp: str, *, serve: bool = True, train: bool = True) -> None:
    """Phase 15's two CLI runs on the card, started together as child
    processes (each spends most of its time starting up):

    * ``serve``: 15a's serving loop, ``python -m repro_torch.launch.serve``
      with :data:`SERVE_CLI` (gemma3-4b at full width, ``max_len`` 2048,
      the ``appdata`` policy; prompts capped at ``max_len // 2`` = 1024, and
      at least two rows pass position 1024, :func:`cli_rows_past_window`):
      it exits 0 and completes every request on the card;
    * ``train``: 15e's ``python -m repro_torch.launch.train`` with
      :data:`TRAIN_CLI` (smollm-135m ``CONFIG``, two microbatches of 4 x
      512), checkpoints in ``tmp``, each step's loss read from
      ``--loss-log``: it exits 0 and the loss falls.

    A child still running when the other fails is killed."""
    import re
    log_path = os.path.join(tmp, "loss.log")
    children = []
    try:
        if serve:
            rows, past = cli_rows_past_window()
            log(f"[gemma serve] {rows} requests arrive, {past} of their rows pass position "
                f"{GEMMA_WINDOW}")
            if past < 2:
                raise AssertionError("launch.serve --arch gemma3-4b: fewer than two rows pass "
                                     "the window")
            children.append(child_start(("-m", "repro_torch.launch.serve", *SERVE_CLI)))
        if train:
            children.append(child_start(("-m", "repro_torch.launch.train", *TRAIN_CLI,
                                         "--ckpt-dir", os.path.join(tmp, "ckpt"),
                                         "--loss-log", log_path)))
        if serve:
            out = child_finish("[gemma serve]", children[0], 600,
                               show=lambda line: line.startswith("[serve]"))
            m = re.search(r"completed (\d+)/(\d+) requests", out)
            if not (m and m.group(1) == m.group(2) and "on cuda" in out):
                raise AssertionError(f"launch.serve --arch gemma3-4b left requests or ran off "
                                     f"the card: {out[-1500:]}")
        if train:
            child_finish("[train cli]", children[-1], 600,
                         show=lambda line: line.startswith("[train]"))
    finally:
        for _, _, proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not train:
        return
    with open(log_path) as f:
        losses = [float.fromhex(line.split()[1]) for line in f if line.strip()]
    ok = len(losses) == 6 and losses[-1] < losses[0]
    log(f"[train cli] microbatches 2: losses {[round(x, 4) for x in losses]}; the loss falls "
        f"{losses[-1] < losses[0] if losses else False}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("launch.train --microbatches 2: the loss did not fall")


def qwen_path(dev, counters) -> None:
    """Phase 15b: qwen2.5-3b ``CONFIG`` at bf16, full width and depth (QKV
    bias, GQA group 8 at D 128, untied 2048 x 151936 head), seeded weights;
    phase 5's 16 requests on the chunked path at ``max_len`` 1024, twice.
    Gates as in 15a: completion, pages conserved, paged mixed attention 36
    launches and the lm-head one a ``verify_step``, no plain version, the
    second drain's tokens equal the first's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen2.5-3b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    torch.cuda.synchronize()
    log(f"[qwen] {cfg.name} bf16: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, QKV bias {cfg.qkv_bias}, untied "
        f"{cfg.d_model} x {cfg.vocab} head; "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s; reduced: none")
    counted, calls = counted_model(model)
    with no_plain() as plain:
        launches, tokens = main_path(dev, counted, params, counters, tag="[qwen]")
    verifies = calls["verify_step"]
    _, again = main_path(dev, counted, params, counters, tag="[qwen again]")
    ok = (launches["fused_lmhead_greedy"] == verifies
          and launches["decode_attention_mixed"] == cfg.n_layers * verifies
          and plain.calls == 0 and again == tokens)
    log(f"[qwen] {verifies} verify_steps, paged mixed attention "
        f"{launches['decode_attention_mixed']} launches ({cfg.n_layers} a verify_step), "
        f"lm-head {launches['fused_lmhead_greedy']}; plain-version calls {plain.calls}; a second "
        f"drain's tokens identical {again == tokens}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("qwen2.5-3b chunked path: a launch count off its step count, a "
                             "plain version ran, or two drains differ")


def int8_kv_path(dev, counters, bucketed_counters, native_tokens) -> None:
    """Phase 15c: smollm-135m ``CONFIG`` (bf16, phase 5's seeded weights)
    with ``kv_cache_dtype="int8"``: phase 5's requests on the chunked path,
    then the bucketed one.  Gates: every request completes, pages are
    conserved, no plain version runs, and every paged mixed and paged
    decode call took int8 pages with their scales on the card (the K/V
    quantized by ``lm._kv_quantize`` on the card and written into the
    pages by ``kvcache.PagedOps``).  The share of tokens equal to phase
    5's native-cache run is printed, not gated: quantization changes
    tokens.  Then the f32 smoke references on both paths."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("smollm-135m"), kv_cache_dtype="int8")
    torch.cuda.empty_cache()
    model = build_model(cfg)                                   # on the GPU
    params = model.init_params(SEED)
    with no_plain() as plain, attention_calls() as calls:
        _, tokens = main_path(dev, model, params, counters, tag="[int8 kv]")
        bucketed_path(dev, model, params, bucketed_counters, tokens, tag="[int8 kv bucketed]")
    want = {("int8", True, "cuda")}
    ok = (plain.calls == 0 and calls.pages["decode_attention_mixed"] == want
          and calls.pages["decode_attention_paged"] == want)
    reqs = main_requests(cfg.vocab)
    for r in reqs:
        r.output = tokens[r.rid]
    same, total = token_share(reqs, native_tokens)
    log(f"[int8 kv] page pools seen by the kernels: {calls.pages}; plain-version calls "
        f"{plain.calls}; chunked tokens equal to phase 5's native-cache run at {same}/{total} "
        f"positions ({100 * same / total:.1f}%, not gated): {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("int8 KV path: a kernel saw other pages than int8 with scales on "
                             "the card, or a plain version ran")
    small_reference(dev, kv="int8")
    small_reference(dev, chunked=False, kv="int8")


def dense_fallback_path(dev, counters, native_tokens) -> None:
    """Phase 15d: smollm-135m ``CONFIG`` at bf16 (phase 5's weights) through
    the engine's dense-cache fallback, ``ServeConfig(max_batch=8,
    max_len=1024, paged=False)``, on phase 5's requests: each admitted
    request prefilled alone (flash, one launch a layer), each engine step a
    K-step greedy decode over all 8 slots of one dense cache (the masked
    sdpa the JAX package runs there, and the greedy epilogue).  Gates:
    every request completes with its budget, flash launches once a layer a
    prefill, the greedy epilogue once a prefill and a decode step, no paged
    kernel and no plain version.  Then the f32 smoke reference, card
    against CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = get_config("smollm-135m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, calls = counted_model(build_model(cfg))             # on the GPU
    params = model.init_params(SEED)
    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024, paged=False),
                        device=dev)
    reqs = main_requests(cfg.vocab)
    for r in reqs:
        eng.submit(r)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain() as plain:
        eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    prefills, steps = calls["prefill"], calls["decode_step"]
    emitted = sum(len(r.output) for r in reqs)
    same, total = token_share(reqs, native_tokens)
    paged_kernels = ("decode_attention_mixed", "decode_attention_paged", "fused_lmhead_greedy")
    ok = (not eng.paged and len(eng.completed) == len(reqs)
          and all(len(r.output) == r.max_new_tokens for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output)
          and all(np.isfinite(r.score) and r.score <= 0.0 for r in reqs)
          and prefills == len(reqs) and launches["flash_attention_dyn"] == cfg.n_layers * prefills
          and launches["greedy_epilogue"] == prefills + steps
          and not any(launches[k] for k in paged_kernels) and plain.calls == 0)
    log(f"[dense] {cfg.name} bf16, paged=False: {len(eng.completed)}/{len(reqs)} requests, "
        f"{emitted} emitted tokens in {wall:.3f} s ({emitted / wall:.1f} emitted tok/s, "
        f"{eng.step_count} engine steps of {1e3 * wall / eng.step_count:.2f} ms; {prefills} "
        f"prefills, {steps} decode steps); launches {launches} (flash {cfg.n_layers} a "
        f"prefill, greedy epilogue one a prefill and a decode step); plain-version calls "
        f"{plain.calls}; peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
        f"tokens equal to phase 5's at {same}/{total} positions ({100 * same / total:.1f}%, "
        f"not gated): {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("paged=False on smollm-135m: incomplete requests, bad outputs, "
                             "or launches off one flash a layer a prefill and one epilogue a "
                             "step")
    small_reference(dev, paged=False)


def grads_rel_err(a, b) -> tuple[float, float]:
    """(relative loss error, worst gradient leaf's max |a - b| over its
    largest magnitude) of two ``(loss, grads)`` pairs."""
    from repro_torch.pytree import tree_leaves
    l_err = abs(float(a[0]) - float(b[0])) / abs(float(b[0]))
    g_err = max(float((x.float() - y.float()).abs().max()) / max(float(y.abs().max()), 1e-30)
                for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])))
    return l_err, g_err


def train_variants(dev, counters) -> None:
    """Phase 15e in this process (its CLI run is :func:`cli_children`'):
    (i) smollm-135m's smoke config at float32 on the card, one step's loss
    and gradients with ``microbatches=2`` against 1 and with
    ``remat="dots"`` against ``"block"``, each within :data:`VARIANT_TOL`
    (relative; the gradients leaf by leaf over the leaf's largest
    magnitude); (ii) smollm-135m ``CONFIG`` at bf16, B 8 x S 512, 4 steps
    under each remat policy: ms a step and peak memory.  No kernel launches
    during any step."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), dtype=torch.float32,
                              remat="block")
    batch = {k: v.to(dev) for k, v in train_batches(cfg, 1, 8, 64, SEED + 30)[0].items()}
    params = build_model(cfg).init_params(SEED)

    def grads(c, mb):
        step = make_train_step(build_model(c), opt, microbatches=mb)
        return no_launch_during(counters, f"15e {c.remat} mb {mb}",
                                lambda: step.grads_of(params, batch))

    ref = grads(cfg, 1)
    mb = grads_rel_err(grads(cfg, 2), ref)
    dots = grads_rel_err(grads(dataclasses.replace(cfg, remat="dots"), 1), ref)
    ok = max(*mb, *dots) <= VARIANT_TOL
    log(f"[train variants] {cfg.name} f32 B 8 x S 64 on the card: microbatches 2 vs 1 loss rel "
        f"{mb[0]:.2e}, worst gradient leaf {mb[1]:.2e}; remat dots vs block loss rel "
        f"{dots[0]:.2e}, worst gradient leaf {dots[1]:.2e} (tol {VARIANT_TOL}): "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("microbatches or remat='dots' changed the f32 loss or gradients")

    B, S, n = 8, 512, 4
    base = get_config("smollm-135m")
    batches = train_batches(base, n, B, S, SEED + 31)
    for remat in ("block", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)                               # on the GPU
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=n),
                               donate=True)
        params = model.init_params(SEED)
        opt = adamw_init(params)
        times, losses = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = no_launch_during(counters, f"15e {remat}",
                                                lambda: step(params, opt, b))
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        ms = sum(times[1:]) / len(times[1:])
        log(f"[train variants] {cfg.name} bf16 B {B} x S {S}, remat {remat!r}: losses "
            f"{[round(x, 4) for x in losses]}; {step_stats(cfg, B, S, ms)} (steps 2-{n}); peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        del params, opt, step, model


PHASE15_PARTS = ("a", "b", "c", "d", "e")


def configs_phase(dev, native_tokens=None, parts=PHASE15_PARTS) -> dict | None:
    """Phase 15 (15a-15e, or the ``parts`` of them) in order; returns
    :func:`gemma_path`'s launches (15a's records), None without 15a.  15c
    and 15d compare with ``native_tokens``, phase 5's tokens, and run phase
    5 for them when not given.  15a's and 15e's CLI children run side by
    side, with whichever of the two parts is asked for."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_mixed, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention_dyn
    from repro_torch.kernels.sampling.ops import fused_lmhead_greedy, greedy_epilogue
    from repro_torch.kernels.ssd.ops import ssd_intra
    from repro_torch.models import build_model

    counters = (decode_attention_mixed, fused_lmhead_greedy)
    bucketed_counters = (flash_attention_dyn, decode_attention_paged, greedy_epilogue)
    all_counters = (flash_attention_dyn, decode_attention_mixed, decode_attention_paged,
                    decode_attention, greedy_epilogue, fused_lmhead_greedy, ssd_intra)
    gemma = None
    t0 = time.perf_counter()
    if "a" in parts:
        gemma = gemma_path(dev, counters, bucketed_counters)
        torch.cuda.empty_cache()
        gemma_window_check(dev, counters)
    if {"a", "e"} & set(parts):
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="train-cli-") as tmp:
            cli_children(tmp, serve="a" in parts, train="e" in parts)
        done = [x for x, part in (("15a", "a"), ("15e's CLI run", "e")) if part in parts]
        log(f"[phase15] {' and '.join(done)} in {time.perf_counter() - t0:.1f} s")
    if "b" in parts:
        t1 = time.perf_counter()
        qwen_path(dev, counters)
        log(f"[phase15] 15b in {time.perf_counter() - t1:.1f} s")
    if native_tokens is None and {"c", "d"} & set(parts):
        model = build_model(get_config("smollm-135m"))         # on the GPU
        _, native_tokens = main_path(dev, model, model.init_params(SEED), counters)
        del model
    if "c" in parts:
        t1 = time.perf_counter()
        int8_kv_path(dev, counters, bucketed_counters, native_tokens)
        log(f"[phase15] 15c in {time.perf_counter() - t1:.1f} s")
    if "d" in parts:
        t1 = time.perf_counter()
        dense_fallback_path(dev, all_counters, native_tokens)
        log(f"[phase15] 15d in {time.perf_counter() - t1:.1f} s")
    if "e" in parts:
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        train_variants(dev, all_counters)
        log(f"[phase15] 15e in {time.perf_counter() - t1:.1f} s")
    log(f"[phase15] {', '.join(f'15{p}' for p in parts)} in {time.perf_counter() - t0:.1f} s")
    return gemma


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
    for name in ("flash_attention", "paged_mixed_attention", "lmhead_greedy"):
        n_hmma, line = hmma_count(libs[name])
        log(f"[build] lib{name}.so: {line}")
        if n_hmma == 0:
            raise AssertionError(f"lib{name}.so holds no tensor-core instruction")
    lint_procs = lint_start()                 # phase 14d, on the host meanwhile
    atexit.register(lambda: [p.kill() for _, p in lint_procs if p.poll() is None])

    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    flush = scratch.zero_
    records = [check_attention(dev, flush), check_lmhead(dev, flush),
               check_paged_decode(dev, flush), *check_greedy(dev, flush),
               *check_flash(dev, flush), check_dense_decode(dev, flush),
               check_ssd_intra(dev, flush)]
    records += check_family_kernels(dev, flush)
    records += check_gemma_kernels(dev, flush)
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
    scaling_loop(dev, ssm_model, ssm_params, ssm_counters, tag="[scaling ssm]")
    profile_window(dev, ssm_model, ssm_params, tag="[profile ssm]", kind="decode steps")

    # the hybrid at full width: zamba2-2.7b prefill on the card
    del ssm_model, ssm_params
    torch.cuda.empty_cache()
    zamba_path(dev, (flash_attention_dyn, ssd_intra))

    # the replica fleet: a float32 reference, then smollm-135m at full width
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp:
        fleet_reference(dev, os.path.join(tmp, "smoke"))
        fleet_launches = fleet_path(dev, counters, os.path.join(tmp, "full"), chunked_tokens)
    log(f"[fleet] phases 8 and 8b in {time.perf_counter() - t0:.1f} s; launches {fleet_launches}")

    # the moe and vlm families, smollm-360m, and the autotune sweeps
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family_references(dev)
    olmoe = olmoe_path(dev, counters, bucketed_counters)
    torch.cuda.empty_cache()
    families = family_paths(dev, counters + bucketed_counters[:2])
    autotune_sweeps(dev)
    log(f"[families] phases 9a-9d in {time.perf_counter() - t0:.1f} s")

    # training on the card: references, smollm-135m, qwen2.5-3b, mamba2-1.3b,
    # whisper-small
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    all_counters = (flash_attention_dyn, decode_attention_mixed, decode_attention_paged,
                    decode_attention, greedy_epilogue, fused_lmhead_greedy, ssd_intra)
    train_references(dev, all_counters)
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        train_full(dev, all_counters, tmp)
    train_wide(dev, all_counters)
    whisper_full(dev, all_counters)
    log(f"[train] phases 10a-10d in {time.perf_counter() - t0:.1f} s")

    # the sharded train step on a one-rank NCCL mesh
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sharded-") as tmp:
        sharded_train(dev, all_counters, tmp)
    log(f"[sharded] phase 11 in {time.perf_counter() - t0:.1f} s")

    # the expert-parallel MoE on the card, and the dry run on the host
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_ep_phase(dev, all_counters)
    log(f"[moe_ep] phase 12 in {time.perf_counter() - t0:.1f} s")

    # the tensor-parallel layout: gloo ranks, processes on this one card
    torch.cuda.empty_cache()
    tp_phase()

    # flash attention's non-causal mode, mha_prefill, the examples, the lint
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    records.append(check_flash_noncausal(dev, scratch.zero_))
    del scratch
    noncausal_launches = mha_prefill_path(dev)
    quickstart_on_card()
    lint_finish(lint_procs)
    log(f"[phase14] 14a-14d in {time.perf_counter() - t0:.1f} s")

    # the configurations the card had not served: gemma3-4b, qwen2.5-3b
    # serving, the int8 KV cache, paged=False, microbatches and remat "dots"
    torch.cuda.empty_cache()
    gemma = configs_phase(dev, chunked_tokens)

    log(f"[done] greedy_epilogue launches: {launches['greedy_epilogue']} in phase 5b, "
        f"{ssm_launches['greedy_epilogue']} in phase 5c")
    by_kernel = {"paged_mixed_attention": launches["decode_attention_mixed"],
                 "lmhead_greedy": launches["fused_lmhead_greedy"],
                 "paged_decode_attention": launches["decode_attention_paged"],
                 "greedy_epilogue": launches["greedy_epilogue"] + ssm_launches["greedy_epilogue"],
                 "flash_attention": launches["flash_attention_dyn"],
                 "ssd_intra": ssm_launches["ssd_intra"],
                 "dense_decode_attention": dense_launches,
                 "paged_mixed_attention[olmoe-1b-7b]": olmoe["chunked"]["decode_attention_mixed"],
                 "lmhead_greedy[olmoe-1b-7b]": olmoe["chunked"]["fused_lmhead_greedy"],
                 "paged_mixed_attention[pixtral-12b]":
                     families["pixtral-12b"]["decode_attention_mixed"],
                 "paged_decode_attention[olmoe-1b-7b]":
                     olmoe["bucketed"]["decode_attention_paged"],
                 "greedy_epilogue[olmoe-1b-7b]": olmoe["bucketed"]["greedy_epilogue"],
                 "flash_attention[olmoe-1b-7b]": olmoe["bucketed"]["flash_attention_dyn"],
                 "flash_attention[noncausal, whisper-small enc]": noncausal_launches}
    for arch in ("mixtral-8x22b", "pixtral-12b", "smollm-360m"):
        by_kernel[f"lmhead_greedy[{arch}]"] = families[arch]["fused_lmhead_greedy"]
    # phase 15a's runs; the attention records' launches as counted at each window
    by_kernel["lmhead_greedy[gemma3-4b]"] = gemma["chunked"]["fused_lmhead_greedy"]
    by_kernel["greedy_epilogue[gemma3-4b]"] = gemma["bucketed"]["greedy_epilogue"]
    for kernel, seen in gemma["windows"].items():
        for kind, window in (("local", gemma["local"]), ("global", -1)):
            by_kernel[f"{kernel}[gemma3-4b {kind}]"] = seen[window]
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
