"""Per-device defaults of the mixed serving step, keyed by ``device.type``,
and the sweeps that time the paged decode-attention kernels.

Counterpart of ``repro.kernels.decode_attention.autotune``.  ``page_size``
is the KV page, ``chunk_size`` the prefill tokens folded into one mixed step
per row, ``draft_len`` the speculative tokens proposed per row per step,
``lmhead_block_v`` the vocab tile of a streamed lm-head epilogue (0 = one
fused product, what the plain version does).

* ``"cpu"`` is the JAX package's ``"cpu"`` row, so the CPU parity tests run
  the reference's shapes.
* ``"cuda"`` starts from the same page, chunk and draft values; its
  ``lmhead_block_v`` is the vocab tile of the bf16 CUDA kernel the serving
  path runs (``kVT`` in ``csrc/lmhead_greedy.cu``; its f32 instance walks
  tiles of 64).  The sweeps below run on the card, but their choice is not
  written into this row: a swept row changes what the main path runs, and
  that change waits for a serving benchmark that can measure it
  (ROADMAP.md Queue 1, item 1).

:func:`sweep_page_size` and :func:`sweep_span_width` time the path the
device runs: on the card the CUDA kernels (:func:`decode_attention_paged`,
:func:`decode_attention_mixed`) with CUDA events after warm-up, on the CPU
their plain versions (gather + mask + sdpa, as the JAX sweep times its
gather route on the CPU).  The JAX package's ``sweep_block_k`` has no
counterpart: the CUDA kernels pick their splits from the shapes
(:func:`~repro_torch.kernels.decode_attention.ops.choose_pages_per_split`),
so :func:`pick_defaults` takes block rows only if given.
"""
from __future__ import annotations

import time
from statistics import median

import torch

DEFAULTS = {
    "cpu": {"page_size": 16, "chunk_size": 16, "draft_len": 3,
            "lmhead_block_v": 0},
    # not written from a sweep (see the module docstring)
    "cuda": {"page_size": 16, "chunk_size": 16, "draft_len": 3,
             "lmhead_block_v": 128},
}


def _row(device_type: str) -> dict:
    return DEFAULTS.get(device_type, DEFAULTS["cpu"])


def default_page_size(device_type: str = "cpu") -> int:
    return _row(device_type)["page_size"]


def default_chunk_size(device_type: str = "cpu") -> int:
    return _row(device_type)["chunk_size"]


def default_draft_len(device_type: str = "cpu") -> int:
    return _row(device_type)["draft_len"]


def default_lmhead_block_v(device_type: str = "cpu") -> int:
    return _row(device_type)["lmhead_block_v"]


# ---------------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------------

def _time_us(fn, *, reps: int, device: torch.device) -> float:
    """Median microseconds per call of ``fn`` after three warm-up calls: CUDA
    events around each call on the card, the host clock on the CPU.  On the
    card a spin kernel holds the stream first, so the host has enqueued the
    call before the start event runs: the events time the device, not the
    wrapper's launch."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda._sleep(1_000_000)          # ~0.5 ms at the H100's clocks
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(median(ts))


def _paged_inputs(gen, page_size, *, total_tokens, B, Hq, Hkv, D, dtype):
    """The same logical workload laid out for each page size: q (B, 1, Hq,
    D), pools of B * n + 2 pages, a shuffled table, every row full."""
    dev = gen.device
    n = max(total_tokens // page_size, 1)
    P = B * n + 2
    q = torch.randn((B, 1, Hq, D), generator=gen, device=dev).to(dtype)
    k_pages = torch.randn((P, page_size, Hkv, D), generator=gen, device=dev).to(dtype)
    v_pages = torch.randn((P, page_size, Hkv, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * n] + 1
    tbl = perm.reshape(B, n).to(torch.int32)
    lengths = torch.full((B,), n * page_size, dtype=torch.int32, device=dev)
    return q, k_pages, v_pages, tbl, lengths


def _device_and_dtype(device, dtype):
    from repro_torch.models.registry import resolve_device

    device = resolve_device(device)
    if dtype is None:     # what each device's serving path runs
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return device, dtype


def sweep_page_size(page_sizes=(8, 16, 32, 64), *, total_tokens: int = 256,
                    B: int = 4, Hq: int = 8, Hkv: int = 2, D: int = 64,
                    reps: int = 10, device=None, dtype=None) -> list[dict]:
    """Time one paged decode-attention step per page size (fixed logical
    cache length) on ``device`` (None: the GPU, which must exist; "cpu" times
    the plain version): rows ``{"page_size", "us_per_step", "backend"}``, the
    JAX sweep's keys (``backend`` is ``device.type``).
    ``dtype``: the pools' and q's, by default bf16 on the card (the serving
    path's kernel) and float32 on the CPU."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_paged, paged_decode_attention_plain)

    device, dtype = _device_and_dtype(device, dtype)
    fn = decode_attention_paged if device.type == "cuda" else paged_decode_attention_plain
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for ps in page_sizes:
        args = _paged_inputs(gen, ps, total_tokens=total_tokens, B=B, Hq=Hq, Hkv=Hkv,
                             D=D, dtype=dtype)
        us = _time_us(lambda: fn(*args), reps=reps, device=device)
        rows.append({"page_size": int(ps), "us_per_step": us, "backend": device.type})
    return rows


def sweep_span_width(widths=(1, 2, 4, 8, 16, 32), *, total_tokens: int = 256,
                     B: int = 4, Hq: int = 8, Hkv: int = 2, D: int = 64,
                     page_size: int | None = None, reps: int = 10, device=None,
                     dtype=None) -> list[dict]:
    """Time one mixed-span attention step per query width T on ``device``
    (as in :func:`sweep_page_size`): rows ``{"span_width", "us_per_step", "us_per_token", "backend"}``.

    ``us_per_token = us_per_step / T`` is the quantity chunk size and draft
    length trade against: a chunk of C tokens costs one T = C mixed row-step
    instead of C decode steps, and a draft of d tokens one T = d + 1 verify
    -- which pays only while the per-token cost still falls with T."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_mixed, paged_mixed_attention_plain)

    device, dtype = _device_and_dtype(device, dtype)
    fn = decode_attention_mixed if device.type == "cuda" else paged_mixed_attention_plain
    ps = page_size or default_page_size(device.type)
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for T in widths:
        q1, k_pages, v_pages, tbl, lengths = _paged_inputs(
            gen, ps, total_tokens=total_tokens, B=B, Hq=Hq, Hkv=Hkv, D=D, dtype=dtype)
        q = q1.expand(B, T, Hq, D).contiguous()
        starts = lengths - T
        us = _time_us(lambda: fn(q, k_pages, v_pages, tbl, starts), reps=reps,
                      device=device)
        rows.append({"span_width": int(T), "us_per_step": us, "us_per_token": us / T,
                     "backend": device.type})
    return rows


def pick_defaults(page_rows: list[dict], block_rows: list[dict] | None = None,
                  span_rows: list[dict] | None = None) -> dict:
    """Reduce sweeps to the fastest configuration, as the JAX package does:
    the fastest page size; with ``block_rows``, the fastest ``block_k``; with
    ``span_rows``, the width of least per-token cost as ``chunk_size`` and
    one less as ``draft_len`` (the verify block is d + 1 wide).
    ``backend`` is the page rows' device type."""
    best_ps = min(page_rows, key=lambda r: r["us_per_step"])
    out = {"backend": best_ps["backend"], "page_size": best_ps["page_size"]}
    if block_rows:
        out["block_k"] = min(block_rows, key=lambda r: r["us_per_step"])["block_k"]
    if span_rows:
        best_span = min(span_rows, key=lambda r: r["us_per_token"])
        out["chunk_size"] = best_span["span_width"]
        out["draft_len"] = max(best_span["span_width"] - 1, 1)
    return out


__all__ = ["DEFAULTS", "default_page_size", "default_chunk_size",
           "default_draft_len", "default_lmhead_block_v", "sweep_page_size",
           "sweep_span_width", "pick_defaults"]
