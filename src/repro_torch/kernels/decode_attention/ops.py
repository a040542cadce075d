"""Decode attention: the CUDA kernels' wrappers and their plain versions.

Counterparts of ``decode_attention``, ``decode_attention_mixed`` and
``decode_attention_paged`` in ``repro.kernels.decode_attention.ops``:

* the dense one-query kernel ``csrc/dense_decode_attention.cu`` (one
  scalar ``pos`` over a dense (B, S, Hkv, D) cache, reached through
  ``attention.mha_decode(use_kernel=True)``);
  :func:`decode_attention_plain` is the masked sdpa of the JAX
  ``mha_decode`` with the kernel's rule for a row with no visible key;
* the mixed-span kernel ``csrc/paged_mixed_attention.cu`` (T queries per
  row, the chunked path); :func:`paged_mixed_attention_plain` is gather +
  span mask + sdpa, the ``use_kernel=False`` branch of the JAX
  ``lm.block_verify``.  Its bf16 instance splits each row's live pages
  into runs (:func:`split_plan`) and merges the runs' partial softmax
  sums; :func:`paged_mixed_attention_split_plain` is that two-pass
  arithmetic in plain PyTorch, for the CPU tests;
* the one-query decode kernel ``csrc/paged_decode_attention.cu`` (the
  bucketed path's decode loop); :func:`paged_decode_attention_plain` is
  gather + ``_vector_mask`` + sdpa, the ``use_kernel=False`` branch of the
  JAX ``lm.block_decode``.

Each wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import NEG_INF, sdpa
from repro_torch.serving.kvcache import _span_mask, _vector_mask, paged_gather

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# head dims of the dense decode kernel and of the bf16 mixed kernel (the f32
# mixed kernel takes any)
_HEAD_DIMS = (16, 32, 64, 80, 128, 256)


def _gather_kv(q, k_pages, v_pages, block_table, k_scale, v_scale):
    """Each row's pages as a dense (B, n * ps, Hkv, D) view, int8 pages
    dequantized to q's dtype."""
    k = paged_gather(k_pages, block_table)
    v = paged_gather(v_pages, block_table)
    if k_scale is not None:
        k = (k.float() * paged_gather(k_scale, block_table)).to(q.dtype)
        v = (v.float() * paged_gather(v_scale, block_table)).to(q.dtype)
    return k, v


def paged_mixed_attention_plain(q, k_pages, v_pages, block_table, starts, *,
                                window: int = -1, k_scale=None, v_scale=None):
    """Plain version: gather each row's pages into a dense view, dequantize
    int8 pages to q's dtype, mask per query, attend.  Shapes as in
    :func:`decode_attention_mixed`."""
    k, v = _gather_kv(q, k_pages, v_pages, block_table, k_scale, v_scale)
    mask = _span_mask(k.shape[1], starts, q.shape[1], window)
    return sdpa(q, k, v, mask)


# ---------------------------------------------------------------------------------
# the bf16 mixed kernel's split-K plan
# ---------------------------------------------------------------------------------

SPLIT_MIN_KEYS = 64          # the least keys a split covers (when the row has them)


def live_pages(start: int, T: int, ps: int, n: int, window: int) -> tuple[int, int]:
    """Pages ``[lo, hi)`` of a row that any of its T queries (positions
    ``start .. start + T - 1``) can see: the liveness test of the TPU
    kernel, as the CUDA kernel computes it from ``starts[b]``."""
    hi = min(n, (start + T - 1) // ps + 1)
    lo = max(0, start + 1 - window) // ps if window > 0 else 0
    return lo, hi


def choose_pages_per_split(B: int, Hkv: int, n: int, ps: int, sm_count: int) -> int:
    """Pages per split: at least :data:`SPLIT_MIN_KEYS` keys' worth, doubled
    while ``B * Hkv * splits`` stays at or above two blocks per SM, capped at
    the table width ``n``.  A function of shapes only, so the wrapper needs
    no host sync to pick it."""
    pps = min(max(1, -(-SPLIT_MIN_KEYS // ps)), max(n, 1))
    while pps < n and B * Hkv * -(-n // (2 * pps)) >= 2 * sm_count:
        pps *= 2
    return min(pps, max(n, 1))


def split_plan(starts, T: int, ps: int, n: int, window: int, sm_count: int, *,
               n_kv_heads: int = 1) -> tuple[int, list[list[tuple[int, int]]]]:
    """The bf16 kernel's split plan: ``(pages_per_split, runs)``, where
    ``runs[b]`` lists the live page range ``(lo, hi)`` of each split of row
    b that holds a live page, in order.  Split s covers table entries
    ``[s * pps, (s + 1) * pps)``; a block whose split holds no live page
    exits at once."""
    starts = [int(s) for s in starts]
    window = -1 if window is None else int(window)
    pps = choose_pages_per_split(len(starts), n_kv_heads, n, ps, sm_count)
    return pps, [_split_runs(*live_pages(s, T, ps, n, window), pps) for s in starts]


def _split_runs(lo: int, hi: int, pps: int) -> list[tuple[int, int]]:
    """The live page range ``(lo', hi')`` of each split that holds a page of
    ``[lo, hi)``, split s covering table entries ``[s * pps, (s + 1) * pps)``."""
    if hi <= lo:
        return []
    return [(max(lo, s * pps), min(hi, (s + 1) * pps))
            for s in range(lo // pps, (hi - 1) // pps + 1)]


def paged_mixed_attention_split_plain(q, k_pages, v_pages, block_table, starts, *,
                                      window: int = -1, k_scale=None, v_scale=None,
                                      pages_per_split: int = 1):
    """Plain version of the bf16 kernel's two-pass arithmetic: per row and
    split, f32 partials ``(m, l, acc)`` over the split's live pages (a query
    that sees no key there has ``l = 0``), then the log-sum-exp merge.
    Pages are dequantized to q's dtype as in
    :func:`paged_mixed_attention_plain`.  Nothing on the serving path calls
    it; ``starts`` is read on the host."""
    B, T, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    n = block_table.shape[1]
    group = Hq // Hkv
    window = -1 if window is None else int(window)
    k, v = _gather_kv(q, k_pages, v_pages, block_table, k_scale, v_scale)
    out = torch.zeros_like(q)
    for b, start in enumerate(int(s) for s in starts.tolist()):
        lo, hi = live_pages(start, T, ps, n, window)
        qf = (q[b].float() * D ** -0.5).reshape(T, Hkv, group, D)
        q_pos = start + torch.arange(T)[:, None]
        parts = []
        for pa, pe in _split_runs(lo, hi, pages_per_split):
            k_pos = torch.arange(pa * ps, pe * ps)[None, :]
            valid = k_pos <= q_pos
            if window > 0:
                valid &= k_pos > q_pos - window
            sc = torch.einsum("thgd,khd->hgtk", qf, k[b, pa * ps:pe * ps].float())
            sc = torch.where(valid, sc, torch.full_like(sc, -torch.inf))
            m = sc.amax(-1).clamp_min(NEG_INF)            # the kernel's finite start
            p = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
            acc = torch.einsum("hgtk,khd->hgtd", p, v[b, pa * ps:pe * ps].float())
            parts.append((m, p.sum(-1), acc))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = sum(l_ * torch.exp(m - M) for m, l_, _ in parts)
        A = sum(acc * torch.exp(m - M)[..., None] for m, _, acc in parts)
        o = A / L.clamp_min(1e-30)[..., None]             # (Hkv, group, T, D)
        out[b] = o.permute(2, 0, 1, 3).reshape(T, Hq, D).to(q.dtype)
    return out


def paged_decode_attention_plain(q1, k_pages, v_pages, block_table, lengths, *,
                                 window: int = -1, k_scale=None, v_scale=None):
    """Plain version of :func:`decode_attention_paged`: gather, dequantize,
    mask keys ``[lengths - window, lengths)`` per row, attend."""
    k, v = _gather_kv(q1, k_pages, v_pages, block_table, k_scale, v_scale)
    mask = _vector_mask(k.shape[1], lengths.long() - 1, window)
    return sdpa(q1, k, v, mask)


def _check_pool(name, q, k_pages, v_pages, block_table, rows, k_scale, v_scale):
    """Device, dtype, shape and layout checks shared by both kernels."""
    D = q.shape[-1]
    P, ps, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    int8 = k_scale is not None
    tensors = [q, k_pages, v_pages, block_table, rows]
    if int8:
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q dtype {q.dtype} unsupported")
    if k_pages.dtype != (torch.int8 if int8 else q.dtype) or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: pages {k_pages.dtype} do not match q {q.dtype} "
                        "(int8 pages need scales)")
    B, Hq = q.shape[0], q.shape[-2]
    if (k_pages.shape != (P, ps, Hkv, D) or v_pages.shape != k_pages.shape
            or Hq % Hkv or block_table.dim() != 2 or block_table.shape[0] != B
            or rows.shape != (B,)):
        raise ValueError(f"{name}: inconsistent shapes q {tuple(q.shape)} "
                         f"pages {tuple(k_pages.shape)} table {tuple(block_table.shape)} "
                         f"rows {tuple(rows.shape)}")
    if int8 and (k_scale.shape != (P, ps, Hkv, 1) or v_scale.shape != k_scale.shape
                 or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError(f"{name}: scales must be (P, ps, Hkv, 1) float32")
    if not all(t.is_contiguous() for t in (k_pages, v_pages)) or (
            int8 and not (k_scale.is_contiguous() and v_scale.is_contiguous())):
        raise ValueError(f"{name}: page pools must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("paged_mixed_attention").paged_mixed_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_mixed(q, k_pages, v_pages, block_table, starts, *,
                           window: int | None = -1, k_scale=None, v_scale=None):
    """Mixed-span block-table attention over a paged KV pool.

    q: (B, T, Hq, D) -- T consecutive queries per row, the first at logical
    position ``starts[b]``; pages: (P, page_size, Hkv, D), float32 / bf16 like
    q, or int8 with ``k_scale``/``v_scale`` (P, page_size, Hkv, 1) float32;
    block_table: (B, n) int32; starts: (B,); ``window``: sliding-window width,
    -1 or None = unlimited.  The span's own KV must be written before the
    call.  The bf16 kernel splits each row's pages as
    :func:`choose_pages_per_split` picks; the f32 kernel does not split.
    Returns (B, T, Hq, D) in q's dtype.
    """
    window = -1 if window is None else int(window)
    if not q.is_cuda:
        return paged_mixed_attention_plain(q, k_pages, v_pages, block_table,
                                           starts, window=window,
                                           k_scale=k_scale, v_scale=v_scale)
    B, T, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    int8 = k_scale is not None
    _check_pool("decode_attention_mixed", q, k_pages, v_pages, block_table, starts,
                k_scale, v_scale)
    q = q.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    n = tbl.shape[1]
    pps = n_splits = 0
    part_ml = part_acc = None
    if q.dtype == torch.bfloat16:               # the split-K tensor-core kernel
        if D not in _HEAD_DIMS:
            raise ValueError(f"decode_attention_mixed: bf16 head dim {D} unsupported "
                             f"(one of {_HEAD_DIMS})")
        if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
            raise ValueError("decode_attention_mixed: q and the page pools must be "
                             "16-byte aligned (the kernel copies 16 bytes at a time)")
        pps = choose_pages_per_split(B, Hkv, n, ps, _sm_count(q.device.index or 0))
        n_splits = -(-n // pps)
        rows = T * (Hq // Hkv)
        part_ml = torch.empty((B, Hkv, n_splits, rows, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B, Hkv, n_splits, rows, D), dtype=torch.float32,
                               device=q.device)
    if not (B and T):
        return out
    err = _kernel()(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        tbl.data_ptr(), st.data_ptr(), out.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        B, T, Hq, Hkv, D, ps, n, window, D ** -0.5, pps, n_splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_mixed_attention launch failed: CUDA error {err}")
    decode_attention_mixed.launches += 1
    return out


decode_attention_mixed.launches = 0     # kernel launches, for the chip smoke run


@functools.lru_cache(maxsize=None)
def _decode_kernel():
    fn = build.load("paged_decode_attention").paged_decode_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention_paged(q1, k_pages, v_pages, block_table, lengths, *,
                           window: int | None = -1, k_scale=None, v_scale=None):
    """Block-table decode attention over a paged KV pool.

    q1: (B, 1, Hq, D); pages: (P, page_size, Hkv, D), float32 / bf16 like q1,
    or int8 with ``k_scale``/``v_scale`` (P, page_size, Hkv, 1) float32;
    block_table: (B, n) int32 (logical page i of row b lives in physical page
    ``block_table[b, i]``; entries past a row's live pages may point
    anywhere); lengths: (B,) valid logical entries per row, the current
    token included; ``window``: -1 or None = unlimited.  Returns
    (B, 1, Hq, D) in q1's dtype.
    """
    window = -1 if window is None else int(window)
    if not q1.is_cuda:
        return paged_decode_attention_plain(q1, k_pages, v_pages, block_table,
                                            lengths, window=window,
                                            k_scale=k_scale, v_scale=v_scale)
    if q1.dim() != 4 or q1.shape[1] != 1:
        raise ValueError(f"decode_attention_paged: q1 {tuple(q1.shape)} is not (B, 1, Hq, D)")
    B, _, Hq, D = q1.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    int8 = k_scale is not None
    _check_pool("decode_attention_paged", q1, k_pages, v_pages, block_table, lengths,
                k_scale, v_scale)
    q = q1.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _decode_kernel()(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, ps, tbl.shape[1], window, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {err}")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0     # kernel launches, for the chip smoke run


# ---------------------------------------------------------------------------------
# dense cache, one scalar position (attention.mha_decode)
# ---------------------------------------------------------------------------------

def _dense_span(S: int, pos: int, window: int) -> tuple[int, int]:
    """Visible keys ``[lo, hi)`` of a dense cache of S positions."""
    return (max(pos - window, 0) if window > 0 else 0), min(pos, S)


def decode_attention_plain(q1, k_cache, v_cache, pos, *, window: int = -1):
    """Plain version of :func:`decode_attention`: keys ``k < pos`` (and
    ``k >= pos - window`` when ``window`` > 0) through the masked sdpa.  A
    row with no visible key (``pos <= 0``) gives zeros, as the kernel's
    denominator clamp does."""
    pos, window = int(pos), int(window)
    S = k_cache.shape[1]
    lo, hi = _dense_span(S, pos, window)
    if hi <= lo:
        return torch.zeros_like(q1)
    k_pos = torch.arange(S, device=q1.device)
    valid = (k_pos >= lo) & (k_pos < hi)
    return sdpa(q1, k_cache, v_cache, valid[None, :])


@functools.lru_cache(maxsize=None)
def _dense_kernel():
    fn = build.load("dense_decode_attention").dense_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q1, k_cache, v_cache, pos, *, window: int | None = None,
                     block_k: int | None = None):
    """One query per row over a dense cache, all rows at one position.

    q1: (B, 1, Hq, D); caches: (B, S, Hkv, D), contiguous, float32 or bf16
    like q1; ``pos``: the number of valid entries (the new token's KV
    written at ``pos - 1``), an int or a 0-d tensor shared by every row;
    ``window``: sliding-window width, falsy = none.  ``block_k`` is the TPU
    kernel's key-tile width, accepted for signature parity; the CUDA kernel
    picks its own chunk.  Returns (B, 1, Hq, D) in q1's dtype.
    """
    window = int(window) if window else -1
    pos = int(pos)
    if not q1.is_cuda:
        return decode_attention_plain(q1, k_cache, v_cache, pos, window=window)
    if q1.dim() != 4 or q1.shape[1] != 1:
        raise ValueError(f"decode_attention: q1 {tuple(q1.shape)} is not (B, 1, Hq, D)")
    B, _, Hq, D = q1.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.device != q1.device or v_cache.device != q1.device:
        raise ValueError("decode_attention: tensors on different devices")
    if q1.dtype not in (torch.float32, torch.bfloat16) or k_cache.dtype != q1.dtype \
            or v_cache.dtype != q1.dtype:
        raise TypeError(f"decode_attention: dtypes q {q1.dtype} k {k_cache.dtype} "
                        f"v {v_cache.dtype} unsupported (float32 or bfloat16, alike)")
    if (k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape or Hq % Hkv
            or D not in _HEAD_DIMS):
        raise ValueError(f"decode_attention: shapes q {tuple(q1.shape)} "
                         f"cache {tuple(k_cache.shape)} unsupported "
                         f"(head dim in {_HEAD_DIMS})")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or (
            k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError("decode_attention: caches must be contiguous and 16-byte "
                         "aligned (the kernel stages rows with 16-byte copies)")
    q = q1.contiguous()
    out = torch.empty_like(q)
    if B:
        err = _dense_kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), B, S, Hq, Hkv, D, pos, window, D ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dense_decode_attention launch failed: CUDA error {err}")
        decode_attention.launches += 1
    return out


decode_attention.launches = 0           # kernel launches, for the chip smoke run


__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_mixed", "paged_mixed_attention_plain",
           "paged_mixed_attention_split_plain", "split_plan",
           "choose_pages_per_split", "live_pages",
           "decode_attention_paged", "paged_decode_attention_plain"]
