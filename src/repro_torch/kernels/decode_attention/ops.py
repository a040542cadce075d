"""Mixed-span paged attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``decode_attention_mixed`` in
``repro.kernels.decode_attention.ops``.  The kernel is
``csrc/paged_mixed_attention.cu``; :func:`paged_mixed_attention_plain` is
the same function in plain PyTorch (gather + span mask + sdpa, the
``use_kernel=False`` branch of the JAX ``lm.block_verify``).  The wrapper
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import sdpa
from repro_torch.serving.kvcache import _span_mask, paged_gather

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_mixed_attention_plain(q, k_pages, v_pages, block_table, starts, *,
                                window: int = -1, k_scale=None, v_scale=None):
    """Plain version: gather each row's pages into a dense view, dequantize
    int8 pages to q's dtype, mask per query, attend.  Shapes as in
    :func:`decode_attention_mixed`."""
    k = paged_gather(k_pages, block_table)
    v = paged_gather(v_pages, block_table)
    if k_scale is not None:
        k = (k.float() * paged_gather(k_scale, block_table)).to(q.dtype)
        v = (v.float() * paged_gather(v_scale, block_table)).to(q.dtype)
    mask = _span_mask(k.shape[1], starts, q.shape[1], window)
    return sdpa(q, k, v, mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("paged_mixed_attention").paged_mixed_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention_mixed(q, k_pages, v_pages, block_table, starts, *,
                           window: int | None = -1, k_scale=None, v_scale=None):
    """Mixed-span block-table attention over a paged KV pool.

    q: (B, T, Hq, D) -- T consecutive queries per row, the first at logical
    position ``starts[b]``; pages: (P, page_size, Hkv, D), float32 / bf16 like
    q, or int8 with ``k_scale``/``v_scale`` (P, page_size, Hkv, 1) float32;
    block_table: (B, n) int32; starts: (B,); ``window``: sliding-window width,
    -1 or None = unlimited.  The span's own KV must be written before the
    call.  Returns (B, T, Hq, D) in q's dtype.
    """
    window = -1 if window is None else int(window)
    if not q.is_cuda:
        return paged_mixed_attention_plain(q, k_pages, v_pages, block_table,
                                           starts, window=window,
                                           k_scale=k_scale, v_scale=v_scale)
    B, T, Hq, D = q.shape
    P, ps, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    int8 = k_scale is not None
    tensors = [q, k_pages, v_pages, block_table, starts]
    if int8:
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention_mixed: tensors on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention_mixed: q dtype {q.dtype} unsupported")
    if k_pages.dtype != (torch.int8 if int8 else q.dtype) or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"decode_attention_mixed: pages {k_pages.dtype} do not "
                        f"match q {q.dtype} (int8 pages need scales)")
    if (k_pages.shape != (P, ps, Hkv, D) or v_pages.shape != k_pages.shape
            or Hq % Hkv or block_table.dim() != 2 or block_table.shape[0] != B
            or starts.shape != (B,)):
        raise ValueError("decode_attention_mixed: inconsistent shapes "
                         f"q {tuple(q.shape)} pages {tuple(k_pages.shape)} "
                         f"table {tuple(block_table.shape)} starts {tuple(starts.shape)}")
    if int8 and (k_scale.shape != (P, ps, Hkv, 1) or v_scale.shape != k_scale.shape
                 or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("decode_attention_mixed: scales must be (P, ps, Hkv, 1) float32")
    if not all(t.is_contiguous() for t in (k_pages, v_pages)) or (
            int8 and not (k_scale.is_contiguous() and v_scale.is_contiguous())):
        raise ValueError("decode_attention_mixed: page pools must be contiguous")
    q = q.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _kernel()(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        tbl.data_ptr(), st.data_ptr(), out.data_ptr(),
        B, T, Hq, Hkv, D, ps, tbl.shape[1], window, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_mixed_attention launch failed: CUDA error {err}")
    decode_attention_mixed.launches += 1
    return out


decode_attention_mixed.launches = 0     # kernel launches, for the chip smoke run


__all__ = ["decode_attention_mixed", "paged_mixed_attention_plain"]
