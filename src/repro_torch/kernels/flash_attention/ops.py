"""Flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention.ops``.  The kernel is
``csrc/flash_attention.cu``; :func:`flash_attention_plain` is the same
function in plain PyTorch (a causal and/or window mask and sdpa, the
``use_kernel=False`` branch of the JAX ``lm._prefill_attention`` and
``attention.mha_prefill``).  Both take the JAX kernel's ``causal`` flag;
the window stays one-sided (key j visible to query i iff j > i - window)
in either mode.  The
public layout is the JAX one, (B, S, H, D) in and out; the kernel reads it
through its strides, with no transposed copy.  The wrapper takes the plain
version only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.models.attention import attention_mask, sdpa

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 80, 128, 256)


def flash_attention_plain(q, k, v, window: int = -1, *, causal: bool = True):
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D): causal (or
    full) attention, minus the sliding window when ``window`` > 0."""
    S = q.shape[1]
    mask = attention_mask(S, S, causal=causal, window=window if window > 0 else None,
                          device=q.device)
    return sdpa(q, k, v, mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _readable(t) -> bool:
    """Whether the kernel reads ``t`` in place: the head dim contiguous and,
    for bf16 (16-byte copies of 8 elements), every row 16-byte aligned."""
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]))


def _flash(q, k, v, window: int, causal: bool):
    """The kernel's launch (the plain version for CPU tensors)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window, causal=causal)
    refuse_grad("flash_attention", q, k, v)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q {q.dtype} k {k.dtype} v {v.dtype} "
                        "unsupported (float32 or bfloat16, the same for all)")
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv
            or D not in _HEAD_DIMS):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} unsupported (head dim in {_HEAD_DIMS})")
    q, k, v = (t if _readable(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))
    if B and S:
        err = _kernel()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), ctypes.addressof(strides), B, S, Hq, Hkv, D,
                        window, int(causal), D ** -0.5,
                        torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
        flash_attention_dyn.launches += 1
    return out


# replint-torch: traced -- called from the model's prefill
def flash_attention_dyn(q, k, v, window: int):
    """Runtime-window causal attention, as the prefill layer loop calls it.

    q: (B, S, Hq, D); k/v: (B, S, Hkv, D), float32 or bf16 alike, the head
    dim contiguous (a bf16 view whose rows are not 16-byte aligned is
    copied first); ``window``: int, <= 0 = full causal.  Returns a
    contiguous (B, S, Hq, D) in q's dtype.
    """
    return _flash(q, k, v, int(window), True)


flash_attention_dyn.launches = 0        # kernel launches (both entry points), for the chip smoke run


# replint-torch: traced -- called from the model's prefill
def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """Static-window form of :func:`flash_attention_dyn` (None = no
    window), causal or not: the JAX signature, which
    ``attention.mha_prefill`` calls."""
    return _flash(q, k, v, window or -1, bool(causal))


__all__ = ["flash_attention", "flash_attention_dyn", "flash_attention_plain"]
