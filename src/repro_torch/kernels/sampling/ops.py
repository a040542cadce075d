"""Fused lm-head + greedy epilogue: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``fused_lmhead_greedy`` in ``repro.kernels.sampling.ops``.
The kernel is ``csrc/lmhead_greedy.cu``; :func:`lmhead_greedy_plain` is the
same function in plain PyTorch (an f32 ``h @ w``, then max, argmax and
logsumexp).  The wrapper takes the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lmhead_greedy_plain(h, w):
    """h: (..., d); w: (d, V) -> (token (...,) int32, logprob (...,) f32) via
    the materialized f32 logits.  Ties go to the first maximal index."""
    lead = h.shape[:-1]
    logits = h.reshape(-1, h.shape[-1]).float() @ w.float()
    m = logits.amax(dim=-1)
    tok = logits.argmax(dim=-1).to(torch.int32)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    return tok.reshape(lead), (m - lse).reshape(lead)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("lmhead_greedy")
    fn = lib.lmhead_greedy
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lib.lmhead_tile_v.restype = ctypes.c_int
    return fn, int(lib.lmhead_tile_v())


def fused_lmhead_greedy(h, w):
    """h: (..., d) hidden states; w: (d, V) lm-head weight, any strides (a
    tied head passes ``embed.T`` and the kernel reads the embedding rows).

    Returns (token (...,) int32, logprob (...,) f32) for the greedy argmax of
    ``h @ w``; on the card the (N, V) logits are never materialized.
    """
    if not h.is_cuda:
        return lmhead_greedy_plain(h, w)
    lead = h.shape[:-1]
    d = h.shape[-1]
    if w.device != h.device:
        raise ValueError("fused_lmhead_greedy: h and w on different devices")
    if h.dtype not in _DTYPE_CODE or w.dtype != h.dtype:
        raise TypeError(f"fused_lmhead_greedy: dtypes h {h.dtype} w {w.dtype} "
                        "unsupported (float32 or bfloat16, the same for both)")
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"fused_lmhead_greedy: w {tuple(w.shape)} is not (d={d}, V)")
    hf = h.reshape(-1, d).contiguous()
    N, V = hf.shape[0], w.shape[1]
    fn, tile_v = _kernel()
    n_tiles = -(-V // tile_v)
    f32 = dict(dtype=torch.float32, device=h.device)
    pmax = torch.empty((N, n_tiles), **f32)
    psum = torch.empty((N, n_tiles), **f32)
    pidx = torch.empty((N, n_tiles), dtype=torch.int32, device=h.device)
    tok = torch.empty((N,), dtype=torch.int32, device=h.device)
    lp = torch.empty((N,), **f32)
    if N:
        err = fn(_DTYPE_CODE[h.dtype], hf.data_ptr(), w.data_ptr(),
                 w.stride(0), w.stride(1), N, d, V, pmax.data_ptr(),
                 psum.data_ptr(), pidx.data_ptr(), tok.data_ptr(), lp.data_ptr(),
                 torch.cuda.current_stream(h.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lmhead_greedy launch failed: CUDA error {err}")
        fused_lmhead_greedy.launches += 1
    return tok.reshape(lead), lp.reshape(lead)


fused_lmhead_greedy.launches = 0        # kernel launches, for the chip smoke run


__all__ = ["fused_lmhead_greedy", "lmhead_greedy_plain"]
