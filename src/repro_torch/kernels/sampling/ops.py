"""Greedy epilogues: the CUDA kernels' wrappers and their plain versions.

Counterparts of ``fused_lmhead_greedy`` and ``greedy_epilogue`` in
``repro.kernels.sampling.ops``.  Both kernels live in
``csrc/lmhead_greedy.cu`` and share its fold pass.
:func:`lmhead_greedy_plain` is the fused lm-head in plain PyTorch (an f32
``h @ w``, then max, argmax and logsumexp); :func:`greedy_epilogue_plain`
is the same reduction over logits that already exist.  Each wrapper takes
the plain version only for tensors on the CPU; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def greedy_epilogue_plain(logits):
    """logits: (B, V) -> (token (B,) int32, logprob (B,) f32): the first
    maximal index and ``max - logsumexp``, as the JAX jnp route computes."""
    x = logits.float()
    m = x.amax(dim=-1)
    tok = x.argmax(dim=-1).to(torch.int32)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
    return tok, m - lse


def lmhead_greedy_plain(h, w):
    """h: (..., d); w: (d, V) -> (token (...,) int32, logprob (...,) f32) via
    the materialized f32 logits.  Ties go to the first maximal index."""
    lead = h.shape[:-1]
    tok, lp = greedy_epilogue_plain(h.reshape(-1, h.shape[-1]).float() @ w.float())
    return tok.reshape(lead), lp.reshape(lead)


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


@functools.lru_cache(maxsize=None)
def _epilogue_kernel():
    lib = build.load("lmhead_greedy")
    fn = lib.greedy_epilogue
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lib.greedy_tile_v.restype = ctypes.c_int
    return fn, int(lib.greedy_tile_v())


def _partials(N, n_tiles, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((N, n_tiles), **f32), torch.empty((N, n_tiles), **f32),
            torch.empty((N, n_tiles), dtype=torch.int32, device=device),
            torch.empty((N,), dtype=torch.int32, device=device), torch.empty((N,), **f32))


def greedy_epilogue(logits):
    """logits: (B, V) float32 -> (token (B,) int32, logprob (B,) f32).

    The greedy token (first maximal index) and its log-probability
    ``max - logsumexp``; the normalized (B, V) log-probs are never written.
    Rows may be strided; the vocab dim must be contiguous.
    """
    if not logits.is_cuda:
        return greedy_epilogue_plain(logits)
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise TypeError(f"greedy_epilogue: logits must be (B, V) float32, got "
                        f"{tuple(logits.shape)} {logits.dtype}")
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    N, V = logits.shape
    fn, tile = _epilogue_kernel()
    pmax, psum, pidx, tok, lp = _partials(N, -(-V // tile), logits.device)
    if N:
        err = fn(logits.data_ptr(), logits.stride(0), N, V, pmax.data_ptr(),
                 psum.data_ptr(), pidx.data_ptr(), tok.data_ptr(), lp.data_ptr(),
                 torch.cuda.current_stream(logits.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"greedy_epilogue launch failed: CUDA error {err}")
        greedy_epilogue.launches += 1
    return tok, lp


greedy_epilogue.launches = 0            # kernel launches, for the chip smoke run


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
    pmax, psum, pidx, tok, lp = _partials(N, -(-V // tile_v), h.device)
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


__all__ = ["fused_lmhead_greedy", "lmhead_greedy_plain", "greedy_epilogue",
           "greedy_epilogue_plain"]
