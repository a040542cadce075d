"""Greedy epilogues: the CUDA kernels' wrappers and their plain versions.

Counterparts of ``fused_lmhead_greedy`` and ``greedy_epilogue`` in
``repro.kernels.sampling.ops``.  Both kernels live in
``csrc/lmhead_greedy.cu`` and share its fold pass.
:func:`lmhead_greedy_plain` is the fused lm-head in plain PyTorch (an f32
``h @ w``, then max, argmax and logsumexp); :func:`greedy_epilogue_plain`
is the same reduction over logits that already exist.
:func:`lmhead_greedy_walk_plain` repeats the bf16 kernel's order of work:
persistent blocks walking vocab tiles, one partial per block and row, and
the fold that breaks equal maxima by the lower index.  Each wrapper takes
the plain version only for tensors on the CPU; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import NEG_INF

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


LMHEAD_TILE_V = 128          # the bf16 kernel's vocab tile (kVT in csrc/lmhead_greedy.cu)


def lmhead_greedy_walk_plain(h, w, *, n_blocks: int, tile_v: int = LMHEAD_TILE_V):
    """Plain version of the bf16 kernel's walk: f32 logits cut into vocab
    tiles of ``tile_v``; block j takes tiles j, j + n_blocks, ... and keeps
    per row its (max, first argmax, sum exp(x - max)); the (N, n_blocks)
    partials, which are not in vocab order, fold with equal maxima going to
    the lower index.  Returns (token (...,) int32, logprob (...,) f32).
    Nothing on the serving path calls it."""
    lead = h.shape[:-1]
    x = h.reshape(-1, h.shape[-1]).float() @ w.float()
    N, V = x.shape
    tiles = -(-V // tile_v)
    pm = torch.full((N, n_blocks), NEG_INF, device=x.device)
    ps = torch.zeros((N, n_blocks), device=x.device)
    pi = torch.full((N, n_blocks), torch.iinfo(torch.int32).max, dtype=torch.int64,
                    device=x.device)
    for j in range(min(n_blocks, tiles)):
        cols = torch.cat([torch.arange(t * tile_v, min(V, (t + 1) * tile_v), device=x.device)
                          for t in range(j, tiles, n_blocks)])
        xs = x[:, cols]
        pm[:, j] = xs.amax(-1)
        pi[:, j] = cols[xs.argmax(-1)]         # columns ascend: the first maximum
        ps[:, j] = torch.exp(xs - pm[:, j:j + 1]).sum(-1)
    m = pm.amax(-1)
    first = torch.where(pm == m[:, None], pi, torch.iinfo(torch.int64).max).amin(-1)
    lse = m + torch.log((ps * torch.exp(pm - m[:, None])).sum(-1))
    return first.to(torch.int32).reshape(lead), (m - lse).reshape(lead)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("lmhead_greedy")
    fn = lib.lmhead_greedy
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lib.lmhead_partial_cols.argtypes = [ctypes.c_int] * 4
    lib.lmhead_partial_cols.restype = ctypes.c_int
    return fn, lib.lmhead_partial_cols


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check_bf16_head(h, w, d, V):
    """The bf16 tensor-core kernel's layouts: d % 16 == 0, 16-byte aligned
    h and w, and w either tied (``embed.T``: strides (1, s), s % 8 == 0) or
    untied ((d, V) with contiguous rows: strides (s, 1), s % 8 == 0 and
    V % 8 == 0)."""
    sd, sv = w.stride()
    tied = sd == 1 and sv % 8 == 0
    untied = sv == 1 and sd % 8 == 0 and V % 8 == 0
    if d % 16 or not (tied or untied):
        raise ValueError(f"fused_lmhead_greedy: bf16 w of shape {tuple(w.shape)} and strides "
                         f"{(sd, sv)} unsupported (d % 16 == 0; w tied, strides (1, s), or "
                         "untied, strides (s, 1) with V % 8 == 0; s % 8 == 0)")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_lmhead_greedy: h and w must be 16-byte aligned (the kernel "
                         "copies 16 bytes at a time)")


def fused_lmhead_greedy(h, w):
    """h: (..., d) hidden states; w: (d, V) lm-head weight (a tied head
    passes ``embed.T`` and the kernel reads the embedding rows).  float32:
    any strides; bfloat16: the layouts of :func:`_check_bf16_head`.

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
    if h.dtype == torch.bfloat16:
        _check_bf16_head(hf, w, d, V)
    fn, partial_cols = _kernel()
    cols = partial_cols(_DTYPE_CODE[h.dtype], N, V, _sm_count(h.device.index or 0))
    pmax, psum, pidx, tok, lp = _partials(N, cols, h.device)
    if N:
        err = fn(_DTYPE_CODE[h.dtype], hf.data_ptr(), w.data_ptr(),
                 w.stride(0), w.stride(1), N, d, V, cols, pmax.data_ptr(),
                 psum.data_ptr(), pidx.data_ptr(), tok.data_ptr(), lp.data_ptr(),
                 torch.cuda.current_stream(h.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lmhead_greedy launch failed: CUDA error {err}")
        fused_lmhead_greedy.launches += 1
    return tok.reshape(lead), lp.reshape(lead)


fused_lmhead_greedy.launches = 0        # kernel launches, for the chip smoke run


__all__ = ["fused_lmhead_greedy", "lmhead_greedy_plain", "lmhead_greedy_walk_plain",
           "greedy_epilogue", "greedy_epilogue_plain", "LMHEAD_TILE_V"]
