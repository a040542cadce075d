"""Greedy epilogues: the CUDA kernels' wrappers and their plain versions.

Counterparts of ``fused_lmhead_greedy`` and ``greedy_epilogue`` in
``repro.kernels.sampling.ops``.  The fused lm-head's kernels live in
``csrc/lmhead_greedy.cu``, the greedy epilogue's in
``csrc/greedy_epilogue.cu`` (one launch of thread-block clusters, one
cluster a row).  :func:`lmhead_greedy_plain` is the fused lm-head in plain
PyTorch (an f32 ``h @ w``, then max, argmax and logsumexp);
:func:`greedy_epilogue_plain` is the same reduction over logits that
already exist.  :func:`lmhead_greedy_walk_plain` repeats the bf16 lm-head
kernel's order of work: persistent blocks walking vocab tiles, one partial
per block and row, and the fold that breaks equal maxima by the lower
index.  :func:`greedy_epilogue_split_plain` repeats the epilogue kernel's:
the slices of :func:`greedy_cluster_plan`, merged in rank order.  Each
wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.models.attention import NEG_INF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def greedy_epilogue_plain(logits):
    """logits: (B, V), any float dtype, cast to f32 -> (token (B,) int32,
    logprob (B,) f32): the first maximal index and ``max - logsumexp``, as
    the JAX jnp route computes."""
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


GREEDY_MAX_CLUSTER = 16      # kMaxCluster in csrc/greedy_epilogue.cu
GREEDY_MIN_SLICE = 1024      # logits a rank reads at the least, where C > 1
GREEDY_ROUND_BYTES = 256 * 8 * 16   # one round of a 256-thread CTA's loads (kLoads = 8)


def _split_slice(V: int, n_split: int) -> int:
    """Logits a rank owns: ceil(V / n_split) rounded up to 8, so every slice
    starts a multiple of 16 bytes after the row start, in f32 and bf16."""
    per_rank = -(-V // n_split)
    return -(-per_rank // 8) * 8


def greedy_cluster_plan(B: int, V: int, sm_count: int, max_cluster: int = GREEDY_MAX_CLUSTER,
                        elem_bytes: int = 4) -> tuple[int, int, int]:
    """(C, slice, threads) of the epilogue kernel: clusters of C CTAs of
    ``threads`` threads, one cluster a row, rank r reading logits
    [r * slice, (r + 1) * slice) of it.  C is the largest power of two up to
    ``max_cluster`` with B x C within one wave of ``sm_count`` SMs and at
    least ``GREEDY_MIN_SLICE`` logits a rank: 16 at B <= 8 for a vocabulary
    of 16384 or more, fewer as B grows.  CTAs are 512 threads where the
    clusters fill at most half the SMs and a slice of ``elem_bytes``-byte
    logits is at least one round of a 256-thread CTA's loads (B <= 4 at the
    largest vocabularies), else 256."""
    C = 1
    while 2 * C <= max_cluster and 2 * C * B <= sm_count and V >= 2 * C * GREEDY_MIN_SLICE:
        C *= 2
    width = _split_slice(V, C)
    wide = 2 * B * C <= sm_count and width * elem_bytes >= GREEDY_ROUND_BYTES
    return C, width, 512 if wide else 256


def greedy_epilogue_split_plain(logits, n_split: int):
    """Plain version of the epilogue kernel's order of work: each of
    ``n_split`` slices (:func:`_split_slice`) reduces to (max, first argmax,
    sum exp(x - max)); the slices merge in rank order, so equal maxima keep
    the lower index.  Returns (token (B,) int32, logprob (B,) f32) with
    logprob ``m - (m + log(max(l, 1e-30)))``.  Nothing on the serving path
    calls it."""
    x = logits.float()
    B, V = x.shape
    width = _split_slice(V, n_split)
    m = torch.full((B,), NEG_INF, device=x.device)
    l = torch.zeros((B,), device=x.device)
    i = torch.full((B,), torch.iinfo(torch.int32).max, dtype=torch.int64, device=x.device)
    for r in range(n_split):
        lo, hi = min(V, r * width), min(V, (r + 1) * width)
        if lo == hi:
            continue
        xs = x[:, lo:hi]
        sm = xs.amax(-1)
        sl = torch.exp(xs - sm[:, None]).sum(-1)
        mn = torch.maximum(m, sm)
        l = l * torch.exp(m - mn) + sl * torch.exp(sm - mn)
        i = torch.where(sm > m, xs.argmax(-1) + lo, i)
        m = mn
    return i.to(torch.int32), m - (m + torch.log(torch.clamp(l, min=1e-30)))


@functools.lru_cache(maxsize=None)
def _epilogue_kernel():
    lib = build.load("greedy_epilogue")
    fn = lib.greedy_epilogue
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    lib.greedy_active_clusters.argtypes = [ctypes.c_int]
    lib.greedy_active_clusters.restype = ctypes.c_int
    return fn, lib.greedy_active_clusters


@functools.lru_cache(maxsize=None)
def greedy_max_cluster(index: int) -> int:
    """16 if a cluster of 16 CTAs can be resident on card ``index``
    (``cudaOccupancyMaxActiveClusters``), else 8.  The query also allows
    clusters above 8 for the kernel on that card, once: the wrapper calls it
    before every launch."""
    with torch.cuda.device(index):
        n = _epilogue_kernel()[1](GREEDY_MAX_CLUSTER)
    if n < 0:
        raise RuntimeError(f"greedy_epilogue: cluster occupancy query failed: CUDA error {-n}")
    return GREEDY_MAX_CLUSTER if n >= 1 else 8


# replint-torch: traced -- called from the serving engine's step
def greedy_epilogue(logits):
    """logits: (B, V) float32 or bfloat16 -> (token (B,) int32, logprob (B,) f32).

    The greedy token (first maximal index) and its log-probability
    ``max - logsumexp``; the normalized (B, V) log-probs are never written.
    Rows may be strided and need not start 16-byte aligned; the vocab dim
    must be contiguous.  On the CPU any float dtype goes to the plain
    version, cast to f32 as in the JAX package.
    """
    if not logits.is_cuda:
        return greedy_epilogue_plain(logits)
    refuse_grad("greedy_epilogue", logits)
    if logits.dtype not in _DTYPE_CODE or logits.dim() != 2:
        raise TypeError(f"greedy_epilogue: logits must be (B, V) float32 or bfloat16, got "
                        f"{tuple(logits.shape)} {logits.dtype}")
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    N, V = logits.shape
    index = logits.device.index
    fn, _ = _epilogue_kernel()
    C, width, threads = greedy_cluster_plan(N, V, _sm_count(index), greedy_max_cluster(index),
                                            logits.element_size())
    tok = torch.empty((N,), dtype=torch.int32, device=logits.device)
    lp = torch.empty((N,), dtype=torch.float32, device=logits.device)
    if N:
        err = fn(_DTYPE_CODE[logits.dtype], logits.data_ptr(), logits.stride(0), N, V, C, width,
                 threads, tok.data_ptr(), lp.data_ptr(),
                 torch.cuda.current_stream(logits.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"greedy_epilogue launch failed: CUDA error {err} (cluster {C}, "
                               f"slice {width}, {threads} threads)")
        greedy_epilogue.launches += 1
    return tok, lp


greedy_epilogue.launches = 0            # kernel launches, for the chip smoke run


def _partials(N, n_tiles, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((N, n_tiles), **f32), torch.empty((N, n_tiles), **f32),
            torch.empty((N, n_tiles), dtype=torch.int32, device=device),
            torch.empty((N,), dtype=torch.int32, device=device), torch.empty((N,), **f32))


def _check_bf16_head(h, w, d: int, V: int):
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


# replint-torch: traced -- called from the model's verify step
def fused_lmhead_greedy(h, w):
    """h: (..., d) hidden states; w: (d, V) lm-head weight (a tied head
    passes ``embed.T`` and the kernel reads the embedding rows).  float32:
    any strides; bfloat16: the layouts of :func:`_check_bf16_head`.

    Returns (token (...,) int32, logprob (...,) f32) for the greedy argmax of
    ``h @ w``; on the card the (N, V) logits are never materialized.
    """
    if not h.is_cuda:
        return lmhead_greedy_plain(h, w)
    refuse_grad("fused_lmhead_greedy", h, w)
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
           "greedy_epilogue", "greedy_epilogue_plain", "greedy_epilogue_split_plain",
           "greedy_cluster_plan", "LMHEAD_TILE_V"]
