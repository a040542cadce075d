"""Mamba-2 SSD intra-chunk term: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro.kernels.ssd.ops.ssd_intra``.  The kernel is
``csrc/ssd_intra.cu``; :func:`ssd_intra_plain` is the same function in
plain PyTorch (the JAX oracle ``ssd_intra_ref`` in the model layout).  For
each (batch, chunk, head)::

    y[t] = sum_{u <= t} (C_t . B_u) exp(acs_t - acs_u) x[u]

The kernel reads its inputs through their strides, so ``Bh``/``Ch`` may be
views that repeat the group tensors over heads (an ``expand`` when there is
one group).  The wrapper takes the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def ssd_intra_plain(xb, acs, Bh, Ch):
    """Model layout: xb (b, nc, q, h, p); acs (b, nc, q, h); Bh/Ch
    (b, nc, q, h, n), all float32 -> y_intra (b, nc, q, h, p) float32."""
    q = xb.shape[2]
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]        # (b, nc, t, u, h)
    tri = torch.ones((q, q), dtype=torch.bool, device=xb.device).tril()
    # select, don't multiply: above the diagonal exp(diff) may overflow to inf
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bcthn,bcuhn->bctuh", Ch, Bh)
    return torch.einsum("bctuh,bcuhp->bcthp", scores * L, xb.float())


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ssd_intra").ssd_intra
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra(xb, acs, Bh, Ch):
    """Intra-chunk SSD in the model layout: xb (b, nc, q, h, p); acs
    (b, nc, q, h); Bh/Ch (b, nc, q, h, n); all float32, any strides.
    Returns a contiguous y_intra (b, nc, q, h, p) float32."""
    if not xb.is_cuda:
        return ssd_intra_plain(xb, acs, Bh, Ch)
    b, nc, q, h, p = xb.shape
    n = Bh.shape[-1]
    tensors = (xb, acs, Bh, Ch)
    if any(t.device != xb.device for t in tensors):
        raise ValueError("ssd_intra: tensors on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_intra: every input must be float32, as in the JAX function")
    if acs.shape != (b, nc, q, h) or Bh.shape != (b, nc, q, h, n) or Ch.shape != Bh.shape:
        raise ValueError(f"ssd_intra: inconsistent shapes xb {tuple(xb.shape)} "
                         f"acs {tuple(acs.shape)} Bh {tuple(Bh.shape)} Ch {tuple(Ch.shape)}")
    bc = b * nc

    def flat(t):
        return t.reshape((bc,) + t.shape[2:])           # a view unless strides forbid

    xf, af, bf, cf = (flat(t) for t in tensors)
    y = torch.empty((bc, q, h, p), dtype=torch.float32, device=xb.device)
    strides = (ctypes.c_longlong * 15)(*xf.stride(), *af.stride(), *bf.stride(),
                                       *cf.stride())
    if bc and q and h and p:
        err = _kernel()(xf.data_ptr(), af.data_ptr(), bf.data_ptr(), cf.data_ptr(),
                        y.data_ptr(), ctypes.addressof(strides), bc, q, h, p, n,
                        torch.cuda.current_stream(xb.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ssd_intra launch failed: CUDA error {err}")
        ssd_intra.launches += 1
    return y.reshape(b, nc, q, h, p)


ssd_intra.launches = 0                  # kernel launches, for the chip smoke run


__all__ = ["ssd_intra", "ssd_intra_plain"]
