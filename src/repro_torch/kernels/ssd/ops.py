"""Mamba-2 SSD intra-chunk term: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro.kernels.ssd.ops.ssd_intra``.  The kernel is
``csrc/ssd_intra.cu``; :func:`ssd_intra_plain` is the same function in
plain PyTorch (the JAX oracle ``ssd_intra_ref`` in the model layout).  For
each (batch, chunk, head)::

    y[t] = sum_{u <= t} (C_t . B_u) exp(acs_t - acs_u) x[u]

The kernel runs two passes: the scores C.B^T once per group of heads, then
each head's decay and product with x (:func:`ssd_intra_grouped_plain` is
that order in plain PyTorch).  It finds the groups from the strides: when
``Bh`` and ``Ch`` repeat one group over every head with a zero head stride
(the ``expand`` view ``ssd_chunked`` passes for one group) the scores are
computed once for all heads; materialised heads are groups of one.  The
wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_grad


def _decay(acs):
    """L[b, c, t, u, h] = exp(acs_t - acs_u) for t >= u, else 0: acs
    (b, nc, q, h) -> (b, nc, q, q, h).  Above the diagonal exp(diff) may
    overflow to inf, so the value is selected, not multiplied by a mask;
    and the exponent is selected before the exp too, so the gradient there
    is 0, where the JAX package's ``where(tri, exp(diff), 0)`` gives
    0 * inf = NaN.  The values are the same bits."""
    q = acs.shape[2]
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]        # (b, nc, t, u, h)
    tri = torch.ones((q, q), dtype=torch.bool, device=acs.device).tril()[None, None, :, :, None]
    return torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)


def ssd_intra_plain(xb, acs, Bh, Ch):
    """Model layout: xb (b, nc, q, h, p); acs (b, nc, q, h); Bh/Ch
    (b, nc, q, h, n), all float32 -> y_intra (b, nc, q, h, p) float32."""
    scores = torch.einsum("bcthn,bcuhn->bctuh", Ch, Bh)
    return torch.einsum("bctuh,bcuhp->bcthp", scores * _decay(acs), xb.float())


def ssd_intra_grouped_plain(xb, acs, Bg, Cg):
    """Plain version of the kernel's two passes.  Model layout: xb
    (b, nc, q, h, p); acs (b, nc, q, h); the group tensors Bg/Cg
    (b, nc, q, G, n), head i reading group ``i // (h // G)`` (``jnp.repeat``'s
    order), all float32.  Pass 1 computes the scores C.B^T once per group;
    pass 2 applies each head's decay by select and multiplies by its x.
    Returns y_intra (b, nc, q, h, p) float32."""
    b, nc, q, h, p = xb.shape
    G = Bg.shape[3]
    scores = torch.einsum("bctgn,bcugn->bcgtu", Cg, Bg)          # once per group
    P = scores.repeat_interleave(h // G, dim=2) * _decay(acs).permute(0, 1, 4, 2, 3)
    return torch.einsum("bchtu,bcuhp->bcthp", P, xb.float())


def _groups(Bh, Ch):
    """(Bg, Cg) of shape (b, nc, q, G, n) and G: one group when both have a
    zero head stride (an ``expand`` view of one group), else one group a
    head."""
    if Bh.stride(3) == 0 and Ch.stride(3) == 0:
        return Bh[:, :, :, :1], Ch[:, :, :, :1], 1
    return Bh, Ch, Bh.shape[3]


def _rows16(t, last: int):
    """``t`` with its last dim zero-padded to ``last`` elements, contiguous
    along it, and every stride and its base 16-byte aligned, as the kernel's
    16-byte copies need; a view where ``t`` already is."""
    if t.shape[-1] != last:
        t = torch.nn.functional.pad(t, (0, last - t.shape[-1]))
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % 4 for s, d in zip(t.stride()[:-1], t.shape[:-1]) if d > 1)):
        t = t.contiguous()
    return t


def ssd_intra_grids(bc: int, q: int, h: int, p: int, G: int) -> tuple[int, int]:
    """(pass-1 blocks, pass-2 blocks) of one kernel call, as the CUDA side
    launches them: a block per (chunk, group, causal pair of 64-row tiles),
    then a block per (chunk, head, 64-column p tile, 32-row t-tile)."""
    nt = -(-q // 64)
    return nt * (nt + 1) // 2 * G * bc, h * -(-p // 64) * bc * -(-q // 32)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ssd_intra").ssd_intra
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# replint-torch: traced -- called from the model's prefill
def ssd_intra(xb, acs, Bh, Ch):
    """Intra-chunk SSD in the model layout: xb (b, nc, q, h, p); acs
    (b, nc, q, h); Bh/Ch (b, nc, q, h, n); all float32, any strides.
    When Bh and Ch have a zero head stride (one group, as ``ssd_chunked``
    passes it) the kernel computes the scores once for all heads.
    Returns a contiguous y_intra (b, nc, q, h, p) float32."""
    if not xb.is_cuda:
        return ssd_intra_plain(xb, acs, Bh, Ch)
    refuse_grad("ssd_intra", xb, acs, Bh, Ch)
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
    Bg, Cg, G = _groups(Bh, Ch)
    p4, n4 = -(-p // 4) * 4, -(-n // 4) * 4         # 16-byte rows

    def flat(t):
        return t.reshape((bc,) + t.shape[2:])           # a view unless strides forbid

    bf, cf = (flat(_rows16(t, n4)) for t in (Bg, Cg))
    xf, af = flat(_rows16(xb, p4)), flat(acs)
    qp = -(-q // 64) * 64
    y = torch.empty((bc, q, h, p4), dtype=torch.float32, device=xb.device)
    scores = torch.empty((bc, G, qp, qp), dtype=torch.float32, device=xb.device)
    strides = (ctypes.c_longlong * 12)(*bf.stride()[:3], *cf.stride()[:3],
                                       *xf.stride()[:3], *af.stride())
    if bc and q and h and p:
        err = _kernel()(xf.data_ptr(), af.data_ptr(), bf.data_ptr(), cf.data_ptr(),
                        y.data_ptr(), scores.data_ptr(), ctypes.addressof(strides),
                        bc, q, h, p4, n4, G,
                        torch.cuda.current_stream(xb.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ssd_intra launch failed: CUDA error {err}")
        ssd_intra.launches += 1
    if p4 != p:
        y = y[..., :p].contiguous()
    return y.reshape(b, nc, q, h, p)


ssd_intra.launches = 0                  # calls that launched the kernel, for the chip smoke run


__all__ = ["ssd_intra", "ssd_intra_grids", "ssd_intra_grouped_plain", "ssd_intra_plain"]
