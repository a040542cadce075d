"""Mamba-2 SSD (state-space duality) block, chunked matmul formulation
(PyTorch).

Counterpart of ``repro.models.ssm``.  The sequence is split into chunks of
length Q and the recurrence becomes dense products plus a short loop over
chunk states:

  intra-chunk:  Y_intra = ((C B^T) .* decay_mask) X
  chunk state:  S_i     = sum_t a(t->end) B_t x_t
  inter-chunk:  S       = loop over chunks (decay^Q carry)
  inter out:    Y_inter = C_t a(start->t) S_{i-1}

With ``use_kernel`` only the intra-chunk term goes to
:func:`repro_torch.kernels.ssd.ops.ssd_intra` (the CUDA kernel on the card,
its plain version on the CPU); without it, to that plain version.  The rest
stays plain, as in the JAX package.  The model passes ``use_kernel=True``
to serve (the wrapper takes the plain version for CPU tensors) and False to
train, where autograd runs through the plain version on either device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import model_dim
from repro_torch.kernels.ssd.ops import ssd_intra, ssd_intra_plain
from repro_torch.models.common import SSMConfig


def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Group tensor -> per-head tensor along ``dim`` (each group repeated
    ``rep`` times in place, ``jnp.repeat``'s order).  One group becomes an
    ``expand`` view; more are materialised."""
    if t.shape[dim] == 1:
        shape = list(t.shape)
        shape[dim] = rep
        return t.expand(shape)
    return t.repeat_interleave(rep, dim=dim)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, *, use_kernel: bool = False,
                initial_state=None, return_state: bool = False):
    """SSD scan.

    x: (b, s, h, p) inputs per head; dt: (b, s, h) softplus-activated step
    sizes (> 0); A: (h,) negative decay rates; B/C: (b, s, g, n) input and
    output projections (state dim n, g groups); D: (h,) skip.  Returns
    y (b, s, h, p) in x's dtype, and the final state (b, h, p, n) float32 if
    ``return_state``.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    if s % chunk:
        padlen = chunk - s % chunk

        def pad(a):                      # dt = 0 rows are identity steps
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, padlen))

        x, dt, B, C = pad(x), pad(dt), pad(B), pad(C)
        s = s + padlen
    nc = s // chunk
    rep = h // g

    # fold dt into x and decay
    xb = (x * dt[..., None]).float().reshape(b, nc, chunk, h, p)
    a = (A[None, None, :] * dt).reshape(b, nc, chunk, h)          # negative
    Bh = _heads(B.reshape(b, nc, chunk, g, n).float(), rep, 3)    # (b, nc, q, h, n)
    Ch = _heads(C.reshape(b, nc, chunk, g, n).float(), rep, 3)

    # cumulative log-decay within a chunk
    acs = torch.cumsum(a, dim=2)                                  # (b, nc, q, h)

    # ---- intra-chunk (quadratic in the chunk length; the kernel's work) ----------
    y_intra = (ssd_intra if use_kernel else ssd_intra_plain)(xb, acs, Bh, Ch)

    # ---- chunk states --------------------------------------------------------------
    seg = torch.exp(acs[:, :, -1:, :] - acs)                      # decay t -> chunk end
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bh * seg[..., None], xb)
    chunk_decay = torch.exp(acs[:, :, -1, :])                     # (b, nc, h)

    # ---- inter-chunk recurrence (short loop over nc) --------------------------------
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                                        # the incoming state
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                        # (b, nc, h, p, n)

    # ---- inter-chunk output ----------------------------------------------------------
    dec_in = torch.exp(acs)                                       # decay start -> t
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch * dec_in[..., None], prev_states)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + x.float() * D[None, None, :, None]
    y = y[:, :s_orig].to(x.dtype)
    if return_state:
        return y, carry
    return y


def ssd_decode_step(x1, dt1, A, B1, C1, D, state):
    """Single-token recurrent update.

    x1: (b, h, p); dt1: (b, h); B1/C1: (b, g, n); state: (b, h, p, n)
    float32.  Returns (y (b, h, p) in x1's dtype, new_state).
    """
    h = x1.shape[1]
    rep = h // B1.shape[1]
    Bh = B1.repeat_interleave(rep, dim=1).float()                 # (b, h, n)
    Ch = C1.repeat_interleave(rep, dim=1).float()
    a = torch.exp(A[None] * dt1)                                  # (b, h)
    xd = (x1 * dt1[..., None]).float()
    new_state = state * a[..., None, None] + xd[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + x1.float() * D[None, :, None]
    return y.to(x1.dtype), new_state


def mamba2_block(x, params, cfg: SSMConfig, *, use_kernel: bool = False,
                 state=None, conv_state=None, decode: bool = False, g=None):
    """Full Mamba-2 mixer.

    x: (b, s, d).  params: w_z/w_x (d, d_in), w_bc (d, 2*g*n), w_dt (d, h),
    conv_x (w, d_in), conv_bc (w, 2*g*n), A_log (h,), D (h,), dt_bias (h,),
    norm (d_in,), out_proj (d_in, d).

    In decode mode s == 1 and (state, conv_state) carry the recurrence;
    conv_state: (b, w, d_in + 2*g*n).  Returns (y, new_state,
    new_conv_state).

    ``g``, a :class:`~repro_torch.distributed.tensor_parallel.ModelGroup`:
    the mixer split over ``model`` on its SSM heads.  ``w_z``, ``w_x``,
    ``w_dt``, ``conv_x``, ``A_log``, ``D``, ``dt_bias`` and ``norm`` hold
    the rank's heads (its ``d_in / mp`` channels) and the SSD runs on them;
    the replicated ``w_bc`` / ``conv_bc`` enter through ``copy_to_model``
    (B and C, one group, are computed on every rank; each rank's gradient
    of them is a share), as does x; the gated RMSNorm means over the whole ``d_in``, its
    sum of squares summed over ``model`` both ways; ``out_proj`` is
    row-parallel, its output summed over ``model``.  ``state`` is the
    rank's heads; ``conv_state`` is whole (the rules replicate it) and the
    rank reads its channels; the returned window is the rank's: its x
    channels, then B and C (a caller that keeps it gathers it whole).
    """
    b, s, d = x.shape
    d_in_all = cfg.expand * d
    d_in = params["w_x"].shape[1]
    h = params["w_dt"].shape[1]
    gn, n, w = cfg.n_groups, cfg.d_state, cfg.conv_width
    w_bc, conv_bc = params["w_bc"], params["conv_bc"]
    if g is not None:
        for name in ("w_z", "w_x", "conv_x", "norm", "out_proj"):
            tp.expect_block(params[name], model_dim(name), d_in_all, g)
        x = tp.copy_to_model(x, g)
        w_bc, conv_bc = tp.copy_to_model(w_bc, g), tp.copy_to_model(conv_bc, g)

    z = x @ params["w_z"]                                         # (b, s, d_in)
    xBC = torch.cat([x @ params["w_x"], x @ w_bc], dim=-1)
    dt = x @ params["w_dt"]
    dt = F.softplus(dt.float() + params["dt_bias"])               # (b, s, h)
    conv_w = torch.cat([params["conv_x"], conv_bc], dim=-1)

    # depthwise causal conv over (x, B, C)
    if decode:
        if g is not None:             # the rank's x channels and B, C of the window
            conv_state = torch.cat([conv_state[..., g.rank * d_in:(g.rank + 1) * d_in],
                                    conv_state[..., d_in_all:]], dim=-1)
        new_conv = torch.cat([conv_state[:, 1:], xBC[:, :1].to(conv_state.dtype)], dim=1)
        xBC = torch.einsum("bwc,wc->bc", new_conv, conv_w)[:, None]
        conv_out_state = new_conv
    else:
        pad = torch.zeros((b, w - 1, xBC.shape[-1]), dtype=xBC.dtype, device=x.device)
        xp = torch.cat([pad, xBC], dim=1)
        conv_out_state = xp[:, -w:].clone()     # the last w pre-conv inputs (decode
                                                # carry), not a view holding all of xp
        xBC = sum(xp[:, i:i + s] * conv_w[i][None, None] for i in range(w))
    xBC = F.silu(xBC)
    xs, B, C = torch.split(xBC, [d_in, gn * n, gn * n], dim=-1)
    A = -torch.exp(params["A_log"].float())                       # (h,) negative
    if decode:
        y, new_state = ssd_decode_step(
            xs.reshape(b, h, cfg.head_dim), dt[:, 0], A, B.reshape(b, gn, n),
            C.reshape(b, gn, n), params["D"], state)
        y = y.reshape(b, 1, d_in)
    else:
        y, new_state = ssd_chunked(
            xs.reshape(b, s, h, cfg.head_dim), dt, A, B.reshape(b, s, gn, n),
            C.reshape(b, s, gn, n), params["D"], cfg.chunk, use_kernel=use_kernel,
            initial_state=state, return_state=True)
        y = y.reshape(b, s, d_in)

    # gated RMSNorm (Mamba-2 normalizes y * silu(z)), over the whole d_in
    yz = y * F.silu(z)
    if g is None:
        var = yz.float().square().mean(dim=-1, keepdim=True)
    else:
        var = tp.sum_both_ways(yz.float().square().sum(dim=-1, keepdim=True), g) / d_in_all
    yz = (yz.float() * torch.rsqrt(var + 1e-5)).to(x.dtype)
    yz = yz * params["norm"]
    out = yz @ params["out_proj"]
    return (out if g is None else tp.sum_over_model(out, g)), new_state, conv_out_state


__all__ = ["ssd_chunked", "ssd_decode_step", "mamba2_block"]
