"""PyTorch port, ``attention.mha_prefill`` and the flash kernel's non-causal
mode: the plain versions against the JAX package at float32 (2e-5), causal
and not, with and without a window, GQA group 3, and unequal query and key
lengths on the plain route.  The JAX ``use_kernel`` route runs its Pallas
flash kernel in interpret mode on the CPU; the port's runs the kernel's
plain version there.  The CUDA kernel in both modes is held against the
plain version on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import mha_prefill as jax_mha_prefill
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_dyn, flash_attention_plain,
)
from repro_torch.models.attention import mha_prefill

from _torch_helpers import flash_inputs

TOL = dict(atol=2e-5, rtol=2e-5)
GROUP = 3


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_ref(causal, window):
    """``flash_attention_plain`` (and the wrapper on CPU tensors) against
    the JAX kernel's oracle, ``ref.attention_ref`` in (B, H, S, D)."""
    q, k, v = flash_inputs(GROUP, S=20)
    ref = attention_ref(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
                        window, causal=causal)
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, window or -1, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    before = flash_attention_dyn.launches
    assert torch.equal(flash_attention(tq, tk, tv, causal=causal, window=window), out)
    assert flash_attention_dyn.launches == before          # the CPU runs no kernel


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_prefill_matches_jax(causal, window, use_kernel):
    q, k, v = flash_inputs(GROUP, S=16)
    ref = np.asarray(jax_mha_prefill(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                     window=window, use_kernel=use_kernel))
    out = mha_prefill(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                      window=window, use_kernel=use_kernel)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", [9, 23])
def test_mha_prefill_unequal_lengths_plain_route(sk, causal, window):
    """Sk != Sq on the plain route: the mask anchored at key 0, as in JAX."""
    q, _, _ = flash_inputs(GROUP, S=14)
    _, k, v = flash_inputs(GROUP, S=sk, seed=5)
    ref = np.asarray(jax_mha_prefill(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                     window=window))
    out = mha_prefill(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                      window=window)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_mha_prefill_kernel_route_refuses_unequal_lengths():
    q, _, _ = flash_inputs(GROUP, S=14)
    _, k, v = flash_inputs(GROUP, S=9, seed=5)
    with pytest.raises(ValueError, match="Sk 9 != Sq 14"):
        mha_prefill(*(torch.from_numpy(a) for a in (q, k, v)), use_kernel=True)
