"""PyTorch port, the greedy-epilogue kernel's order of work on the CPU.

On the card the epilogue runs as one cluster of C CTAs a row, rank r
reducing the slice [r * slice, (r + 1) * slice) and rank 0 merging the
ranks in order (``csrc/greedy_epilogue.cu``).  Here
``greedy_epilogue_split_plain`` repeats that arithmetic and is held against
the JAX Pallas kernel (interpret mode, 2048-logit blocks) and the
log_softmax oracle: tokens equal, logprob within 2e-5.  Also the cluster
plan's slices, and the port's ``greedy_epilogue`` on bf16 logits against the
JAX package's on the same bf16 values.  Seeded numpy inputs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sampling.kernel import greedy_epilogue_fwd
from repro.kernels.sampling.ops import greedy_epilogue as jax_greedy_epilogue
from repro.kernels.sampling.ref import greedy_epilogue_ref
from repro_torch.kernels.sampling.ops import (
    GREEDY_MAX_CLUSTER, greedy_cluster_plan, greedy_epilogue, greedy_epilogue_split_plain,
)

LP_TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _logits(B, V):
    return (np.random.default_rng(1000 * B + V).normal(size=(B, V)) * 3.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_refs(B, V):
    """(tokens, logprobs) of the Pallas kernel in interpret mode and of the
    log_softmax oracle on ``_logits(B, V)``."""
    x = jnp.asarray(_logits(B, V))
    kern = greedy_epilogue_fwd(x, block_v=2048, interpret=True)
    return tuple(tuple(np.asarray(a) for a in r) for r in (kern, greedy_epilogue_ref(x)))


def _assert_matches(tok, lp, refs):
    assert tok.dtype == torch.int32 and lp.dtype == torch.float32
    for t_ref, l_ref in refs:
        np.testing.assert_array_equal(tok.numpy(), t_ref)
        np.testing.assert_allclose(lp.numpy(), l_ref, atol=LP_TOL, rtol=0)


@pytest.mark.parametrize("B", [1, 8, 9])
@pytest.mark.parametrize("n_split", [1, 2, 8, 16])
@pytest.mark.parametrize("V", [1, 3, 256, 999, 4099, 32000, 49152, 50280])
def test_split_plain_matches_jax(V, n_split, B):
    tok, lp = greedy_epilogue_split_plain(torch.from_numpy(_logits(B, V)), n_split)
    _assert_matches(tok, lp, _jax_refs(B, V))
    assert (lp <= 0).all()


def _width(V, n_split):
    """ceil(V / n_split) rounded up to 8: the slice the kernel's ranks own."""
    per_rank = -(-V // n_split)
    return -(-per_rank // 8) * 8


@pytest.mark.parametrize("n_split", [2, 8, 16])
@pytest.mark.parametrize("where", ["boundary", "next_rank", "inside"])
def test_split_plain_ties_go_to_the_first_index(where, n_split):
    """Exact maxima (small integers are exact in f32) on both sides of a
    slice boundary, at a rank's first logit and the row's last, or twice
    inside one slice: the first index wins, as in the Pallas kernel and
    jnp.argmax.  Row 1 ties its first and last logit."""
    V = 4099
    width = _width(V, n_split)
    cols = {"boundary": (width - 1, width, V - 1), "next_rank": (width, V - 1),
            "inside": (width + 3, width + 5, V - 1)}[where]
    x = np.random.default_rng(n_split).integers(-4, 5, (3, V)).astype(np.float32)
    for c in cols:
        x[0, c] = 9.0
    x[1, 0] = x[1, V - 1] = 9.0
    tok, lp = greedy_epilogue_split_plain(torch.from_numpy(x), n_split)
    assert tok[0].item() == cols[0] and tok[1].item() == 0
    xj = jnp.asarray(x)
    _assert_matches(tok, lp, [tuple(np.asarray(a) for a in r) for r in (
        greedy_epilogue_fwd(xj, block_v=2048, interpret=True), greedy_epilogue_ref(xj))])


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("B", [1, 8, 9, 33, 512])
@pytest.mark.parametrize("V", [1, 3, 256, 999, 4099, 32000, 49152, 50280, 151936, 262144])
def test_cluster_plan_covers_the_row_once(V, B, max_cluster, sm_count, elem_bytes):
    """The ranks' slices cover [0, V) exactly once, in vocab order; each
    starts a multiple of 16 bytes after the row start in f32 and bf16; C is
    a power of two up to ``max_cluster``, B x C fits one wave unless C is 1,
    and a slice holds at least 1024 logits unless C is 1.  CTAs are 512
    threads exactly where the clusters fill at most half the SMs and a slice
    is at least one round (32 KB) of a 256-thread CTA's loads."""
    C, width, threads = greedy_cluster_plan(B, V, sm_count, max_cluster, elem_bytes)
    assert 1 <= C <= min(max_cluster, GREEDY_MAX_CLUSTER) and C & (C - 1) == 0
    assert width % 8 == 0 and (width * 4) % 16 == 0 and (width * 2) % 16 == 0
    assert C == 1 or (B * C <= sm_count and width >= 1024)
    covered = np.zeros(V, np.int64)
    for r in range(C):
        covered[min(V, r * width):min(V, (r + 1) * width)] += 1
    assert (covered == 1).all()
    if B <= 8 and V >= 16384 and sm_count >= 128:
        assert C == max_cluster
    wide = 2 * B * C <= sm_count and width * elem_bytes >= 256 * 8 * 16
    assert threads == (512 if wide else 256)


@pytest.mark.parametrize("B, V, elem_bytes, threads", [
    (1, 262144, 4, 512), (1, 151936, 4, 512), (1, 262144, 2, 512), (1, 151936, 2, 256),
    (1, 49152, 4, 256), (2, 262144, 4, 512), (4, 151936, 4, 512), (8, 262144, 4, 256),
    (8, 49152, 4, 256)])
def test_cluster_plan_cta_size_at_serving_shapes(B, V, elem_bytes, threads):
    """On 132 SMs with clusters of 16: 512-thread CTAs only at B 1 to 4 of
    the largest vocabularies, where 16 to 64 CTAs leave half the SMs or
    more idle and each holds at least 32 KB of its row."""
    assert greedy_cluster_plan(B, V, 132, 16, elem_bytes) == (
        16, -(-(-(-V // 16)) // 8) * 8, threads)


@pytest.mark.parametrize("route", ["jnp", "pallas"])
@pytest.mark.parametrize("V", [999, 4099, 49152])
def test_greedy_epilogue_takes_bf16_logits_as_jax_does(V, route):
    """The port's greedy_epilogue on bf16 CPU logits equals the JAX
    package's greedy_epilogue (its jnp route, or the Pallas kernel in
    interpret mode) on the same bf16 values: both cast to f32 first."""
    xb = torch.from_numpy(_logits(8, V)).bfloat16()
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)     # exact: bf16 values
    tok_j, lp_j = (np.asarray(a) for a in jax_greedy_epilogue(xj, use_kernel=route == "pallas"))
    tok, lp = greedy_epilogue(xb)
    assert tok.dtype == torch.int32 and lp.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), tok_j)
    np.testing.assert_allclose(lp.numpy(), lp_j, atol=LP_TOL, rtol=0)
    split_tok, split_lp = greedy_epilogue_split_plain(xb, 16)
    np.testing.assert_array_equal(split_tok.numpy(), tok_j)
    np.testing.assert_allclose(split_lp.numpy(), lp_j, atol=LP_TOL, rtol=0)
