"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

JAX is imported only inside the helpers that need it: the card's machine,
where tests/test_torch_cuda.py runs, has no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_smoke_config as torch_smoke_config


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA device exists; decided at run
    time, never at import, so every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def flatten_jax(tree) -> dict[str, np.ndarray]:
    """The flat {tree path: array} view save_checkpoint writes."""
    import jax
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def smoke_pair(arch: str, *, kv: str = "native", seed: int = 0):
    """(jax cfg, torch cfg, jax model, jax params, torch params) at float32,
    the port's parameters carried across from the JAX init."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model
    jc = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32,
                             kv_cache_dtype=kv)
    tc = dataclasses.replace(torch_smoke_config(arch), dtype=torch.float32,
                             kv_cache_dtype=kv)
    jm = build_model(jc)
    jp = jm.init_params(jax.random.key(seed))
    return jc, tc, jm, jp, params_from_jax(flatten_jax(jp))


def jax_tree_from_torch(params):
    """The JAX parameter tree of a port's parameter dictionary: the
    per-layer ``blocks`` dictionaries stacked on a leading layer dim, every
    leaf a jnp array (the inverse of ``params_from_jax``)."""
    import jax.numpy as jnp

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([layer[k] for layer in layers]) for k in first}
        return jnp.asarray(torch.stack(layers).numpy())

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return jnp.asarray(tree.numpy())

    return {k: (stack(v) if k == "blocks" else conv(v)) for k, v in params.items()}


def torch_pair(arch: str, *, kv: str = "native", seed: int = 0):
    """As :func:`smoke_pair`, with the weights drawn by the port (seeded
    torch init at float32) and carried into a JAX tree, which skips the
    JAX package's init: (jax cfg, torch cfg, jax model, jax params, torch
    params)."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model
    from repro_torch.models import build_model as torch_build_model
    jc = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32,
                             kv_cache_dtype=kv)
    tc = dataclasses.replace(torch_smoke_config(arch), dtype=torch.float32,
                             kv_cache_dtype=kv)
    tp = torch_build_model(tc, device="cpu").init_params(seed)
    return jc, tc, build_model(jc), jax_tree_from_torch(tp), tp


def mixed_inputs(group, int8, *, B=3, T=4, Hkv=2, D=8, ps=4, n=6, seed=0, starts=None):
    """Pool with heterogeneous row starts (``starts``, default 0, 5, 13 for
    the first B rows); table entries past each row's live pages point at
    page 0, which holds garbage that must never be read."""
    rng = np.random.default_rng(seed)
    starts = np.array([0, 5, 13][:B] if starts is None else starts, np.int32)
    B = len(starts)
    P = B * n + 1
    Hq = Hkv * group
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    tbl = np.zeros((B, n), np.int32)
    for b in range(B):
        live = -(-(starts[b] + T) // ps)
        tbl[b, :live] = perm[b * n:b * n + live]
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.03, (P, ps, Hkv, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.03, (P, ps, Hkv, 1)).astype(np.float32)
    else:
        kp = rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)
        vp = rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)
        ks = vs = None
    kp[0] = kp.max() if int8 else 1e3          # trash-page garbage
    return q, kp, vp, ks, vs, tbl, starts


def lmhead_inputs(kind, N=6, d=32, V=999, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=(N, d)).astype(np.float32) * 2.0,
                rng.normal(size=(d, V)).astype(np.float32))
    # small integers: every logit is exact in f32, so maxima tie exactly
    # across columns and the first maximal index must win
    h = rng.integers(-2, 3, (N, d)).astype(np.float32)
    w = rng.integers(-1, 2, (d, V)).astype(np.float32)
    w[:, 997] = w[:, 3] = w[:, int(np.argmax(h[0] @ w))]
    return h, w


def flash_inputs(group, *, B=2, S=32, Hkv=2, D=16, seed=2):
    """q (B, S, Hq, D), k/v (B, S, Hkv, D) float32, the JAX layout."""
    rng = np.random.default_rng(seed)
    Hq = Hkv * group
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def logits_inputs(kind, B=5, V=999, seed=6):
    """(B, V) float32 logits; "tie" forces exact maxima at 3, 500 and 997 in
    row 0 (small integers are exact in f32), the first of which must win."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=(B, V)) * 3.0).astype(np.float32)
    x = rng.integers(-4, 5, (B, V)).astype(np.float32)
    x[0, 3] = x[0, 500] = x[0, 997] = 9.0
    x[1, 998] = x[1, 0] = 9.0
    return x


def ssd_inputs(b=1, nc=2, q=16, h=4, p=8, n=8, groups=1, seed=3):
    """SSD intra-chunk inputs in the model layout, float32: xb (b, nc, q, h, p),
    acs (b, nc, q, h) a decreasing cumulative log-decay as ssd_chunked makes
    it, and the group tensors Bq/Cq (b, nc, q, groups, n); the per-head
    Bh/Ch repeat each group over h // groups heads (jnp.repeat's order)."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(b, nc, q, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, nc, q, h))))
    A = -np.exp(rng.normal(size=(h,)) * 0.3)
    acs = np.cumsum(A * dt, axis=2).astype(np.float32)
    Bq = rng.normal(size=(b, nc, q, groups, n)).astype(np.float32)
    Cq = rng.normal(size=(b, nc, q, groups, n)).astype(np.float32)
    return xb, acs, Bq, Cq


def dense_decode_inputs(B, S, Hq, Hkv, D, seed=4):
    """q1 (B, 1, Hq, D) and dense caches (B, S, Hkv, D), float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 1, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


# (B, S, Hq, Hkv, D, pos, window): the six shapes of tests/test_kernels.py
DENSE_DECODE_SHAPES = [
    (2, 512, 8, 2, 64, 300, None),
    (1, 1024, 4, 4, 128, 1000, None),
    (2, 512, 8, 2, 64, 400, 128),
    (1, 256, 8, 1, 64, 17, None),       # pos not block-aligned
    (2, 384, 8, 2, 64, 201, 96),        # GQA + window + partial, unaligned
    (1, 256, 6, 3, 32, 250, 300),       # window wider than the filled cache
]
