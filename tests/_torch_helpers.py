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


def mixed_inputs(group, int8, *, B=3, T=4, Hkv=2, D=8, ps=4, n=6, seed=0):
    """Pool with heterogeneous row starts; table entries past each row's live
    pages point at page 0, which holds garbage that must never be read."""
    rng = np.random.default_rng(seed)
    P = B * n + 1
    Hq = Hkv * group
    starts = np.array([0, 5, 13][:B], np.int32)
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
