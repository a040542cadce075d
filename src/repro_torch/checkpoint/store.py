"""Weights carried across from the JAX package.

``repro.checkpoint.save_checkpoint`` writes one ``.npz`` whose keys are the
flattened tree paths (``embed``, ``ln_f``, ``blocks/wq``,
``blocks/mlp/w_gate``, ...; block leaves carry a leading layer dim L).
numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bit pattern
under the key plus ``__bf16__``.  This module reads that format with numpy
and torch alone (no ``ml_dtypes``) and maps the tree onto the port's
parameters (:mod:`repro_torch.models.lm`, :mod:`repro_torch.models.mamba_lm`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.registry import resolve_device

_BF16 = "__bf16__"


def load_jax_npz(path: str) -> dict[str, torch.Tensor]:
    """Read a JAX checkpoint into a flat {tree path: CPU tensor} dictionary,
    bf16 leaves decoded bit-exactly from their uint16 patterns."""
    flat = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            arr = z[key]
            if key.endswith(_BF16):
                flat[key[:-len(_BF16)]] = torch.from_numpy(
                    arr.view(np.int16)).view(torch.bfloat16)
            else:
                flat[key] = torch.from_numpy(arr)
    return flat


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor copy of ``a``; a bf16 array (``ml_dtypes.bfloat16``, as
    ``np.asarray`` of a JAX bf16 leaf gives) goes across bit-exactly through
    its int16 view, without importing ``ml_dtypes``."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# leaves the JAX package keeps in float32 whatever ``cfg.dtype`` is (the
# Mamba-2 layer's decay, skip and step-bias vectors, ``mamba_lm.py``)
F32_LEAVES = frozenset({"A_log", "D", "dt_bias"})


def _nest(tree: dict, key: str, value) -> None:
    *outer, leaf = key.split("/")
    for name in outer:
        tree = tree.setdefault(name, {})
    tree[leaf] = value


def params_from_jax(flat, *, device=None, dtype=None) -> dict:
    """Map a flattened JAX parameter tree onto the port's parameters.

    ``flat``: {tree path: numpy array or tensor}, e.g. from
    :func:`load_jax_npz`.  Every ``/``-separated path becomes nested
    dictionaries (``shared_attn/mlp/w_gate`` ->
    ``params["shared_attn"]["mlp"]["w_gate"]``); ``blocks/...`` leaves have
    a leading layer dim that is split into the per-layer dictionaries of
    ``params["blocks"]``.  ``dtype``, if given, casts every floating leaf
    except those the JAX package keeps in float32 (:data:`F32_LEAVES`).
    ``device``: where the leaves go, the GPU unless the caller passes
    ``device="cpu"`` (:func:`repro_torch.models.registry.resolve_device`).
    """
    device = resolve_device(device)

    def tensor(key, a):
        t = _from_numpy(a) if isinstance(a, np.ndarray) else a
        if (dtype is not None and t.is_floating_point()
                and key.rsplit("/", 1)[-1] not in F32_LEAVES):
            t = t.to(dtype)
        return t.to(device)

    params: dict = {}
    blocks: dict[str, torch.Tensor] = {}
    for key, a in flat.items():
        if key.startswith("blocks/"):
            blocks[key[len("blocks/"):]] = tensor(key, a)
        else:
            _nest(params, key, tensor(key, a))
    n_layers = {t.shape[0] for t in blocks.values()}
    if len(n_layers) > 1:
        raise ValueError(f"block leaves disagree on the layer count: {n_layers}")
    params["blocks"] = []
    for layer in range(n_layers.pop() if n_layers else 0):
        bp: dict = {}
        for key, t in blocks.items():
            _nest(bp, key, t[layer].contiguous())
        params["blocks"].append(bp)
    return params


__all__ = ["F32_LEAVES", "load_jax_npz", "params_from_jax"]
