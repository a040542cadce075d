"""Weights carried across from the JAX package.

``repro.checkpoint.save_checkpoint`` writes one ``.npz`` whose keys are the
flattened tree paths (``embed``, ``ln_f``, ``blocks/wq``,
``blocks/mlp/w_gate``, ...; block leaves carry a leading layer dim L).
numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bit pattern
under the key plus ``__bf16__``.  This module reads that format with numpy
and torch alone (no ``ml_dtypes``) and maps the tree onto the port's
parameters (:mod:`repro_torch.models.lm`).
"""
from __future__ import annotations

import numpy as np
import torch

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


def params_from_jax(flat, *, device="cpu", dtype=None) -> dict:
    """Map a flattened JAX parameter tree onto the port's parameters.

    ``flat``: {tree path: numpy array or tensor}, e.g. from
    :func:`load_jax_npz`; block leaves have a leading layer dim that is split
    into the per-layer dictionaries of ``params["blocks"]``.  ``dtype``, if
    given, casts every floating leaf.
    """
    def tensor(a):
        t = torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    params: dict = {}
    blocks: dict[str, torch.Tensor] = {}
    for key, a in flat.items():
        parts = key.split("/")
        if parts[0] == "blocks":
            blocks["/".join(parts[1:])] = tensor(a)
        else:
            params[key] = tensor(a)
    n_layers = {t.shape[0] for t in blocks.values()}
    if len(n_layers) > 1:
        raise ValueError(f"block leaves disagree on the layer count: {n_layers}")
    params["blocks"] = []
    for layer in range(n_layers.pop() if n_layers else 0):
        bp: dict = {}
        for key, t in blocks.items():
            *outer, leaf = key.split("/")
            node = bp
            for name in outer:
                node = node.setdefault(name, {})
            node[leaf] = t[layer].contiguous()
        params["blocks"].append(bp)
    return params


__all__ = ["load_jax_npz", "params_from_jax"]
