"""Checkpoints in the JAX package's format: the reader, the writer and the
rotating manager.

``repro.checkpoint.save_checkpoint`` writes one ``.npz`` whose keys are the
flattened tree paths (``embed``, ``ln_f``, ``blocks/wq``,
``blocks/mlp/w_gate``, ...; block leaves carry a leading layer dim L).
numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bit pattern
under the key plus ``__bf16__``.  Beside it go a ``.meta.json`` sidecar and,
last, the ``.ok`` marker (:data:`OK_SUFFIX`): a file without it was torn
mid-save and is never restored.  This module reads and writes that format
with numpy and torch alone (no ``ml_dtypes``), so each package reads the
other's files bit for bit, and maps the tree onto the port's parameters
(:mod:`repro_torch.models.lm`, :mod:`repro_torch.models.mamba_lm`).
``restore_resharded`` has no counterpart yet: the port has no sharding
(ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading

import numpy as np
import torch

from repro_torch.models.registry import resolve_device

SEP = "/"
_BF16 = "__bf16__"
#: terminal marker written LAST by save_checkpoint: a checkpoint without it
#: was interrupted mid-save and must never be restored
OK_SUFFIX = ".ok"


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
# Mamba-2 layer's decay, skip and step-bias vectors, ``mamba_lm.py``; the
# MoE router, ``lm.py``)
F32_LEAVES = frozenset({"A_log", "D", "dt_bias", "router"})


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


def _flatten(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """The flat {tree path: tensor} view of a port parameter tree, the
    per-layer ``blocks`` dictionaries stacked back on a leading layer dim
    (the inverse of :func:`params_from_jax`)."""
    flat = {}
    for key, value in params.items():
        path = prefix + key
        if key == "blocks" and not prefix:
            layers = [_flatten(layer) for layer in value]
            for leaf in (layers[0] if layers else {}):
                flat[path + SEP + leaf] = torch.stack([layer[leaf] for layer in layers])
        elif isinstance(value, dict):
            flat.update(_flatten(value, path + SEP))
        else:
            flat[path] = value
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(path: str, params, *, step: int = 0, extra: dict | None = None):
    """Write ``params`` (a port parameter tree) as one ``.npz`` in the JAX
    package's format: block leaves stacked on a leading layer dim, bf16
    leaves as their uint16 bit pattern under ``key + "__bf16__"``.  The
    file goes through a temp file and ``os.replace``, then the
    ``.meta.json`` sidecar, then the ``.ok`` marker last.  Returns ``path``."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for key, t in _flatten(params).items():
        flat[key + _BF16 if t.dtype == torch.bfloat16 else key] = _to_numpy(t)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz")
    os.close(fd)
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    # terminal marker: written only after the npz AND the sidecar are down
    with open(path + OK_SUFFIX, "w") as f:
        f.write("ok\n")
    return path


def load_checkpoint(path: str, *, device=None, dtype=None, expected=None):
    """Read a checkpoint written by either package: ``(params, meta)``.

    ``device`` and ``dtype`` as in :func:`params_from_jax` (the GPU unless
    the caller passes ``device="cpu"``).  ``expected``, if given, is a port
    parameter tree: a leaf whose shape differs from it, or that the file
    lacks, raises ValueError, as the JAX loader does against its template.
    """
    flat = load_jax_npz(path)
    if expected is not None:
        for key, leaf in _flatten(expected).items():
            if key not in flat:
                raise ValueError(f"checkpoint {path} has no leaf {key}")
            if tuple(flat[key].shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(flat[key].shape)} vs model {tuple(leaf.shape)}")
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params_from_jax(flat, device=device, dtype=dtype), meta


class CheckpointManager:
    """Rotating checkpoint directory with an optional background-thread save."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def latest(self) -> str | None:
        """Newest COMPLETE checkpoint: files missing their ``.ok`` marker
        (interrupted saves, torn copies) are skipped."""
        cks = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("ckpt_") and f.endswith(".npz")
            and os.path.exists(os.path.join(self.dir, f + OK_SUFFIX)))
        return os.path.join(self.dir, cks[-1]) if cks else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, params, step: int, extra: dict | None = None):
        # copy to host tensors BEFORE returning control, so the caller may
        # mutate its parameters in place; the file write runs on a thread
        host = _map(params, lambda t: t.detach().to("cpu", copy=True))
        self.wait()

        def _write():
            save_checkpoint(self._path(step), host, step=step, extra=extra)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _gc(self):
        cks = sorted(f for f in os.listdir(self.dir)
                     if f.startswith("ckpt_") and f.endswith(".npz"))
        for f in cks[: -self.keep]:
            for suffix in ("", ".meta.json", OK_SUFFIX):
                try:
                    os.remove(os.path.join(self.dir, f + suffix))
                except OSError:
                    pass

    def restore_latest(self, *, device=None, dtype=None):
        """``(params, meta)`` of :meth:`latest`, or ``(None, {})``."""
        path = self.latest()
        if path is None:
            return None, {}
        return load_checkpoint(path, device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


__all__ = ["F32_LEAVES", "OK_SUFFIX", "CheckpointManager", "load_checkpoint",
           "load_jax_npz", "params_from_jax", "save_checkpoint"]
