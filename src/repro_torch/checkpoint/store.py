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
other's files bit for bit, and maps the tree onto the port's trees: a
model's parameters (:mod:`repro_torch.models.lm`,
:mod:`repro_torch.models.mamba_lm`, :mod:`repro_torch.models.whisper`) or a
whole train state (``{"params": ..., "opt": {"m", "v", "step"}}``,
:mod:`repro_torch.launch.train`), with the JAX package's keys.
:func:`restore_resharded` places each leaf it reads on a device mesh, for a
restart at another world size or a replica's re-placement.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading

import numpy as np
import torch

from repro_torch.distributed.sharding import place
from repro_torch.models.registry import resolve_device
from repro_torch.pytree import tree_map

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


#: the keys whose value is a list of per-layer dictionaries in the port and
#: one dictionary of layer-stacked leaves in the JAX tree, at any depth
STACKED = frozenset({"blocks", "enc_blocks", "dec_blocks"})


def _nest(tree: dict, key: str, value) -> None:
    *outer, leaf = key.split("/")
    for name in outer:
        tree = tree.setdefault(name, {})
    tree[leaf] = value


def _unstack(tree: dict) -> dict:
    """The nested dictionary of a JAX tree with every :data:`STACKED` entry
    split on its leading layer dim into a list of per-layer dictionaries."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, dict):
            out[key] = value
        elif key in STACKED:
            leaves = _flatten(value)
            n_layers = {t.shape[0] for t in leaves.values()}
            if len(n_layers) > 1:
                raise ValueError(f"{key} leaves disagree on the layer count: {n_layers}")
            layers = []
            for layer in range(n_layers.pop() if n_layers else 0):
                lp: dict = {}
                for path, t in leaves.items():
                    _nest(lp, path, t[layer].contiguous())
                layers.append(lp)
            out[key] = layers
        else:
            out[key] = _unstack(value)
    return out


def params_from_jax(flat, *, device=None, dtype=None) -> dict:
    """Map a flattened JAX tree onto the port's tree.

    ``flat``: {tree path: numpy array or tensor}, e.g. from
    :func:`load_jax_npz`.  Every ``/``-separated path becomes nested
    dictionaries (``shared_attn/mlp/w_gate`` ->
    ``params["shared_attn"]["mlp"]["w_gate"]``); the leaves under a
    :data:`STACKED` key (``blocks/...``, whisper's ``enc_blocks/...`` and
    ``dec_blocks/...``, at any depth, e.g. ``opt/m/blocks/wq`` of a train
    state) have a leading layer dim that is split into a list of per-layer
    dictionaries.  ``dtype``, if given, casts every floating leaf except
    those the JAX package keeps in float32 (:data:`F32_LEAVES`).
    ``device``: where the leaves go, the GPU unless the caller passes
    ``device="cpu"`` (:func:`repro_torch.models.registry.resolve_device`).
    """
    device = resolve_device(device)
    tree: dict = {}
    for key, a in flat.items():
        t = _from_numpy(a) if isinstance(a, np.ndarray) else a
        if (dtype is not None and t.is_floating_point()
                and key.rsplit("/", 1)[-1] not in F32_LEAVES):
            t = t.to(dtype)
        _nest(tree, key, t.to(device))
    return _unstack(tree)


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The flat {tree path: tensor} view of a port tree, with the JAX
    package's keys: every :data:`STACKED` list of per-layer dictionaries is
    stacked back on a leading layer dim (the inverse of
    :func:`params_from_jax`)."""
    flat = {}
    for key, value in tree.items():
        path = prefix + key
        if key in STACKED and isinstance(value, list):
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


def save_checkpoint(path: str, tree, *, step: int = 0, extra: dict | None = None):
    """Write ``tree`` (a port parameter tree, or any nested dictionary of
    tensors such as the train state ``{"params": ..., "opt": {"m", "v",
    "step"}}``) as one ``.npz`` in the JAX package's format: the keys of
    JAX's ``_flatten`` (``blocks/wq``, ``opt/v/dec_blocks/xq``,
    ``opt/step``), block leaves stacked on a leading layer dim, bf16
    leaves as their uint16 bit pattern under ``key + "__bf16__"``.  The
    file goes through a temp file and ``os.replace``, then the
    ``.meta.json`` sidecar, then the ``.ok`` marker last.  Returns ``path``."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for key, t in _flatten(tree).items():
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


def load_checkpoint(path: str, template=None, *, device=None, dtype=None):
    """Read a checkpoint written by either package: ``(tree, meta)``.

    Without ``template`` the file's whole tree comes back as
    :func:`params_from_jax` maps it (``device`` and ``dtype`` as there: the
    GPU unless the caller passes ``device="cpu"``).  With ``template``, a
    port tree (tensors, or the meta tensors of ``Model.abstract_params``),
    the result has the template's structure and each leaf takes its
    template leaf's dtype, as JAX's ``load_checkpoint(path, template)``
    does (so a train state's float32 ``m``/``v`` and int32 ``step`` keep
    theirs at any parameter dtype); a leaf the file lacks, or whose shape
    differs, raises ValueError.  ``dtype`` is then refused.
    """
    flat = load_jax_npz(path)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    if template is None:
        return params_from_jax(flat, device=device, dtype=dtype), meta
    if dtype is not None:
        raise ValueError("load_checkpoint: a template sets each leaf's dtype; pass no dtype")
    device = resolve_device(device)
    out = {}
    for key, leaf in _flatten(template).items():
        if key not in flat:
            raise ValueError(f"checkpoint {path} has no leaf {key}")
        if tuple(flat[key].shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(flat[key].shape)} vs model {tuple(leaf.shape)}")
        out[key] = flat[key].to(device, leaf.dtype)
    return params_from_jax(out, device=device), meta


def restore_resharded(path: str, template, shardings):
    """Load + place each leaf with the sharding for the NEW mesh:
    ``(tree, meta)``, every leaf a DTensor.

    :func:`load_checkpoint` with ``template`` (tensors, meta tensors or
    DTensors: only shapes and dtypes are read, so a bf16 model's float32
    router and a train state's float32 moments keep theirs) into host
    memory, as the JAX package reads the file with numpy; then each leaf
    :func:`~repro_torch.distributed.sharding.place`d under its
    :class:`~repro_torch.distributed.sharding.NamedSharding` in
    ``shardings`` (e.g. ``param_sharding(template, mesh)``), which cuts it
    on the host and moves only this rank's blocks to the mesh's device.
    Every rank reads the whole file; the file may come from either
    package."""
    abstract = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                        template)
    tree, meta = load_checkpoint(path, abstract, device="cpu")
    return tree_map(place, tree, shardings), meta


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

    def save(self, tree, step: int, extra: dict | None = None):
        """Write ``tree`` (parameters, or a whole train state) as step
        ``step``: copied to host tensors BEFORE returning control, so the
        caller may update it in place; the file write runs on a thread."""
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
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

    def restore_latest(self, template=None, *, device=None, dtype=None):
        """``(tree, meta)`` of :meth:`latest` through :func:`load_checkpoint`,
        or ``(None, {})``."""
        path = self.latest()
        if path is None:
            return None, {}
        return load_checkpoint(path, template, device=device, dtype=dtype)


__all__ = ["F32_LEAVES", "OK_SUFFIX", "STACKED", "CheckpointManager", "load_checkpoint",
           "load_jax_npz", "params_from_jax", "restore_resharded", "save_checkpoint"]
