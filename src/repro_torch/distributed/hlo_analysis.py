"""Collective traffic and roofline terms of one rank's step: the counterpart
of ``repro.distributed.hlo_analysis``.

The JAX module parses the compiled, post-SPMD HLO text, because
``compiled.cost_analysis()`` gives FLOPs and HBM bytes but no collective
bytes.  The port compiles no program: PyTorch runs the step eagerly and no
HLO exists to parse.  So :func:`collective_stats` counts the collectives
as the rank dispatches them, through a ``TorchDispatchMode`` that sees
every ``c10d`` op (``dist.all_reduce`` and the other process-group calls)
and every ``_c10d_functional`` op (the functional collectives, which
DTensor's redistributes issue).  Each is counted under the JAX module's
kind (all-gather, all-reduce, reduce-scatter, all-to-all,
collective-permute) with the bytes of its result on this rank, as the JAX
module sums result shapes: the output of a functional op, the tensors an
in-place ``c10d`` op writes (a ``recv`` for a permute; a ``send`` writes
nothing here).  A collective with no JAX kind (a broadcast) keeps its own
name.  It reads shapes only, so it counts meta and fake tensors under the
``fake`` process-group backend as it counts real ones.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# op name (namespace.name, no overload) -> kind; ``True`` in the second place:
# an in-place c10d op whose first argument holds the tensors it writes
_KINDS = {
    "_c10d_functional.all_reduce": ("all-reduce", False),
    "_c10d_functional.all_reduce_": ("all-reduce", False),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", False),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", False),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", False),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", False),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", False),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", False),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", False),
    "_c10d_functional.all_to_all_single": ("all-to-all", False),
    "_c10d_functional.broadcast": ("broadcast", False),
    "_c10d_functional.broadcast_": ("broadcast", False),
    "c10d.allreduce_": ("all-reduce", True),
    "c10d.allreduce_coalesced_": ("all-reduce", True),
    "c10d.allgather_": ("all-gather", True),
    "c10d._allgather_base_": ("all-gather", True),
    "c10d.allgather_coalesced_": ("all-gather", True),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", True),
    "c10d.reduce_scatter_": ("reduce-scatter", True),
    "c10d._reduce_scatter_base_": ("reduce-scatter", True),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", True),
    "c10d.alltoall_": ("all-to-all", True),
    "c10d.alltoall_base_": ("all-to-all", True),
    "c10d.recv_": ("collective-permute", True),
    "c10d.recv_any_source_": ("collective-permute", True),
    "c10d.broadcast_": ("broadcast", True),
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group_size(args) -> int | None:
    """The size of the op's process group: a ``ProcessGroup`` argument
    (``c10d`` ops, as a script object) or a group name
    (``_c10d_functional`` ops)."""
    from torch.distributed.distributed_c10d import ProcessGroup, _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject) \
                and a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return ProcessGroup.unbox(a).size()
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):   # not a group name
                continue
    return None


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    #: one ``(kind, result bytes, group size)`` per collective, in order
    events: list = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, n_bytes: int, group_size: int | None = None) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n_bytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.events.append((kind, n_bytes, group_size))

    def as_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


class _Counter(TorchDispatchMode):
    def __init__(self, stats: CollectiveStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        entry = _KINDS.get(f"{func.namespace}.{func._opname}")
        if entry is not None:
            kind, in_place = entry
            n_bytes = _nbytes(args[0]) if in_place else _nbytes(out)
            self.stats.add(kind, n_bytes, _group_size(list(args) + list(kwargs.values())))
        return out


@contextlib.contextmanager
def collective_stats():
    """``with collective_stats() as st: ...``: ``st`` (a
    :class:`CollectiveStats`) counts every collective this process
    dispatches while the block runs, the backward's included."""
    stats = CollectiveStats()
    with _Counter(stats):
        yield stats


# --- NVIDIA H100 SXM constants (per card), NVIDIA's H100 data sheet; the card
# they were read beside: NVIDIA H100 80GB HBM3, 700.00 W power limit (nvidia-smi)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s each way, NVLink 4 (replaces the TPU's ICI_BW)


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   collective_bytes_per_device: float) -> dict:
    """The three per-device roofline terms, in seconds."""
    t_compute = flops_per_device / PEAK_FLOPS_BF16
    t_memory = hbm_bytes_per_device / HBM_BW
    t_collective = collective_bytes_per_device / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


__all__ = ["collective_stats", "CollectiveStats", "roofline_terms",
           "PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW"]
