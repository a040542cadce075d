"""Production mesh definitions.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``,
built by ``init_device_mesh`` over the default process group, on ``cuda``
unless the caller asks for ``cpu`` (gloo).  The caller starts that group
(``torch.distributed.init_process_group`` with its address, world size
and rank); a mesh whose size differs from the group's world size is
refused, never quietly built over one rank.  Defined as functions, so
importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# the axis helpers read names and sizes only; one definition, beside the rules
from repro_torch.distributed.sharding import data_axes, model_axis_size


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group's
    ranks, in rank order (elastic serving re-meshes at varying DP
    degrees)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh {axes} needs a process group of {n} ranks: call "
            f"torch.distributed.init_process_group(..., world_size={n}) first")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {shape} mesh {axes} needs {n} ranks; the process "
                           f"group has {world}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


__all__ = ["make_production_mesh", "make_mesh", "data_axes", "model_axis_size"]
