"""The real mechanism behind replica elasticity: mesh rebuild + parameter
resharding.

Counterpart of ``repro.core.elastic.remesh``.  Scale-out means: bring up
new ranks, rebuild the device mesh at the new DP degree, and re-place the
parameters under the shardings the rules derive for the new mesh
(:func:`repro_torch.distributed.sharding.param_sharding`).  A DTensor on
the same mesh is redistributed (DTensor moves only the bytes that must
move); DTensor redistributes only within one mesh, so a leaf on another
mesh is gathered whole there and cut for the new one; a plain tensor is
cut.  Fault handling uses the same path: on a lost rank, rebuild the mesh
over the survivors and restore from the latest checkpoint
(:func:`repro_torch.checkpoint.restore_resharded`).

A mesh is a ``DeviceMesh`` over ranks of the default process group.  Given
one device and ``model_parallel=1`` instead of ranks -- one replica on one
card, as :mod:`repro_torch.serving.fleet` places each replica -- the mesh
is that device and the re-placement a copy of the tree on it, whether or
not a process group is up: the one-device case of the same functions.  The five names of the JAX module
are kept, so ``repro_torch.core.elastic`` re-exports what
``repro.core.elastic`` does.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import param_sharding, place
from repro_torch.pytree import tree_leaves, tree_map


def elastic_remesh_plan(n_devices: int, *, model_parallel: int) -> tuple[int, int]:
    """(dp, tp) for the new world size; dp absorbs the change."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by tp={model_parallel}")
    return n_devices // model_parallel, model_parallel


def remesh_params(params, new_mesh):
    """Re-place ``params`` for ``new_mesh`` under the standard sharding
    rules.  ``new_mesh``: a ``DeviceMesh`` (every rank of the process group
    calls this), or one device, onto which a copy of the tree goes (the
    source tree is left as it is)."""
    if isinstance(new_mesh, DeviceMesh):
        return tree_map(place, params, param_sharding(params, new_mesh))
    return tree_map(lambda t: t.to(new_mesh, copy=True), params)


def scale_replicas(params, *, devices, model_parallel: int = 1,
                   axis_names=("data", "model")) -> tuple:
    """Build a mesh over ``devices`` at the widest DP degree and re-place
    params.  Returns ``(new_mesh, params_on_new_mesh)``.

    ``devices``: ranks of the process group (ints), over which a
    ``DeviceMesh`` is built; or one device (a ``torch.device`` or its name)
    at ``model_parallel=1``, which is then the mesh, and the parameters a
    copy on it, whether or not a process group is up."""
    devices = list(devices)
    dp, tp = elastic_remesh_plan(len(devices), model_parallel=model_parallel)
    if not all(isinstance(d, int) for d in devices):
        if dp * tp != 1:
            raise ValueError(f"scale_replicas over {devices}: a mesh is built over ranks of "
                             f"the process group (ints); a device is one replica at tp 1")
        return devices, remesh_params(params, devices[0])
    if not dist.is_initialized():
        raise RuntimeError(
            f"scale_replicas over {len(devices)} ranks at model_parallel={tp} needs a "
            f"process group: call torch.distributed.init_process_group first")
    leaf = tree_leaves(params)[0]
    device_type = (leaf.device_mesh.device_type if isinstance(leaf, DTensor)
                   else leaf.device.type)
    mesh = DeviceMesh(device_type, torch.tensor(devices).reshape(dp, tp),
                      mesh_dim_names=tuple(axis_names))
    return mesh, remesh_params(params, mesh)


def measure_provision_delay(model, params, *, devices, model_parallel: int,
                            probe_batch: int = 2, probe_len: int = 16):
    """Measure the wall-clock cost of ONE elastic transition -- mesh rebuild +
    parameter re-placement + first forward on the new mesh.

    The live analogue of ``ClusterConfig.provision_delay_s``: what a replica
    actually costs to bring up, measured on the serving path instead of
    assumed.  The forward runs on the parameters gathered whole (the port's
    model functions take plain tensors).  The clock is read after
    ``torch.cuda.synchronize()`` on a CUDA device, so the time covers the
    device's work and not only the host's enqueue.  Returns ``(seconds,
    new_mesh, params_on_new_mesh)`` so a sweep can chain transitions on the
    re-placed params.
    """
    t0 = time.perf_counter()
    mesh, params = scale_replicas(params, devices=devices,
                                  model_parallel=model_parallel)
    whole = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, params)
    device = tree_leaves(whole)[0].device
    tokens = torch.zeros((probe_batch, probe_len), dtype=torch.long, device=device)
    model.forward(whole, {"tokens": tokens})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, mesh, params


def provisioned_cluster_config(base, measured_s: float, *,
                               floor_s: float = 1.0):
    """A copy of ``base`` (an elastic ``ClusterConfig``) whose
    ``provision_delay_s`` is the measured remesh cost instead of the
    assumed default -- the ROADMAP "live-backend depth" wiring."""
    return dataclasses.replace(base,
                               provision_delay_s=max(float(measured_s),
                                                     floor_s))


__all__ = ["elastic_remesh_plan", "remesh_params", "scale_replicas",
           "measure_provision_delay", "provisioned_cluster_config"]
