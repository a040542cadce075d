"""Replica placement on one card: the counterpart of the JAX package's mesh
rebuild + parameter resharding (``repro.core.elastic.remesh``).

Scale-out there rebuilds the device mesh at the new data-parallel degree
and ``device_put``s the parameters under the shardings derived for it.  The
port has no sharding yet (ROADMAP.md Queue 1 item 8), so a replica is one
whole copy of the parameters on one device, and on one H100 the replicas
share the card.  The five names of the JAX module are kept, so
``repro_torch.core.elastic`` re-exports what ``repro.core.elastic`` does:

* :func:`elastic_remesh_plan` and :func:`provisioned_cluster_config` are the
  JAX package's functions as they are;
* :func:`remesh_params` re-places a parameter tree on one device (a copy);
* :func:`scale_replicas` places one replica's parameters and refuses what
  needs sharding (tensor parallelism, more than one device);
* :func:`measure_provision_delay` times placement plus a first forward,
  synchronising the card before it reads the clock.
"""
from __future__ import annotations

import dataclasses
import time

import torch

_NO_SHARDING = ("the port has no sharding yet (ROADMAP.md Queue 1 item 8, "
                "distributed): a replica is one whole copy on one device")


def elastic_remesh_plan(n_devices: int, *, model_parallel: int) -> tuple[int, int]:
    """(dp, tp) for the new world size; dp absorbs the change."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by tp={model_parallel}")
    return n_devices // model_parallel, model_parallel


def remesh_params(params, device):
    """A copy of the parameter tree (dicts and lists of tensors) on
    ``device``; the source tree is left as it is."""
    if isinstance(params, dict):
        return {k: remesh_params(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [remesh_params(v, device) for v in params]
    return params.to(device, copy=True)


def scale_replicas(params, *, devices, model_parallel: int = 1) -> tuple:
    """Place one replica's parameters on ``devices[0]``.  Returns
    ``(devices, params_on_devices[0])``.  Raises NotImplementedError where
    the JAX package would shard: ``model_parallel > 1`` or more than one
    device."""
    devices = list(devices)
    if model_parallel > 1 or len(devices) != 1:
        raise NotImplementedError(
            f"scale_replicas over {len(devices)} device(s) at model_parallel="
            f"{model_parallel}: {_NO_SHARDING}")
    elastic_remesh_plan(len(devices), model_parallel=model_parallel)
    return devices, remesh_params(params, devices[0])


def measure_provision_delay(model, params, *, devices, model_parallel: int,
                            probe_batch: int = 2, probe_len: int = 16):
    """Measure the wall-clock cost of ONE elastic transition -- parameter
    placement + first forward on the new device.

    The live analogue of ``ClusterConfig.provision_delay_s``: what a replica
    actually costs to bring up, measured on the serving path instead of
    assumed.  The clock is read after ``torch.cuda.synchronize()`` on a
    CUDA device, so the time covers the device's work and not only the
    host's enqueue.  Returns ``(seconds, devices, params_on_device)``.
    """
    t0 = time.perf_counter()
    devices, params = scale_replicas(params, devices=devices,
                                     model_parallel=model_parallel)
    device = torch.device(devices[0])
    tokens = torch.zeros((probe_batch, probe_len), dtype=torch.long, device=device)
    model.forward(params, {"tokens": tokens})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, devices, params


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
