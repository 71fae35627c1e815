"""Replicate parameters, shard batches, and the masked anomaly rate.

Counterpart of `cell_image_analysis_tpu/parallel/sharding.py` on the
port's single-controller mesh (`parallel.mesh`): where JAX places one
global array with a `NamedSharding`, the port holds one tensor or object a
shard, on that shard's device.

- `replicate(mesh, obj)`: one copy of a module, a `ScoringParams`, a
  segmentation backend (anything with `.to(device)`) or a tensor tree per
  distinct device of the mesh, as a `Replicated` tuple with one entry a
  shard; shards on one device share one copy, and the home device's copy is
  `obj` itself.  A `Replicated` passes through unchanged;
- `shard_batch(mesh, x)`: the leading axis of x, zero-padded to a multiple
  of the mesh, split into one equal part a shard on its device;
- `pad_to_multiple(x, n)`: the padding with its validity mask;
- `masked_anomaly_rate(predictions, valid, mesh)`: the share of valid
  entries predicted -1, its two counts summed over the shards, and over
  the processes too where `mesh` spans them (`parallel.distributed`).
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from cell_image_analysis_tpu_torch.parallel.mesh import AXIS, Mesh


class Replicated(tuple):
    """One object a shard of a mesh (entries of shards that share a device
    are one object)."""


def device_of(obj: Any):
    """The device of a tensor, a module's first parameter or buffer, the
    first such leaf of a tuple, list or dict, or an object's `device`
    attribute; None for an object that holds no tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, torch.nn.Module):
        t = next(iter(list(obj.parameters()) + list(obj.buffers())), None)
        return None if t is None else t.device
    if isinstance(obj, (tuple, list)):
        return next((d for d in map(device_of, obj) if d is not None), None)
    if isinstance(obj, dict):
        return device_of(list(obj.values()))
    return getattr(obj, "device", None)


def to_device(obj: Any, device):
    """`obj` on `device`: the object itself where it is there already or
    holds no tensor, else a copy (modules are deep-copied, never moved)."""
    device = torch.device(device)
    if device_of(obj) in (None, device):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):        # NamedTuple
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj.to(device)


def replicate(mesh: Mesh, obj: Any) -> Replicated:
    """One copy of `obj` a distinct device of the mesh, one entry a shard."""
    if isinstance(obj, Replicated):
        if len(obj) != mesh.shape[AXIS]:
            raise ValueError(f"replicate: {len(obj)} replicas for a mesh of "
                             f"{mesh.shape[AXIS]} shards")
        return obj
    copies = {}
    for dev in mesh.distinct:
        copies[dev] = to_device(obj, dev)
    return Replicated(copies[dev] for dev in mesh.devices)


def pad_to_multiple(x: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the batch axis with zeros to a multiple of n; returns (padded,
    valid mask)."""
    pad = (-x.shape[0]) % n
    mask = np.ones(x.shape[0] + pad, bool)
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        mask[-pad:] = False
    return x, mask


def shard_batch(mesh: Mesh, x) -> list:
    """The leading axis of `x` (a tensor or an array), zero-padded to a
    multiple of the mesh, as one equal part a shard on its device."""
    x = torch.as_tensor(x)
    n = mesh.shape[AXIS]
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return [part.to(dev, non_blocking=True)
            for part, dev in zip(torch.tensor_split(x, n), mesh.devices)]


def masked_anomaly_rate(predictions, valid, mesh=None) -> float:
    """fraction(pred == -1) over the valid entries (the parity metric);
    `predictions` and `valid` are tensors or lists of one tensor a shard,
    whose anomaly and valid counts are summed over the shards.  With a
    `parallel.distributed.GlobalMesh` they are this process's shards, and
    the counts are summed over every process (each process must call)."""
    from cell_image_analysis_tpu_torch.parallel.distributed import GlobalMesh, all_reduce_counts

    if isinstance(predictions, torch.Tensor):
        predictions, valid = [predictions], [valid]
    home = predictions[0].device
    counts = torch.stack([torch.stack([((p == -1) & v.bool()).sum(), v.bool().sum()]).to(home)
                          for p, v in zip(predictions, valid)]).sum(dim=0)
    if isinstance(mesh, GlobalMesh):
        counts = all_reduce_counts(counts)
    anom, total = counts.tolist()
    return anom / max(total, 1)
