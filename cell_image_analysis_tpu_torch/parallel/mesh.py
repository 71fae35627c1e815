"""The device mesh: an ordered list of devices along one `data` axis.

Counterpart of `cell_image_analysis_tpu/parallel/mesh.py`.  The mesh is
single-controller, as JAX's is: one process holds the list and puts each
shard's tensors on its shard's device.  `mesh.shape["data"]` and
`mesh.devices` read as they do on a `jax.sharding.Mesh`.  A mesh that
spans processes is `parallel.distributed.GlobalMesh`: each process's
shards are a mesh of this module.

- `make_mesh(n)` takes the first n CUDA devices, as JAX's takes the first n
  of `jax.devices()`; it raises without a GPU;
- `virtual_mesh(device, n)` puts n shards on one device: the counterpart of
  the JAX tests' virtual CPU mesh (`"cpu"` in the tests, `"cuda:0"` on a
  machine with one card).  Every line of the mesh path runs on it except
  the copies between distinct cards;
- `make_mesh_2d(shape, axes)` lays the first prod(shape) CUDA devices out
  as a grid with named axes (`Mesh2D`), as JAX's lays out `jax.devices()`;
  `virtual_mesh_2d(device, shape, axes)` puts the whole grid on one
  device.  Nothing calls them, in JAX or here: the models fit on one
  device, so no path shards over a model axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

AXIS = "data"


def canonical_device(device) -> torch.device:
    """`device` as a torch.device with its index: a bare "cuda" is the
    current card, so that devices compare equal to a tensor's `.device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh(NamedTuple):
    """An ordered tuple of devices along the `data` axis; shard i lives on
    `devices[i]`, and `devices[0]` is the home device, where the frame-wide
    and batch-wide work runs."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in the order of their first shard."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A data mesh over the first n (default: all) CUDA devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; a CPU mesh is "
                           "virtual_mesh('cpu', n)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked for, {count} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def virtual_mesh(device, n: int) -> Mesh:
    """A data mesh of n shards that all live on `device`."""
    if n < 1:
        raise ValueError(f"virtual_mesh: n must be >= 1, got {n}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("virtual_mesh: no CUDA device; pass 'cpu' for a CPU mesh")
    return Mesh((canonical_device(device),) * n)


class Mesh2D(NamedTuple):
    """A grid of devices with named axes: `devices[i, j]` (an object array
    of torch.device, as a `jax.sharding.Mesh`'s is of JAX devices) sits at
    index i of `axis_names[0]` and j of `axis_names[1]`."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _grid(devices: list, shape: Sequence[int], axes: Sequence[str]) -> Mesh2D:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"a mesh of shape {shape} with axes {axes}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh2D(grid.reshape(shape), axes)


def make_mesh_2d(shape: Sequence[int], axes: Sequence[str] = ("data", "model")) -> Mesh2D:
    """A mesh of `shape` over the first prod(shape) CUDA devices, in order."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh_2d: no CUDA device; a CPU mesh is "
                           "virtual_mesh_2d('cpu', shape)")
    n, count = math.prod(shape), torch.cuda.device_count()
    if n > count:
        raise ValueError(f"make_mesh_2d: {n} devices asked for, {count} present")
    return _grid([torch.device("cuda", i) for i in range(n)], shape, axes)


def virtual_mesh_2d(device, shape: Sequence[int],
                    axes: Sequence[str] = ("data", "model")) -> Mesh2D:
    """A mesh of `shape` whose every entry is `device`."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("virtual_mesh_2d: no CUDA device; pass 'cpu' for a CPU mesh")
    return _grid([canonical_device(device)] * math.prod(shape), shape, axes)
