"""The multi-process runtime: one process a device (or a group of shards),
joined by `torch.distributed`.

Counterpart of what `scripts/dryrun_dcn.py` takes from JAX:
`jax.distributed.initialize`, `jax.process_index` / `jax.process_count`,
one global mesh over every process's devices,
`jax.make_array_from_process_local_data`, the collectives XLA inserts for
a reduction over a sharded axis, and `multihost_utils.process_allgather`.

- `initialize(rank, world_size, init_method, backend)` joins the process
  group.  The backend is the caller's choice, with no default and no
  fallback: `"gloo"` (CPU tensors; the port moves what it sends to the CPU
  first) or `"nccl"` (one process a GPU: NCCL refuses two ranks on one
  card; the tensors go to the process's current CUDA device).
  `shutdown()` leaves it.
- `process_index()` / `process_count()`: the rank and the world size (0
  and 1 where no group was joined, as JAX's).
- `GlobalMesh`: this process's shards (`parallel.mesh.Mesh`, real or
  virtual) with its rank and the world size; `shape["data"]` is the
  global shard count, every process holding as many shards
  (`global_mesh` checks that with a collective).  Global shard
  `rank * local + i` is local shard i of process `rank`.
- `process_local_rows(x, mesh)`: process p's rows of a global batch of n,
  `[p*n/P, (p+1)*n/P)`, as `make_array_from_process_local_data` places
  them.
- `all_reduce_counts(counts)`: int64 sums over the processes;
  `any_process(flag)`: whether the flag is set in any process.
- `process_allgather(x)`: every process's rows in rank order (tiled; the
  row counts may differ), as a numpy array or a tensor on x's device.

Every collective here runs over the default group, and every process must
make the same calls in the same order: a decision that one process takes
alone (an overflow fallback, a skipped batch) deadlocks the next
collective, so such decisions go through `any_process` first.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cell_image_analysis_tpu_torch.parallel.mesh import AXIS, Mesh

BACKENDS = ("gloo", "nccl")


def initialize(rank: int, world_size: int, init_method: str, backend: str,
               timeout_s: float = 300.0) -> None:
    """Joins the default process group as `rank` of `world_size` through
    `init_method` (e.g. "tcp://localhost:PORT"), with `backend`; a
    collective that waits longer than `timeout_s` raises."""
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: the nccl backend needs a CUDA device")
    if not 0 <= rank < world_size:
        raise ValueError(f"initialize: rank {rank} of a world of {world_size}")
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leaves the process group (a no-op where none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class GlobalMesh(NamedTuple):
    """A data mesh over every process's shards: `local` is this process's
    (`parallel.mesh.Mesh`), `rank` its index among `world` processes."""

    local: Mesh
    rank: int
    world: int

    @property
    def shape(self) -> dict:
        return {AXIS: self.local.shape[AXIS] * self.world}


def global_mesh(local: Mesh) -> GlobalMesh:
    """The global mesh of this process's `local` shards (a collective:
    every process calls it; each must bring as many shards)."""
    counts = process_allgather(np.array([local.shape[AXIS]], np.int64))
    if len(set(counts.tolist())) != 1:
        raise ValueError(f"global_mesh: the processes hold {counts.tolist()} shards; "
                         "each must hold as many")
    return GlobalMesh(local, process_index(), process_count())


def process_local_rows(x, mesh: GlobalMesh):
    """This process's rows `[p*n/P, (p+1)*n/P)` of the global batch `x`
    (a tensor or an array, identical in every process)."""
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"process_local_rows: {n} rows do not split over {mesh.world} "
                         "processes; pad the batch first")
    per = n // mesh.world
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend takes it: gloo does not take CUDA tensors for
    every collective, so for gloo it goes to the CPU (an explicit copy,
    synchronous); for nccl, to this process's current CUDA device.  bool
    travels as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if dist.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device())).contiguous()
    return t.cpu().contiguous()


def all_reduce_counts(counts) -> torch.Tensor:
    """int64 `counts` (a tensor, array or sequence) summed over every
    process; a tensor on the input's device (the CPU for the others)."""
    t = torch.as_tensor(counts).to(torch.int64)
    w = _wire(t)
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    return w.to(t.device)


def any_process(flag: bool) -> bool:
    """True in every process if `flag` is True in any (a MAX reduction)."""
    w = _wire(torch.tensor([int(bool(flag))], dtype=torch.int64))
    dist.all_reduce(w, op=dist.ReduceOp.MAX)
    return bool(w.item())


def process_allgather(x):
    """Every process's `x` concatenated along its first axis in rank order
    (JAX's `process_allgather(x, tiled=True)`), where the processes may
    hold different numbers of rows: a numpy array for an array, a tensor
    on x's device for a tensor."""
    as_numpy = not isinstance(x, torch.Tensor)
    t = torch.as_tensor(np.ascontiguousarray(x)) if as_numpy else x
    w = _wire(t)
    sizes = [torch.zeros(1, dtype=torch.int64, device=w.device) for _ in range(process_count())]
    dist.all_gather(sizes, torch.tensor([w.shape[0]], dtype=torch.int64, device=w.device))
    sizes = [int(s.item()) for s in sizes]
    padded = w.new_zeros((max(max(sizes), 1),) + tuple(w.shape[1:]))   # no empty messages
    padded[:w.shape[0]] = w
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(t.dtype)
    return out.numpy() if as_numpy else out.to(t.device)
