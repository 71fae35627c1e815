"""Tensor operations of the port; `ops.cuda` binds the hand-written kernels."""

import torch


def gather_rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along axis 1 at indices i (B, ...) ->
    (B, ..., *x.shape[2:]) — per-frame fancy indexing `x[b][i[b]]`."""
    extra = x.shape[2:]
    flat = i.reshape(i.shape[0], -1)
    out = torch.gather(x, 1, flat.reshape(*flat.shape, *([1] * len(extra)))
                       .expand(*flat.shape, *extra))
    return out.reshape(*i.shape, *extra)
