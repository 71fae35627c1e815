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


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """`jnp.nonzero(mask_b, size=size, fill_value=fill)[0]` per row of a
    (B, N) mask: ascending indices of the True entries, truncated or padded
    to `size`."""
    B, N = mask.shape
    idx = torch.arange(N, device=mask.device).expand(B, N)
    keys = torch.where(mask, idx, N).sort(dim=1).values
    if size <= N:
        keys = keys[:, :size]
    else:
        keys = torch.cat([keys, torch.full((B, size - N), N, device=mask.device,
                                           dtype=keys.dtype)], dim=1)
    return torch.where(keys < N, keys, fill_value)
