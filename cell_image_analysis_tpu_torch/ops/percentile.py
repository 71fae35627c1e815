"""Percentile normalization (csbdeep.utils.normalize semantics).

Counterpart of `cell_image_analysis_tpu/ops/percentile.py`:
`normalize_percentile` takes exact order statistics (`kth_smallest`, on
`torch.kthvalue`) at the ranks numpy's linear-interpolation percentile
uses, computed in python float64 (`percentile_ranks`), and lerps them in
float32.  JAX selects them with a sort-free bisection; the values are the
same.
"""

from __future__ import annotations

import numpy as np
import torch


def percentile_ranks(n: int, qs: tuple) -> list:
    """(k_lo, k_hi, frac) triples of numpy's linear-interpolation percentile
    for a length-n array, one per q (float64 index arithmetic)."""
    out = []
    for q in qs:
        idx = q / 100.0 * (n - 1)
        k_lo = int(np.floor(idx))
        k_hi = int(np.ceil(idx))
        out.append((k_lo, k_hi, np.float32(idx - k_lo)))
    return out


def kth_smallest(x: torch.Tensor, ks: tuple) -> torch.Tensor:
    """The k-th smallest elements (0-based ranks `ks`) of each leading-dim
    slice of x (B, ...) -> (B, len(ks)) float32; a rank repeated is
    selected once."""
    flat = x.reshape(x.shape[0], -1).float()
    vals = {k: torch.kthvalue(flat, k + 1, dim=1).values for k in dict.fromkeys(ks)}
    return torch.stack([vals[k] for k in ks], dim=1)


def percentile_select(x: torch.Tensor, qs: tuple) -> torch.Tensor:
    """numpy `percentile(x_b, qs)` of each leading-dim slice of x (B, ...)
    -> (B, len(qs)) float32, from exact order statistics."""
    rk = percentile_ranks(x[0].numel(), qs)
    v = kth_smallest(x, tuple(k for r in rk for k in r[:2]))
    out = []
    for i, (_, _, frac) in enumerate(rk):
        f = torch.full((), float(frac), dtype=torch.float32, device=x.device)  # no host copy
        out.append(v[:, 2 * i] * (1.0 - f) + v[:, 2 * i + 1] * f)
    return torch.stack(out, dim=1)


def normalize_percentile(x: torch.Tensor, pmin: float = 3.0, pmax: float = 99.8,
                         eps: float = 1e-20) -> torch.Tensor:
    """(x - p_min) / (p_max - p_min + eps) per frame of x (B, H, W) or (H, W),
    float32, no clipping."""
    single = x.dim() == 2
    xb = (x[None] if single else x).float()
    lohi = percentile_select(xb, (float(pmin), float(pmax)))
    lo = lohi[:, 0].reshape(-1, 1, 1)
    hi = lohi[:, 1].reshape(-1, 1, 1)
    out = (xb - lo) / (hi - lo + torch.full((), eps, dtype=torch.float32, device=x.device))
    return out[0] if single else out
