"""Anti-aliased resize of capacity-padded crops, as two matmuls per cell.

Counterpart of `cell_image_analysis_tpu/ops/resize.py` (skimage
`resize(..., anti_aliasing=True)` semantics): per axis, the Gaussian
pre-filter (sigma = max(0, (s - 1) / 2), truncate 4, mirror boundary) and
the order-1 grid-mode resample collapse into one (out, cap) operator
built against the crop capacity, and the crop becomes `R_h @ crop @ R_w^T`.
"""

from __future__ import annotations

import torch


def _max_blur_radius(cap: int, out_size: int) -> int:
    max_sigma = max(0.0, (cap / out_size - 1.0) / 2.0)
    return int(4.0 * max_sigma + 0.5)


def _mirror_index(idx: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    idx = torch.abs(idx)
    idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    return torch.minimum(torch.clamp(idx, min=0), torch.clamp(n - 1, min=0))


def _mirror_coord(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    x = torch.abs(x)
    nf = (n - 1).float()
    x = torch.where(x > nf, 2.0 * nf - x, x)
    return torch.minimum(torch.clamp(x, min=0.0), torch.clamp(nf, min=0.0))


def gaussian_operator(n: torch.Tensor, sigma: torch.Tensor, cap: int, out_size: int):
    """(C, cap, cap) G with G @ v == gaussian_filter1d(v[:n], sigma,
    truncate=4, mode='mirror') on the first n rows; n, sigma (C, 1)."""
    R = _max_blur_radius(cap, out_size)
    dev = n.device
    p = torch.arange(cap, device=dev)
    row_valid = (p < n).float()                                      # (C, cap)
    radius = torch.floor(4.0 * sigma + 0.5).int()
    sigma_safe = torch.clamp(sigma, min=1e-12)
    taps = torch.arange(-R, R + 1, device=dev)
    w = torch.exp(-0.5 * (taps.float() / sigma_safe) ** 2)           # (C, 2R+1)
    w = torch.where(taps.abs() <= radius, w, torch.zeros_like(w))
    w = w / torch.sum(w, dim=1, keepdim=True)
    cols = torch.arange(cap, device=dev)
    G = torch.zeros((n.shape[0], cap, cap), dtype=torch.float32, device=dev)
    for i in range(2 * R + 1):
        q = _mirror_index(p + (i - R), n)                            # (C, cap)
        G = G + w[:, i, None, None] * (q[:, :, None] == cols).float()
    return G * row_valid[:, :, None]


def bilinear_operator(n: torch.Tensor, cap: int, out_size: int):
    """(C, out_size, cap) order-1 grid-mode resampling, mirror boundary."""
    s = n.float() / float(out_size)
    i = torch.arange(out_size, dtype=torch.float32, device=n.device)
    x = _mirror_coord((i + 0.5) * s - 0.5, n)                        # (C, out)
    j0 = torch.floor(x).int()
    frac = x - j0.float()
    j1 = torch.minimum(j0 + 1, torch.clamp(n - 1, min=0))
    cols = torch.arange(cap, device=n.device)
    return ((1.0 - frac)[:, :, None] * (j0[:, :, None] == cols)
            + frac[:, :, None] * (j1[:, :, None] == cols)).float()


def resize_operator(n: torch.Tensor, cap: int, out_size: int) -> torch.Tensor:
    """(C, out_size, cap) blur-then-resample operator for axis lengths n (C,)."""
    n = n.int().reshape(-1, 1)
    s = n.float() / float(out_size)
    sigma = torch.clamp((s - 1.0) / 2.0, min=0.0)
    return torch.matmul(bilinear_operator(n, cap, out_size),
                        gaussian_operator(n, sigma, cap, out_size))


def resize_cells(crops: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor,
                 out_size: int = 64) -> torch.Tensor:
    """(C, cap, cap) crops with valid regions [:h, :w] -> (C, out, out)."""
    cap = crops.shape[-1]
    Rh = resize_operator(heights, cap, out_size)
    Rw = resize_operator(widths, cap, out_size)
    return torch.matmul(torch.matmul(Rh, crops.float()), Rw.transpose(1, 2))
