"""Per-cell 2D-FFT spectral features.

Counterpart of `cell_image_analysis_tpu/ops/fft_features.py`: 16 radial
and 8 angular power fractions, the spectral centroid, the high-frequency
fraction and log10 of the total AC power.  The bin maps and masks depend
only on the cell shape and are built on the host in float64 numpy, as in
the JAX package, so no device transcendental decides a bin.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _geometry(h: int, w: int, radial_bins: int, angular_bins: int):
    """Host float64 geometry: (dc, r_onehot, a_onehot, r_norm, high) arrays."""
    cy, cx = h // 2, w // 2
    yy = (np.arange(h) - cy).astype(np.float64)[:, None]
    xx = (np.arange(w) - cx).astype(np.float64)[None, :]
    r = np.sqrt(yy * yy + xx * xx)
    r_norm = r / (min(h, w) / 2.0)
    theta = np.arctan2(yy, xx) % np.pi
    r_bin = np.clip((r_norm * radial_bins).astype(np.int64), 0, radial_bins - 1)
    a_bin = np.clip((theta / np.pi * angular_bins).astype(np.int64), 0, angular_bins - 1)
    return (r == 0.0, np.eye(radial_bins, dtype=np.float32)[r_bin],
            np.eye(angular_bins, dtype=np.float32)[a_bin],
            r_norm.astype(np.float32), r_norm > 0.5)


def fft_features(cells: torch.Tensor, radial_bins: int = 16,
                 angular_bins: int = 8) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) -> (B, radial_bins + angular_bins + 3)."""
    if cells.dim() == 4:
        cells = cells[..., 0]
    b, h, w = cells.shape
    dev = cells.device
    Fq = torch.fft.fftshift(torch.fft.fft2(cells.float()), dim=(-2, -1))
    power = torch.abs(Fq) ** 2

    dc, r_oh, a_oh, r_norm, high = (torch.as_tensor(a, device=dev) for a in
                                    _geometry(h, w, radial_bins, angular_bins))
    ac_power = torch.where(dc, torch.zeros((), device=dev), power)
    total = ac_power.sum(dim=(-2, -1))
    total_safe = torch.clamp(total, min=1e-20)
    flat = ac_power.reshape(b, h * w)
    radial = torch.matmul(flat, r_oh.reshape(h * w, -1)) / total_safe[:, None]
    angular = torch.matmul(flat, a_oh.reshape(h * w, -1)) / total_safe[:, None]
    centroid = (ac_power * r_norm).sum(dim=(-2, -1)) / total_safe
    high_freq = (torch.where(high, ac_power, torch.zeros((), device=dev)).sum(dim=(-2, -1))
                 / total_safe)
    tp = torch.log10(total_safe)
    return torch.cat([radial, angular, centroid[:, None], high_freq[:, None], tp[:, None]], dim=1)
