"""Launcher of `csrc/clahe_core.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)
_MAX_TILES = 16 * 16  # 128 KB of 16-bit counts: within a block's 227 KB


def clahe_core_cuda(vbins, vtiles, pbins, ptiles, pw, clim, area, n_tiles: int) -> torch.Tensor:
    """Per-cell CLAHE core; argument layouts as in `ops.clahe.clahe_core`.
    Returns (C, P) float32 floor-blended grays."""
    global LAUNCHES
    args = (vbins, vtiles, pbins, ptiles, pw, clim, area)
    dev = vbins.device
    if not all(a.is_cuda and a.device == dev for a in args):
        raise ValueError("clahe_core_cuda: every input must be on one CUDA device")
    if any(a.dtype != torch.int32 for a in args):
        raise TypeError("clahe_core_cuda: int32 inputs only")
    if not 1 <= n_tiles <= _MAX_TILES:
        raise ValueError(f"clahe_core_cuda: n_tiles {n_tiles} outside [1, {_MAX_TILES}]")
    C, Pv = vbins.shape
    P = pbins.shape[1]
    if (vtiles.shape != (C, Pv) or pbins.shape != (C, P) or ptiles.shape != (C, P, 4)
            or pw.shape != (C, P, 4) or clim.shape != (C,) or area.shape != (C,)):
        raise ValueError("clahe_core_cuda: inconsistent input shapes")
    vbins, vtiles, pbins, ptiles, pw, clim, area = (a.contiguous() for a in args)
    out = torch.empty((C, P), dtype=torch.float32, device=dev)
    err = library().cia_clahe_core(
        vbins.data_ptr(), vtiles.data_ptr(), Pv, pbins.data_ptr(), ptiles.data_ptr(),
        pw.data_ptr(), P, clim.data_ptr(), area.data_ptr(), C, n_tiles, out.data_ptr(),
        stream_ptr(dev))
    check(err, "clahe_core")
    LAUNCHES += 1
    return out
