"""Launcher of `csrc/winograd_conv3x3.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)


def winograd_conv3x3_cuda(x: torch.Tensor, U: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Ci) NHWC float32, U (16, Ci, Co), bias (Co,) -> (B, H, W, Co)."""
    global LAUNCHES
    if not (x.is_cuda and U.device == x.device and bias.device == x.device):
        raise ValueError("winograd_conv3x3_cuda: x, U and bias must be on one CUDA device")
    if x.dtype != torch.float32 or U.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("winograd_conv3x3_cuda: float32 tensors only")
    B, H, W, Ci = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"winograd_conv3x3_cuda: H and W must be even, got {H}x{W}")
    if U.shape[:2] != (16, Ci) or bias.shape != (U.shape[2],):
        raise ValueError(f"winograd_conv3x3_cuda: U {tuple(U.shape)} / bias "
                         f"{tuple(bias.shape)} do not match Ci={Ci}")
    if B > 65535:
        raise ValueError("winograd_conv3x3_cuda: batch above 65535")
    x, U, bias = x.contiguous(), U.contiguous(), bias.contiguous()
    Co = U.shape[2]
    y = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    err = library().cia_winograd_conv3x3(
        x.data_ptr(), U.data_ptr(), bias.data_ptr(), y.data_ptr(),
        B, H, W, Ci, Co, stream_ptr(x.device))
    check(err, "winograd_conv3x3")
    LAUNCHES += 1
    return y
