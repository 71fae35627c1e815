"""Launcher of `csrc/winograd_conv3x3.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import c_ints, check, library, stream_ptr
from cell_image_analysis_tpu_torch.ops.winograd import CI_ALIGN, CO_BLOCK

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)


def winograd_conv3x3_cuda(x: torch.Tensor, U_hi: torch.Tensor, U_lo: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Ci) NHWC float32 with Ci a positive multiple of 8 and H,
    W even; U_hi, U_lo the TF32 halves of G W G^T in the kernel's layout
    (Co_p/32, Ci/8, 16, 2, 32, 4), Co_p = Co rounded up to 32
    (`ops.winograd.winograd_operands`, `kernel_filter_layout`); bias (Co,)
    -> (B, H, W, Co)."""
    global LAUNCHES
    ts = (x, U_hi, U_lo, bias)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("winograd_conv3x3_cuda: x, U_hi, U_lo and bias must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("winograd_conv3x3_cuda: float32 tensors only")
    B, H, W, Ci = x.shape
    Co = bias.shape[0]
    if H % 2 or W % 2 or Ci % CI_ALIGN or Ci == 0:
        raise ValueError(f"winograd_conv3x3_cuda: H, W must be even and Ci a positive "
                         f"multiple of 8, got {H}x{W}x{Ci}")
    u_shape = (-(-Co // CO_BLOCK), Ci // CI_ALIGN, 16, 2, CO_BLOCK, 4)
    if bias.dim() != 1 or U_hi.shape != u_shape or U_lo.shape != u_shape:
        raise ValueError(f"winograd_conv3x3_cuda: U_hi {tuple(U_hi.shape)} / U_lo "
                         f"{tuple(U_lo.shape)} / bias {tuple(bias.shape)} do not match "
                         f"{u_shape} / ({Co},)")
    if B > 65535:
        raise ValueError("winograd_conv3x3_cuda: batch above 65535")
    # the kernel forms its offsets in size_t: only the arguments are 32-bit
    c_ints(f"winograd_conv3x3_cuda {tuple(x.shape)} -> {Co}", H=H, W=W, Ci=Ci, Co=Co)
    x, U_hi, U_lo, bias = (t.contiguous() for t in ts)
    if any(t.data_ptr() % 16 for t in (x, U_hi, U_lo)):
        raise ValueError("winograd_conv3x3_cuda: x, U_hi and U_lo must be 16-byte aligned")
    y = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().cia_winograd_conv3x3(
            x.data_ptr(), U_hi.data_ptr(), U_lo.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, H, W, Ci, Co, stream_ptr(x.device))
    check(err, "winograd_conv3x3")
    LAUNCHES += 1
    return y
