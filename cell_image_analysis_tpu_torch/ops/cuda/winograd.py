"""Launcher of `csrc/winograd_conv3x3.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import c_ints, check, library, stream_ptr
from cell_image_analysis_tpu_torch.ops.winograd import CI_ALIGN, CO_BLOCK
from cell_image_analysis_tpu_torch.utils.profiler import count

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)
# the input prologue keeps an image's scale and shift in shared memory beside
# the kernel's 182,912-byte ring, within the H100's 232,448 bytes a block
PROLOGUE_MAX_CI = (232448 - 182912) // 8


def winograd_conv3x3_cuda(x: torch.Tensor, U_hi: torch.Tensor, U_lo: torch.Tensor,
                          bias: torch.Tensor, *, scale: torch.Tensor | None = None,
                          shift: torch.Tensor | None = None, out_relu: bool = False,
                          frame: tuple | None = None) -> torch.Tensor:
    """x (B, H, W, Ci) NHWC float32 with Ci a positive multiple of 8 and H,
    W even; U_hi, U_lo the TF32 halves of G W G^T in the kernel's layout
    (Co_p/32, Ci/8, 16, 2, 32, 4), Co_p = Co rounded up to 32
    (`ops.winograd.winograd_operands`, `kernel_filter_layout`); bias (Co,)
    -> (B, H, W, Co).

    With `scale` (Ci,) and `shift` (Ci,) or (B, Ci) the kernel convolves
    relu(scale x + shift) over the pixels of `frame` = (h, w), the rows and
    columns of x before its even padding (default: all of x); every other
    pixel, and SAME padding, reads 0.  Else `out_relu` applies
    torch.relu_'s ReLU at the store.  Counts `winograd.launches`, and
    `winograd.fused` where either is on."""
    global LAUNCHES
    ts = (x, U_hi, U_lo, bias)
    act = () if scale is None else (scale, shift)
    if (scale is None) != (shift is None) or (act and out_relu):
        raise ValueError("winograd_conv3x3_cuda: scale and shift go together, and not with "
                         "out_relu")
    if not all(t.is_cuda and t.device == x.device for t in ts + act):
        raise ValueError("winograd_conv3x3_cuda: x, U_hi, U_lo, bias, scale and shift must be "
                         "on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts + act):
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
    if act and Ci > PROLOGUE_MAX_CI:
        raise ValueError(f"winograd_conv3x3_cuda: the input prologue takes at most "
                         f"{PROLOGUE_MAX_CI} channels, got {Ci}")
    if act and (scale.shape != (Ci,) or shift.shape not in ((Ci,), (B, Ci))):
        raise ValueError(f"winograd_conv3x3_cuda: scale {tuple(scale.shape)} / shift "
                         f"{tuple(shift.shape)} do not match ({Ci},) / ({Ci},) or ({B}, {Ci})")
    h_in, w_in = (H, W) if frame is None else frame
    if not (0 <= h_in <= H and 0 <= w_in <= W):
        raise ValueError(f"winograd_conv3x3_cuda: frame {frame} outside {H}x{W}")
    if B > 65535:
        raise ValueError("winograd_conv3x3_cuda: batch above 65535")
    # the kernel forms its offsets in size_t: only the arguments are 32-bit
    c_ints(f"winograd_conv3x3_cuda {tuple(x.shape)} -> {Co}", H=H, W=W, Ci=Ci, Co=Co)
    x, U_hi, U_lo, bias = (t.contiguous() for t in ts)
    if act:
        scale, shift = act = scale.contiguous(), shift.contiguous()
    if any(t.data_ptr() % 16 for t in (x, U_hi, U_lo) + act):
        raise ValueError("winograd_conv3x3_cuda: x, U_hi, U_lo, scale and shift must be "
                         "16-byte aligned")
    y = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().cia_winograd_conv3x3(
            x.data_ptr(), U_hi.data_ptr(), U_lo.data_ptr(), bias.data_ptr(),
            scale.data_ptr() if act else None, shift.data_ptr() if act else None, y.data_ptr(),
            B, H, W, h_in, w_in, Ci, Co, Ci if act and shift.dim() == 2 else 0, int(out_relu),
            stream_ptr(x.device))
    check(err, "winograd_conv3x3")
    LAUNCHES += 1
    count("winograd.launches")
    if act or out_relu:
        count("winograd.fused")
    return y
