"""SAME 3x3 stride-1 convolution, routed through the Winograd CUDA kernel.

Counterpart of `cell_image_analysis_tpu/ops/winograd.py` (the transform)
and `ops/pallas/winograd.py` (the fused kernel).  `winograd_conv3x3`
launches `csrc/winograd_conv3x3.cu` for CUDA tensors and runs the plain
version, `F.conv2d`, for CPU tensors.  Both compute in float32 (the package
turns TF32 off), so the kernel differs from the plain version by the
reassociation of Winograd F(2x2, 3x3) only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# G (4x3) of F(2, 3): U = G W G^T; entries 0, +-1/2, 1 are exact in float32
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def winograd_kernel_transform(W: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO -> (4, 4, Ci, Co) Winograd-domain filter G W G^T."""
    G = torch.tensor(_G, dtype=torch.float32, device=W.device)
    return torch.einsum("au,uvio,bv->abio", G, W.float(), G)


def winograd_conv3x3_plain(x: torch.Tensor, W: torch.Tensor,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: x (B, H, W, Ci) NHWC, W (3, 3, Ci, Co) HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), W.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def winograd_conv3x3(x: torch.Tensor, W: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """SAME 3x3 correlation + bias.  x (B, H, W, Ci) float32 with H, W even;
    W (3, 3, Ci, Co) HWIO; bias (Co,) or None.  Returns (B, H, W, Co)."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"winograd_conv3x3: H and W must be even, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, W, bias)
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda

    ci, co = W.shape[2], W.shape[3]
    U = winograd_kernel_transform(W).reshape(16, ci, co)
    if bias is None:
        bias = torch.zeros(co, dtype=torch.float32, device=x.device)
    return winograd_conv3x3_cuda(x.float(), U, bias.float())
