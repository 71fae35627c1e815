"""SAME 3x3 stride-1 convolution, routed through the Winograd CUDA kernel.

Counterpart of `cell_image_analysis_tpu/ops/winograd.py` (the transform)
and `ops/pallas/winograd.py` (the fused kernel).  `winograd_conv3x3`
launches `csrc/winograd_conv3x3.cu` for CUDA tensors and runs the plain
version, `F.conv2d`, for CPU tensors.  The plain version computes in
float32 (the package turns TF32 off).  The kernel runs its products as
3xTF32 on the tensor cores: each operand is split into a TF32 hi half and
a TF32 lo half (`tf32_split`) and the three larger cross products are
summed in float32, which keeps float32-level accuracy (~2^-22 relative a
product).  The kernel tiles the output in 2x2 blocks; an odd side gets one
zero row or column appended, which is what SAME padding reads there, and
the extra output is cut off.  Its loads are 16-byte copies, so Ci is
zero-padded to a multiple of 8 (with U's rows), and U's Co to a multiple
of the kernel's 32-channel block; U goes in the order the kernel's ring
stages read it (`kernel_filter_layout`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# G (4x3) of F(2, 3): U = G W G^T; entries 0, +-1/2, 1 are exact in float32
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
CI_ALIGN = 8    # the kernel's input-channel slice (one MMA k-step)
CO_BLOCK = 32   # the kernel's output-channel block


@functools.lru_cache(maxsize=None)
def _g_matrix(device: torch.device) -> torch.Tensor:
    """G on `device`, uploaded once: a copy from the host holds the host up."""
    return torch.tensor(_G, dtype=torch.float32, device=device)


def winograd_kernel_transform(W: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO -> (4, 4, Ci, Co) Winograd-domain filter G W G^T."""
    G = _g_matrix(W.device)
    return torch.einsum("au,uvio,bv->abio", G, W.float(), G)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as float32 with the low 13 mantissa bits zero: what the PTX
    instruction `cvt.rna.tf32.f32` gives.  Adding half an ulp of TF32 to
    the sign-magnitude bit pattern rounds the magnitude half up."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values: hi = tf32_round(x), lo =
    tf32_round(x - hi) (x - hi is exact in float32).  For normal x,
    |x - hi| <= 2^-11 |x| and |x - hi - lo| <= 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def kernel_filter_layout(U: torch.Tensor) -> torch.Tensor:
    """(16, Ci_p, Co_p) -> the kernel's layout (Co_p/32, Ci_p/8, 16, 2, 32,
    4): one ring stage (a 32-channel output block, an 8-channel input slice,
    all 16 positions) is one contiguous 16 KB run, K-major inside as
    `wgmma` reads B: [position][input channels 0-3 | 4-7][output channel][4]."""
    _, ci_p, co_p = U.shape
    return (U.reshape(16, ci_p // CI_ALIGN, 2, 4, co_p // CO_BLOCK, CO_BLOCK)
            .permute(4, 1, 0, 2, 5, 3).contiguous())


def winograd_operands(W: torch.Tensor, bias: torch.Tensor | None = None):
    """The kernel's filter operands: U = G W G^T split into TF32 halves
    (U_hi, U_lo), zero-padded to Ci_p = Ci rounded up to 8 and Co_p = Co
    rounded up to 32, in `kernel_filter_layout`; and the float32 bias (Co,)."""
    ci, co = W.shape[2], W.shape[3]
    ci_p = -(-ci // CI_ALIGN) * CI_ALIGN
    co_p = -(-co // CO_BLOCK) * CO_BLOCK
    U = winograd_kernel_transform(W).reshape(16, ci, co)
    U_hi, U_lo = tf32_split(F.pad(U, (0, co_p - co, 0, ci_p - ci)))
    if bias is None:
        bias = torch.zeros(co, dtype=torch.float32, device=W.device)
    return kernel_filter_layout(U_hi), kernel_filter_layout(U_lo), bias.float().contiguous()


def pad_input(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Ci) -> float32 with even H and W and Ci a multiple of 8
    (zeros appended: SAME padding reads zeros there, and zero channels meet
    zero rows of U)."""
    h, w, ci = x.shape[1:]
    pads = (0, (-ci) % CI_ALIGN, 0, w % 2, 0, h % 2)
    return F.pad(x.float(), pads) if any(pads) else x.float()


def winograd_conv3x3_plain(x: torch.Tensor, W: torch.Tensor,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: x (B, H, W, Ci) NHWC, W (3, 3, Ci, Co) HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), W.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def winograd_conv3x3(x: torch.Tensor, W: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """SAME 3x3 correlation + bias.  x (B, H, W, Ci) float32; W (3, 3, Ci,
    Co) HWIO; bias (Co,) or None.  Returns (B, H, W, Co)."""
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, W, bias)
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda

    h, w = x.shape[1:3]
    y = winograd_conv3x3_cuda(pad_input(x), *winograd_operands(W, bias))
    return y[:, :h, :w].contiguous() if (h % 2 or w % 2) else y
