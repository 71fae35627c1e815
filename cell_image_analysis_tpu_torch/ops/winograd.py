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

The op takes the elementwise activation next to the conv, so that it is
no pass of its own over device memory on the card: an input prologue
relu(in_scale x + in_shift) per channel (`in_shift` per channel or per
image: a pre-activation network's BatchNorm, style term and ReLU) or an
output ReLU (a post-activation network's).  The kernel applies the
prologue in shared memory and the ReLU at its store; the plain version composes the same
arithmetic in PyTorch (`activate_input`, `torch.relu_`).

Under grad mode the op has a gradient (`WinogradConv3x3Fn`): the data
gradient is itself a SAME 3x3 correlation, of dy with the filter flipped
and transposed, so it runs on the same kernel; the weight gradient is
cuDNN's; the activation is applied around it in PyTorch.  Without grad
(screening, extraction) the call is the direct one.
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


def activate_input(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The input prologue in PyTorch: relu(scale x + shift), `torch.addcmul`
    then `torch.relu_`.  x (B, H, W, Ci); scale (Ci,); shift (Ci,) or (B, Ci)."""
    if shift.dim() == 2:
        shift = shift[:, None, None, :]
    return torch.relu_(torch.addcmul(shift, x, scale))


def winograd_conv3x3_plain(x: torch.Tensor, W: torch.Tensor,
                           bias: torch.Tensor | None = None, *,
                           in_scale: torch.Tensor | None = None,
                           in_shift: torch.Tensor | None = None,
                           out_relu: bool = False) -> torch.Tensor:
    """The plain version: x (B, H, W, Ci) NHWC, W (3, 3, Ci, Co) HWIO; the
    activations as `winograd_conv3x3` takes them."""
    if in_scale is not None:
        x = activate_input(x, in_scale, in_shift)
    y = F.conv2d(x.permute(0, 3, 1, 2), W.permute(3, 2, 0, 1), bias, padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    return torch.relu_(y) if out_relu else y


def input_affine(scale: torch.Tensor, shift: torch.Tensor, ci_p: int) -> tuple:
    """The kernel's prologue operands: scale (Ci_p,) and shift (Ci_p,) or
    (B, Ci_p) in float32, the padded channels 0 in both (so they stay 0)."""
    pad = (0, ci_p - scale.shape[0])
    return F.pad(scale.float(), pad), F.pad(shift.float(), pad)


def winograd_conv3x3(x: torch.Tensor, W: torch.Tensor, bias: torch.Tensor | None = None, *,
                     in_scale: torch.Tensor | None = None, in_shift: torch.Tensor | None = None,
                     out_relu: bool = False) -> torch.Tensor:
    """SAME 3x3 correlation + bias.  x (B, H, W, Ci) float32; W (3, 3, Ci,
    Co) HWIO; bias (Co,) or None.  Returns (B, H, W, Co).  Either an input
    prologue, in_scale (Ci,) and in_shift (Ci,) or (B, Ci): the conv reads
    relu(in_scale x + in_shift) (`activate_input`), and SAME padding pads
    that with zeros; or `out_relu`, the ReLU of the output.

    Under grad mode, when a tensor argument requires grad, the activation
    runs in PyTorch around `WinogradConv3x3Fn`, whose forward and data
    gradient come back here with grad off; otherwise it is the direct call:
    the kernel on CUDA (the activation fused), the plain version on the
    CPU."""
    prologue = in_scale is not None
    if prologue != (in_shift is not None) or (prologue and out_relu):
        raise ValueError("winograd_conv3x3: in_scale and in_shift go together, and not with "
                         "out_relu")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, W, bias, in_scale, in_shift)):
        if prologue:
            x = activate_input(x, in_scale, in_shift)
        y = WinogradConv3x3Fn.apply(x, W, bias)
        return torch.relu_(y) if out_relu else y
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, W, bias, in_scale=in_scale, in_shift=in_shift,
                                      out_relu=out_relu)
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda

    h, w = x.shape[1:3]
    xp = pad_input(x)
    scale, shift = input_affine(in_scale, in_shift, xp.shape[-1]) if prologue else (None, None)
    y = winograd_conv3x3_cuda(xp, *winograd_operands(W, bias), scale=scale, shift=shift,
                              out_relu=out_relu, frame=(h, w))
    return y[:, :h, :w].contiguous() if (h % 2 or w % 2) else y


def flip_transpose(W: torch.Tensor) -> torch.Tensor:
    """W (3, 3, Ci, Co) -> W' (3, 3, Co, Ci), W'[a, b, o, i] = W[2 - a, 2 - b,
    i, o]: the filter whose SAME correlation with dy is the data gradient."""
    return W.flip(0, 1).transpose(2, 3)


class WinogradConv3x3Fn(torch.autograd.Function):
    """`winograd_conv3x3` with a gradient.  The forward and the data
    gradient both run through `winograd_conv3x3` (on CUDA the kernel: a SAME
    3x3 stride-1 correlation of dy with `flip_transpose(W)` is dx, odd sides
    by the same pad-and-cut).  The weight gradient is cuDNN's
    `conv2d_weight` (float32, TF32 off, deterministic algorithms): the JAX
    package differentiates its U-Net's convs in XLA, outside any Pallas
    kernel.  Only x and W are saved, not the output, which the U-Net's ReLU
    overwrites in place."""

    @staticmethod
    def forward(ctx, x, W, bias):
        ctx.save_for_backward(x, W)
        y = winograd_conv3x3(x, W, bias)
        # the plain version's NHWC output can be a view of F.conv2d's, and a
        # custom Function's output that is a view cannot be changed in place
        return y if y._base is None else y.clone()

    @staticmethod
    def backward(ctx, dy):
        x, W = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dW = db = None
        if ctx.needs_input_grad[0]:
            dx = winograd_conv3x3(dy, flip_transpose(W))
        if ctx.needs_input_grad[1]:
            # cuDNN's deterministic algorithms only: the heuristic's default
            # for these shapes sums with atomics, and one run of training
            # would not repeat another
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                dW = torch.nn.grad.conv2d_weight(
                    x.permute(0, 3, 1, 2), (W.shape[3], W.shape[2], 3, 3),
                    dy.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2))
        return dx, dW, db
