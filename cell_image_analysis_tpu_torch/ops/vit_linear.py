"""The ViT blocks' linears, y = x W^T + b, routed through the 3xTF32
tensor-core GEMM.

The JAX package has no counterpart.  `vit_linear(x, weight, bias)` has
`F.linear`'s semantics and `nn.Linear`'s weight layout (N, K).  It
launches `csrc/vit_linear.cu` for CUDA tensors and runs
`vit_linear_plain` (`F.linear`) for CPU tensors.  The kernel takes float32
with M = x.numel() / K a multiple of 128, N a multiple of 128 and K a
multiple of 32 (Cellpose-SAM's qkv, proj, lin1 and lin2 at 1,024 tokens a
tile); other shapes on the card raise ValueError.  It keeps float32
accuracy: three TF32 products (lo*hi + hi*lo + hi*hi), summed in float32
outside the tensor cores once every 32 of K.

Under grad mode, when a tensor argument requires grad, the op has a
gradient (`VitLinearFn`): the forward comes back here with grad off (the
kernel on the card), and the backward is the plain version's gradient.
Counters `vit.linear_calls` (every forward) and `vit.linear_fused` (the
kernel's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.utils.profiler import count


def vit_linear_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None) -> torch.Tensor:
    """x W^T + b, as `nn.Linear` computes it."""
    return F.linear(x, weight, bias)


def vit_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K), weight (N, K), bias (N) or None -> (..., N), float32: the
    kernel for CUDA tensors, the plain version for CPU tensors;
    `VitLinearFn` when an argument requires grad."""
    ts = (x, weight) if bias is None else (x, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return VitLinearFn.apply(x, weight, bias)
    count("vit.linear_calls")
    if not x.is_cuda:
        return vit_linear_plain(x, weight, bias)
    from cell_image_analysis_tpu_torch.ops.cuda.vit_linear import vit_linear_cuda

    out = vit_linear_cuda(x, weight, bias)
    count("vit.linear_fused")
    return out


class VitLinearFn(torch.autograd.Function):
    """`vit_linear` with a gradient: the forward through `vit_linear` with
    grad off, the backward by the plain version's autograd on the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return vit_linear(x, weight, bias)

    @staticmethod
    def backward(ctx, dout):
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = vit_linear_plain(*ins)
        wants = [t for t in ins if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wants, dout))
        return tuple(next(grads) if t is not None and t.requires_grad else None for t in ins)
