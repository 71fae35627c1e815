"""Global attention with SAM's decomposed relative-position bias, routed
through the fused CUDA kernel.

The JAX package has no counterpart.  For each of BH heads over N tokens,

    softmax((q scale) k^T + rel_h[:, :, key // kw] + rel_w[:, :, key % kw]) v

where the keys lie on a grid of kh x kw tokens (row-major), and rel_h
(BH, N, kh) and rel_w (BH, N, kw) are formed by the caller from the
unscaled q (SAM's `add_decomposed_rel_pos`, `models.vit_sam`).

`vit_attention` launches `csrc/vit_attention.cu` for CUDA tensors and
runs `vit_attention_plain` for CPU tensors.  The kernel takes head
dimension 64, a key grid 32 tokens wide and N a multiple of 128
(Cellpose-SAM's 32 x 32 tokens); other shapes on the card raise
ValueError.  The plain version materialises the scores, as SAM does.  The
kernel keeps float32 accuracy (3xTF32 products, the online softmax in
float32) and never writes the scores.

Under grad mode, when a tensor argument requires grad, the op has a
gradient (`VitAttentionFn`): the forward comes back here with grad off
(the kernel on the card), and the backward recomputes the plain version
under autograd and takes its gradient, so only training materialises the
scores, one block at a time.  Counters `vit.attention_calls` (every
forward) and `vit.attention_fused` (the kernel's).
"""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.utils.profiler import count


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                        rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """SAM's `Attention` after the projections: the scores (q scale) k^T,
    the bias as `add_decomposed_rel_pos` adds it, softmax, times v."""
    BH, N, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = (attn.view(BH, N, kh, kw) + rel_h[..., None] + rel_w[..., None, :]).view(BH, N, N)
    return attn.softmax(dim=-1) @ v


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                  rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v (BH, N, D); rel_h (BH, N, kh), rel_w (BH, N, kw) with N =
    kh kw -> (BH, N, D), float32: the kernel for CUDA tensors, the plain
    version for CPU tensors; `VitAttentionFn` when an argument requires
    grad."""
    ts = (q, k, v, rel_h, rel_w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return VitAttentionFn.apply(q, k, v, rel_h, rel_w, scale)
    count("vit.attention_calls")
    if not q.is_cuda:
        return vit_attention_plain(q, k, v, rel_h, rel_w, scale)
    from cell_image_analysis_tpu_torch.ops.cuda.vit_attention import vit_attention_cuda

    out = vit_attention_cuda(q, k, v, rel_h, rel_w, scale)
    count("vit.attention_fused")
    return out


class VitAttentionFn(torch.autograd.Function):
    """`vit_attention` with a gradient: the forward through `vit_attention`
    with grad off, the backward by the plain version's autograd on the
    saved inputs (the scores recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.scale = scale
        return vit_attention(q, k, v, rel_h, rel_w, scale)

    @staticmethod
    def backward(ctx, dout):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = vit_attention_plain(*ins, ctx.scale)
        wants = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wants, dout))
        return (*(next(grads) if t.requires_grad else None for t in ins), None)
