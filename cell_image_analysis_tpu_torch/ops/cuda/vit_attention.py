"""Launcher of `csrc/vit_attention.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import c_ints, check, library, stream_ptr

LAUNCHES = 0  # calls of the C entry point since the last reset
HEAD_DIM = 64   # the kernel's head dimension
KEY_COLS = 32   # key tokens a key row: rel_w's width
QUERY_BLOCK = 128  # queries a kernel block: N must be a multiple of it


def takes(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor) -> bool:
    """Whether the kernel takes these shapes: head dimension 64, a key grid
    32 tokens wide, N a multiple of 128, at most 65,535 heads."""
    BH, N, D = q.shape
    return (D == HEAD_DIM and rel_w.shape[-1] == KEY_COLS and N % QUERY_BLOCK == 0
            and N == rel_h.shape[-1] * KEY_COLS and 0 < BH <= 65535)


def key_permuted_vt(v: torch.Tensor) -> torch.Tensor:
    """v (BH, N, D) -> (BH, D, N) with the keys of every group of 8 in the
    order (0, 2, 4, 6, 1, 3, 5, 7): vt[b, d, 8 c + 4 e + i] = v[b, 8 c + 2 i
    + e, d], the B operand order of the kernel's P V products."""
    BH, N, D = v.shape
    return v.reshape(BH, N // 8, 4, 2, D).permute(0, 4, 1, 3, 2).reshape(BH, D, N)


def vit_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                       rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax((q scale) k^T + rel_h[:, :, key // 32] + rel_w[:, :, key %
    32]) v for q, k, v (BH, N, 64), rel_h (BH, N, N / 32), rel_w (BH, N,
    32), float32 on one CUDA device, with `takes` true -> (BH, N, 64)."""
    global LAUNCHES
    ts = (q, k, v, rel_h, rel_w)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("vit_attention_cuda: q, k, v, rel_h and rel_w on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("vit_attention_cuda: float32 tensors only")
    BH, N, _ = q.shape
    if (k.shape != q.shape or v.shape != q.shape or rel_h.shape[:2] != (BH, N)
            or rel_w.shape[:2] != (BH, N) or not takes(q, rel_h, rel_w)):
        raise ValueError(f"vit_attention_cuda: q, k, v {tuple(q.shape)}, rel_h "
                         f"{tuple(rel_h.shape)}, rel_w {tuple(rel_w.shape)} outside the "
                         f"kernel's (BH, N, {HEAD_DIM}), (BH, N, N / {KEY_COLS}), (BH, N, "
                         f"{KEY_COLS}) with N a multiple of {QUERY_BLOCK}")
    c_ints(f"vit_attention_cuda {tuple(q.shape)}", BH=BH, N=N)
    q, k, rel_h, rel_w = (t.contiguous() for t in (q, k, rel_h, rel_w))
    vt = key_permuted_vt(v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().cia_vit_attention(q.data_ptr(), k.data_ptr(), vt.data_ptr(),
                                          rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(), BH,
                                          N, rel_h.shape[-1], float(scale),
                                          stream_ptr(q.device))
    check(err, "vit_attention")
    LAUNCHES += 1
    return out
