"""Launcher of `csrc/vit_linear.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import c_ints, check, library, stream_ptr

LAUNCHES = 0  # calls of the C entry point since the last reset
ROW_TILE = 128  # rows of x a kernel tile: M must be a multiple of it
COL_TILE = 128  # columns of y a kernel tile: N must be a multiple of it
K_STEP = 32     # k a pipeline stage: K must be a multiple of it


def takes(M: int, N: int, K: int) -> bool:
    """Whether the kernel takes an (M, K) x (N, K)^T product."""
    return M > 0 and N > 0 and K > 0 and M % ROW_TILE == 0 and N % COL_TILE == 0 and K % K_STEP == 0


def vit_linear_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None) -> torch.Tensor:
    """x (..., K) W^T + bias for W (N, K) and bias (N) or None, float32 on one
    CUDA device, with `takes` true for M = x.numel() / K -> (..., N)."""
    global LAUNCHES
    ts = (x, weight) if bias is None else (x, weight, bias)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("vit_linear_cuda: x, weight and bias on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("vit_linear_cuda: float32 tensors only")
    K = x.shape[-1]
    N = weight.shape[0]
    M = x.numel() // K if K else 0
    if (weight.dim() != 2 or weight.shape[1] != K or (bias is not None and bias.shape != (N,))
            or not takes(M, N, K)):
        raise ValueError(f"vit_linear_cuda: x {tuple(x.shape)}, weight {tuple(weight.shape)}"
                         f"{'' if bias is None else f', bias {tuple(bias.shape)}'} outside the "
                         f"kernel's (M, K) x (N, K) with M a multiple of {ROW_TILE}, N of "
                         f"{COL_TILE}, K of {K_STEP}")
    c_ints(f"vit_linear_cuda {tuple(x.shape)}", M=M, N=N, K=K)
    x, weight = x.contiguous(), weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    if x.data_ptr() % 16 or weight.data_ptr() % 16 or (bias is not None and bias.data_ptr() % 8):
        raise ValueError("vit_linear_cuda: x and weight 16-byte aligned, bias 8-byte aligned")
    out = torch.empty(*x.shape[:-1], N, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = library().cia_vit_linear(x.data_ptr(), weight.data_ptr(),
                                       None if bias is None else bias.data_ptr(),
                                       out.data_ptr(), M, N, K, stream_ptr(x.device))
    check(err, "vit_linear")
    LAUNCHES += 1
    return out
