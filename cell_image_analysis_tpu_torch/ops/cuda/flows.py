"""Launcher of `csrc/follow_flows.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import c_ints, check, library, stream_ptr

LAUNCHES = 0  # calls of the C entry point since the last reset (read by chip_smoke.py)
KERNELS_PER_CALL = 2  # follow_flows_count_kernel and follow_flows_kernel


def follow_flows_cuda(dP: torch.Tensor, cellprob: torch.Tensor, niter: int = 200,
                      threshold: float = 0.0) -> tuple:
    """(final (y, x) (B, 2, H, W) float32, moving points (B,) int32) of the
    flows dP (B, 2, H, W) and cell probabilities (B, H, W), float32 on one
    CUDA device: the contract of `ops.flows.follow_flows`."""
    global LAUNCHES
    if not (dP.is_cuda and cellprob.is_cuda) or dP.device != cellprob.device:
        raise ValueError("follow_flows_cuda: dP and cellprob on one CUDA device")
    if dP.dtype != torch.float32 or cellprob.dtype != torch.float32:
        raise TypeError(f"follow_flows_cuda: float32 only, got {dP.dtype}, {cellprob.dtype}")
    if dP.dim() != 4 or dP.shape[1] != 2 or tuple(cellprob.shape) != (dP.shape[0],
                                                                      *dP.shape[2:]):
        raise ValueError(f"follow_flows_cuda: dP (B, 2, H, W) and cellprob (B, H, W), got "
                         f"{tuple(dP.shape)} and {tuple(cellprob.shape)}")
    B, _, h, w = dP.shape
    c_ints(f"follow_flows_cuda {tuple(dP.shape)}", B=B, H=h, W=w, niter=niter)
    if B > 65535 or h < 2 or w < 2:
        raise ValueError(f"follow_flows_cuda: (B, H, W) = {(B, h, w)} outside B <= 65535, "
                         "H and W >= 2")
    dP, cellprob = dP.contiguous(), cellprob.contiguous()
    out = torch.empty_like(dP)
    n_moving = torch.empty((B,), dtype=torch.int32, device=dP.device)
    if B == 0:
        return out, n_moving
    with torch.cuda.device(dP.device):
        err = library().cia_follow_flows(dP.data_ptr(), cellprob.data_ptr(), out.data_ptr(),
                                         n_moving.data_ptr(), B, h, w, niter, float(threshold),
                                         stream_ptr(dP.device))
    check(err, "follow_flows")
    LAUNCHES += 1
    return out, n_moving
