"""Launcher of `csrc/cc_min_labels.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

# calls since the last reset (read by chip_smoke.py); each call launches
# three kernels: init, union, flatten
LAUNCHES = 0


def cc_min_labels_cuda(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 raw min-index labels (the contract
    of `ops.cc.cc_min_labels`)."""
    global LAUNCHES
    if not mask.is_cuda:
        raise ValueError("cc_min_labels_cuda: mask must be on a CUDA device")
    if mask.dtype != torch.bool or mask.dim() != 3:
        raise TypeError(f"cc_min_labels_cuda: (B, H, W) bool only, got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    if connectivity not in (1, 2):
        raise ValueError(f"cc_min_labels_cuda: connectivity 1 or 2, got {connectivity}")
    B, h, w = mask.shape
    if h * w >= 2 ** 31:
        raise ValueError("cc_min_labels_cuda: a frame must have fewer than 2^31 pixels")
    m8 = mask.to(torch.uint8).contiguous()
    parent = torch.empty((B, h, w), dtype=torch.int32, device=mask.device)
    out = torch.empty((B, h, w), dtype=torch.int32, device=mask.device)
    err = library().cia_cc_min_labels(m8.data_ptr(), parent.data_ptr(), out.data_ptr(),
                                      B, h, w, connectivity, stream_ptr(mask.device))
    check(err, "cc_min_labels")
    LAUNCHES += 1
    return out
