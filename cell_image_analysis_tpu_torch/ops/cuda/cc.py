"""Launcher of `csrc/cc_tile_labels.cu` (see its header for the design)."""

from __future__ import annotations

import itertools

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

# wrapper calls since the last reset (read by chip_smoke.py)
LAUNCHES = 0
# kernels one call launches: cc_tile_local, _merge, _roots, _scan, _write
KERNELS_PER_CALL = 5
# the kernel's tile (TH x TW in csrc/cc_tile_labels.cu): 64 columns, one
# 64-bit word of root bits a (row, tile column) segment
TILE_H, TILE_W = 32, 64


def label_components_cuda(mask: torch.Tensor, connectivity: int = 1):
    """(B, H, W) bool -> (labels (B, H, W) int32, count (B,) int32): the
    contract of `ops.cc.label_components`.  The mask's bytes are read in
    place."""
    global LAUNCHES
    if not mask.is_cuda:
        raise ValueError("label_components_cuda: mask must be on a CUDA device")
    if mask.dtype != torch.bool or mask.dim() != 3:
        raise TypeError(f"label_components_cuda: (B, H, W) bool only, got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("label_components_cuda: mask must be contiguous")
    if connectivity not in (1, 2):
        raise ValueError(f"label_components_cuda: connectivity 1 or 2, got {connectivity}")
    B, h, w = mask.shape
    if h * w >= 2 ** 31:
        raise ValueError("label_components_cuda: a frame must have fewer than 2^31 pixels")
    labels = torch.empty((B, h, w), dtype=torch.int32, device=mask.device)
    if mask.numel() == 0:
        return labels, torch.zeros((B,), dtype=torch.int32, device=mask.device)
    count = torch.empty((B,), dtype=torch.int32, device=mask.device)
    # one scratch allocation, 16-byte aligned parts: parent (B, H, W) int32,
    # the segments' root bits (B, H, ceil(W / 64)) uint64 and their offsets
    # within the row int32, the rows' first labels (B, H) int32
    n_seg = B * h * -(-w // TILE_W)
    at = list(itertools.accumulate(-(-n // 16) * 16 for n in (B * h * w * 4, n_seg * 8,
                                                            n_seg * 4, B * h * 4)))
    scratch = torch.empty((at[-1],), dtype=torch.uint8, device=mask.device)
    ptr = scratch.data_ptr()
    with torch.cuda.device(mask.device):
        err = library().cia_cc_label_components(
            mask.data_ptr(), ptr, ptr + at[0], ptr + at[1], ptr + at[2], labels.data_ptr(),
            count.data_ptr(), B, h, w, connectivity, stream_ptr(mask.device))
    check(err, "label_components")
    LAUNCHES += 1
    return labels, count
