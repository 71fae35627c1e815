"""Launcher of `csrc/segment_sum.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)


def segment_sums_cuda(seg: torch.Tensor, data: torch.Tensor, n_seg: int) -> torch.Tensor:
    """seg (P,) int32, data (P, F) int64 -> (n_seg, F) int64; segments outside
    [0, n_seg) are dropped."""
    global LAUNCHES
    if not (seg.is_cuda and data.device == seg.device):
        raise ValueError("segment_sums_cuda: seg and data must be on one CUDA device")
    if seg.dtype != torch.int32 or data.dtype != torch.int64:
        raise TypeError("segment_sums_cuda: seg int32 and data int64 only")
    P, F = data.shape
    if seg.shape != (P,):
        raise ValueError(f"segment_sums_cuda: seg {tuple(seg.shape)} vs data {tuple(data.shape)}")
    seg, data = seg.contiguous(), data.contiguous()
    out = torch.zeros((n_seg, F), dtype=torch.int64, device=data.device)
    with torch.cuda.device(data.device):
        err = library().cia_segment_sum_i64(
            seg.data_ptr(), data.data_ptr(), out.data_ptr(), P, F, n_seg,
            stream_ptr(data.device))
    check(err, "segment_sum")
    LAUNCHES += 1
    return out
