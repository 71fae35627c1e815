"""Exact segment sums of integer-valued data, routed through the CUDA kernel.

Counterpart of `cell_image_analysis_tpu/ops/pallas/segsum.py`
(`segment_sums_pallas`).  The port sums int64 data, so the result is
exact and independent of summation order; the caller converts to float32
where it needs to.  `segment_sums` launches `csrc/segment_sum.cu` for CUDA
tensors and runs the plain version, `index_add_`, for CPU tensors.
"""

from __future__ import annotations

import torch


def segment_sums_plain(seg: torch.Tensor, data: torch.Tensor, n_seg: int) -> torch.Tensor:
    """The plain version (same contract as `segment_sums`)."""
    keep = (seg >= 0) & (seg < n_seg)
    out = torch.zeros((n_seg, data.shape[1]), dtype=torch.int64, device=data.device)
    return out.index_add_(0, seg[keep].long(), data[keep])


def segment_sums(seg: torch.Tensor, data: torch.Tensor, n_seg: int) -> torch.Tensor:
    """`segment_sum(data, seg, n_seg)` for seg (P,) int32 and data (P, F)
    int64.  Rows whose segment lies outside [0, n_seg) are dropped.
    Returns (n_seg, F) int64."""
    if data.dtype != torch.int64:
        raise TypeError(f"segment_sums: int64 data only, got {data.dtype}")
    seg = seg.to(torch.int32)
    if data.device.type == "cpu":
        return segment_sums_plain(seg, data, n_seg)
    from cell_image_analysis_tpu_torch.ops.cuda.segsum import segment_sums_cuda

    return segment_sums_cuda(seg, data, n_seg)
