"""Launcher of `csrc/clahe_cells.cu` (see its header for the design)."""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)
MAX_NS_CAP = 16  # 16 x 16 tiles of 16-bit counts: 128 KB, within a block's 227 KB


def default_bands(n_cells: int, device) -> int:
    """Blocks (a cluster) a cell: 4 while the cells are fewer than the
    card's SMs, else 2.  `scripts/clahe_bands.py` times 1, 2 and 4 at
    bucket sizes on both sides of the switch; PERF.md holds its record."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 if n_cells < sms else 2


def clahe_cells_cuda(crops: torch.Tensor, ids: torch.Tensor, heights: torch.Tensor,
                     widths: torch.Tensor, cap: int, clip_limit: float = 0.02, grid: int = 8,
                     ns_cap: int = MAX_NS_CAP) -> torch.Tensor:
    """CLAHE of the cells `ids` (C,) int32 of the contiguous (N, full_cap,
    full_cap) float32 crop tensor, read in place, with heights and widths
    (N,) int32: (C, cap, cap) float32 in [0, 1], 0 outside [:h, :w] —
    `ops.clahe.clahe_cells_plain(crops[ids][:, :cap, :cap], heights[ids],
    widths[ids])` bit for bit.  A cell with a side above `cap` or more than
    `ns_cap` tiles a side comes out NaN."""
    global LAUNCHES
    if not (crops.is_cuda and all(t.device == crops.device for t in (ids, heights, widths))):
        raise ValueError("clahe_cells_cuda: every input must be on one CUDA device")
    if crops.dtype != torch.float32:
        raise TypeError(f"clahe_cells_cuda: float32 crops only, got {crops.dtype}")
    if any(t.dtype != torch.int32 for t in (ids, heights, widths)):
        raise TypeError("clahe_cells_cuda: int32 ids, heights and widths only")
    if crops.dim() != 3 or crops.shape[1] != crops.shape[2]:
        raise ValueError(f"clahe_cells_cuda: crops {tuple(crops.shape)} are not (N, cap, cap)")
    if not crops.is_contiguous():
        raise ValueError("clahe_cells_cuda: the kernel reads the crops in place: contiguous only")
    N, full_cap = crops.shape[:2]
    if ids.dim() != 1 or heights.shape != (N,) or widths.shape != (N,):
        raise ValueError("clahe_cells_cuda: ids (C,), heights and widths (N,) expected")
    if not 1 <= cap <= full_cap:
        raise ValueError(f"clahe_cells_cuda: cap {cap} outside [1, {full_cap}]")
    if not 1 <= ns_cap <= MAX_NS_CAP:
        raise ValueError(f"clahe_cells_cuda: ns_cap {ns_cap} outside [1, {MAX_NS_CAP}]")
    if grid < 1 or max(1, cap // grid) ** 2 * (2 ** 14 - 1) >= 2 ** 24:
        raise ValueError(f"clahe_cells_cuda: crop capacity {cap} too large for the exact blend")
    ids, heights, widths = ids.contiguous(), heights.contiguous(), widths.contiguous()
    C = ids.shape[0]
    out = torch.empty((C, cap, cap), dtype=torch.float32, device=crops.device)
    with torch.cuda.device(crops.device):
        err = library().cia_clahe_cells(
            crops.data_ptr(), full_cap, N, ids.data_ptr(), C, heights.data_ptr(),
            widths.data_ptr(), cap, ns_cap, clip_limit, grid, default_bands(C, crops.device),
            out.data_ptr(), stream_ptr(crops.device))
    check(err, "clahe_cells")
    LAUNCHES += 1
    return out
