"""Connected-component labelling of boolean masks.

Counterpart of `cell_image_analysis_tpu/ops/cc.py` (`label_components`).
The raw labels — each foreground pixel's component minimum frame-local
linear index + 1, background 0 — come from `cc_min_labels`, which launches
`csrc/cc_min_labels.cu` (union-find, the port of the TPU kernel
`ops/pallas/cc_kernel.py:cc_min_labels_pallas`) for CUDA tensors and runs
the plain version, `cc_min_labels_plain` (the JAX sweep fixpoint), for CPU
tensors.  The compaction to 1..K in raster order of each component's
first pixel (scipy.ndimage.label numbering) is plain torch.  Batched over
frames: masks (B, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INF = torch.iinfo(torch.int32).max
_SWEEPS_PER_CHECK = 4  # sweeps between two convergence checks (JAX's default)


def _neighbor_min(lbl: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min positive label over each pixel and its neighbours (INF where
    none); lbl (B, H, W) int32."""
    h, w = lbl.shape[-2:]
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    masked = torch.where(lbl > 0, lbl, _INF)
    padded = F.pad(masked, (1, 1, 1, 1), value=_INF)
    best = masked
    for dr, dc in shifts:
        best = torch.minimum(best, padded[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w])
    return best


def cc_min_labels_plain(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """The plain version of `cc_min_labels`: min-label propagation sweeps
    to the fixpoint (JAX `ops/cc.py` `_neighbor_min` + `_sweep_fixpoint`),
    batched; the loop runs until no frame changes."""
    B, h, w = mask.shape
    m = mask.bool()
    idx = torch.arange(h * w, dtype=torch.int32, device=m.device).reshape(h, w)
    lbl = torch.where(m, idx + 1, 0)
    while True:
        new = lbl
        for _ in range(_SWEEPS_PER_CHECK):
            nm = _neighbor_min(new, connectivity)
            new = torch.where(m, torch.minimum(torch.where(new > 0, new, _INF), nm), 0)
            new = torch.where(new == _INF, 0, new)
        if torch.equal(new, lbl):
            return new
        lbl = new


def cc_min_labels(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 raw labels: each foreground
    pixel's component minimum frame-local linear index + 1, 0 on the
    background.  Connectivity 1 = 4-neighbourhood, 2 = 8-neighbourhood."""
    if connectivity not in (1, 2):
        raise ValueError(f"cc_min_labels: connectivity 1 or 2, got {connectivity}")
    if mask.device.type == "cpu":
        return cc_min_labels_plain(mask, connectivity)
    from cell_image_analysis_tpu_torch.ops.cuda.cc import cc_min_labels_cuda

    return cc_min_labels_cuda(mask, connectivity)


def label_components(mask: torch.Tensor, connectivity: int = 1):
    """Label the connected components of boolean masks (B, H, W).

    Returns (labels (B, H, W) int32, count (B,) int32): components numbered
    1..count in raster order of their first pixel, as scipy.ndimage.label."""
    B, h, w = mask.shape
    raw = cc_min_labels(mask, connectivity).reshape(B, -1)
    own = torch.arange(1, h * w + 1, dtype=torch.int32, device=raw.device)
    prefix = torch.cumsum(raw == own, dim=1).int()       # roots seen so far
    compact = torch.gather(prefix, 1, torch.clamp(raw - 1, min=0).long())
    labels = torch.where(raw > 0, compact, 0).reshape(B, h, w)
    return labels, prefix[:, -1]
