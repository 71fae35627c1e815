"""Connected-component labelling of boolean masks.

Counterpart of `cell_image_analysis_tpu/ops/cc.py` (`label_components`).
For CUDA tensors `label_components` launches `csrc/cc_tile_labels.cu`
(tile-local union-find, the port of the TPU kernel
`ops/pallas/cc_kernel.py:cc_min_labels_pallas` together with the
compaction that JAX runs after it), which writes the final labels.  For
CPU tensors it runs the plain version, `label_components_plain`: the raw
labels of `cc_min_labels_plain` (the JAX sweep fixpoint: each foreground
pixel's component minimum frame-local linear index + 1, background 0),
compacted to 1..K in raster order of each component's first pixel
(scipy.ndimage.label numbering).  Batched over frames: masks (B, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INF = torch.iinfo(torch.int32).max
_SWEEPS_PER_CHECK = 4  # sweeps between two convergence checks (JAX's default)


def _check_connectivity(connectivity: int) -> None:
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity 1 or 2, got {connectivity}")


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
    """(B, H, W) bool -> (B, H, W) int32 raw labels: each foreground
    pixel's component minimum frame-local linear index + 1, 0 on the
    background; min-label propagation sweeps to the fixpoint (JAX
    `ops/cc.py` `_neighbor_min` + `_sweep_fixpoint`), batched; the loop
    runs until no frame changes.  Connectivity 1 = 4-neighbourhood, 2 =
    8-neighbourhood."""
    _check_connectivity(connectivity)
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


def compact_labels(raw: torch.Tensor):
    """Raw min-index labels (B, H, W) -> (labels 1..K in raster order of
    each component's first pixel, count (B,) int32)."""
    B, h, w = raw.shape
    raw = raw.reshape(B, -1)
    own = torch.arange(1, h * w + 1, dtype=torch.int32, device=raw.device)
    prefix = torch.cumsum(raw == own, dim=1).int()       # roots seen so far
    compact = torch.gather(prefix, 1, torch.clamp(raw - 1, min=0).long())
    return torch.where(raw > 0, compact, 0).reshape(B, h, w), prefix[:, -1]


def label_components_plain(mask: torch.Tensor, connectivity: int = 1):
    """The plain version of the CC kernel: `cc_min_labels_plain`, then
    `compact_labels`."""
    return compact_labels(cc_min_labels_plain(mask, connectivity))


def label_components(mask: torch.Tensor, connectivity: int = 1):
    """Label the connected components of boolean masks (B, H, W).

    Returns (labels (B, H, W) int32, count (B,) int32): components numbered
    1..count in raster order of their first pixel, as scipy.ndimage.label."""
    _check_connectivity(connectivity)
    if mask.device.type == "cpu":
        return label_components_plain(mask, connectivity)
    from cell_image_analysis_tpu_torch.ops.cuda.cc import label_components_cuda

    return label_components_cuda(mask, connectivity)
