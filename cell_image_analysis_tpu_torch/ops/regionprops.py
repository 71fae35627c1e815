"""Region properties of instance label maps, and the geometric QC gates.

Counterpart of `cell_image_analysis_tpu/ops/regionprops.py` (`RegionProps`,
`regionprops`, `qc_mask`).  `regionprops` is the pixel path: the
foreground pixels are compacted (in raster order, truncated to
`fg_fraction` of the frame exactly as JAX truncates them), the bbox is one
segment max, and the six bbox-anchored moments `[1, dr, dc, dr^2, dc^2,
dr*dc]` are summed in int64 through `ops.segsum.segment_sums` (the CUDA
segment-sum kernel on the GPU).  JAX sums them in float32; the port's sums
are exact, so area, bbox and `valid` agree bit for bit and centroid and
eccentricity to float32 rounding of JAX's sums.

`props_from_moments` turns the int64 moment sums and bbox maxima into
RegionProps; the run-length paths (`ops.runs`) share it.  Batched over
frames: label maps (B, H, W).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cell_image_analysis_tpu_torch.ops import nonzero_static
from cell_image_analysis_tpu_torch.ops.segsum import segment_sums

_I32_MIN = -(1 << 31)


class RegionProps(NamedTuple):
    """Arrays indexed (frame, label - 1); `valid` marks labels with area > 0."""

    area: torch.Tensor          # (B, K) int32
    min_r: torch.Tensor         # (B, K) int32
    min_c: torch.Tensor
    max_r: torch.Tensor         # exclusive
    max_c: torch.Tensor
    centroid_r: torch.Tensor    # (B, K) float32
    centroid_c: torch.Tensor
    eccentricity: torch.Tensor  # (B, K) float32
    valid: torch.Tensor         # (B, K) bool


def segment_bbox_max(flat_seg: torch.Tensor, feats: torch.Tensor, n_rows: int) -> torch.Tensor:
    """One segment max of (P, 4) int32 bbox features into (n_rows, 4);
    empty segments keep INT32_MIN, as JAX `segment_max`."""
    mx = torch.full((n_rows, 4), _I32_MIN, dtype=torch.int32, device=feats.device)
    return mx.scatter_reduce_(0, flat_seg.long()[:, None].expand(-1, 4), feats.int(),
                              reduce="amax")


def bbox_anchors(mx: torch.Tensor, h: int, w: int):
    """Per-segment anchors (B, capacity + 1) from bbox maxima (B, capacity,
    4) = [max_r, max_c, -min_r, -min_c]; the dump segment anchors at 0."""
    zero = torch.zeros((mx.shape[0], 1), dtype=torch.int32, device=mx.device)
    anchor_r = torch.cat([torch.clamp(-mx[..., 2], 0, h - 1), zero], dim=1)
    anchor_c = torch.cat([torch.clamp(-mx[..., 3], 0, w - 1), zero], dim=1)
    return anchor_r, anchor_c


def props_from_moments(sums: torch.Tensor, mx: torch.Tensor, h: int, w: int) -> RegionProps:
    """RegionProps from int64 moment sums (B, K, 6) = [1, dr, dc, dr^2,
    dc^2, dr*dc] anchored at the bbox minimum, and bbox maxima (B, K, 4) =
    [max_r, max_c, -min_r, -min_c] (JAX `ops/regionprops.py:205-237`)."""
    sums = sums.float()
    mxr, mxc = mx[..., 0], mx[..., 1]
    mnr_raw, mnc_raw = -mx[..., 2], -mx[..., 3]
    area = sums[..., 0].int()
    valid = area > 0
    areaf = torch.clamp(sums[..., 0], min=1.0)
    er = sums[..., 1] / areaf
    ec = sums[..., 2] / areaf
    cy = torch.clamp(mnr_raw, 0, h - 1).float() + er
    cx = torch.clamp(mnc_raw, 0, w - 1).float() + ec
    mu20 = sums[..., 3] / areaf - er * er
    mu02 = sums[..., 4] / areaf - ec * ec
    mu11 = sums[..., 5] / areaf - er * ec
    t = (mu20 + mu02) / 2.0
    dd = torch.sqrt(((mu20 - mu02) / 2.0) ** 2 + mu11 ** 2)
    l1, l2 = t + dd, t - dd
    ecc = torch.where(l1 > 0, torch.sqrt(torch.clamp(
        1.0 - l2 / torch.clamp(l1, min=1e-20), 0.0, 1.0)), 0.0)
    zf = torch.zeros_like(cy)
    return RegionProps(
        area=area,
        min_r=torch.where(valid, mnr_raw, 0),
        min_c=torch.where(valid, mnc_raw, 0),
        max_r=torch.where(valid, mxr + 1, 0),
        max_c=torch.where(valid, mxc + 1, 0),
        centroid_r=torch.where(valid, cy, zf),
        centroid_c=torch.where(valid, cx, zf),
        eccentricity=torch.where(valid, ecc, zf),
        valid=valid,
    )


def regionprops(labels: torch.Tensor, capacity: int, fg_fraction: float = 0.25) -> RegionProps:
    """Properties of labels 1..capacity of int32 label maps (B, H, W).

    Only the first `max(int(H*W*fg_fraction), 1024)` foreground pixels of a
    frame (raster order) are counted, as in JAX; labels above `capacity`
    are dropped."""
    B, h, w = labels.shape
    dev = labels.device
    fg_cap = max(int(h * w * fg_fraction), 1024)
    fgidx = nonzero_static(labels.reshape(B, -1) > 0, fg_cap, h * w)   # raster order
    in_fg = fgidx < h * w
    fgi = torch.clamp(fgidx, max=h * w - 1)
    lab = torch.where(in_fg, torch.gather(labels.reshape(B, -1).int(), 1, fgi), 0)
    seg = torch.where(lab > 0, lab - 1, capacity)
    seg = torch.clamp(seg, max=capacity)                   # (B, fg_cap), capacity = dump
    rr, cc = (fgi // w).int(), (fgi % w).int()

    n_seg = capacity + 1
    flat_seg = seg.long() + n_seg * torch.arange(B, device=dev)[:, None]
    feats = torch.stack([rr, cc, -rr, -cc], dim=-1).reshape(-1, 4)
    mx = segment_bbox_max(flat_seg.reshape(-1), feats, B * n_seg)
    mx = mx.reshape(B, n_seg, 4)[:, :capacity]

    anchor_r, anchor_c = bbox_anchors(mx, h, w)
    dr = (rr - torch.gather(anchor_r, 1, seg.long())).long()
    dc = (cc - torch.gather(anchor_c, 1, seg.long())).long()
    data = torch.stack([torch.ones_like(dr), dr, dc, dr * dr, dc * dc, dr * dc], dim=-1)
    # the dump segment is never read: route its pixels out of the sum
    ids = torch.where(seg < capacity, flat_seg, -1).int().reshape(-1)
    sums = segment_sums(ids, data.reshape(-1, 6), B * n_seg)
    return props_from_moments(sums.reshape(B, n_seg, 6)[:, :capacity], mx, h, w)


def qc_mask(props: RegionProps, height: int, width: int, border_margin: int = 10,
            min_area: int = 200, max_area: int = 8000,
            max_eccentricity: float = 0.95) -> torch.Tensor:
    """Border margin, area window and eccentricity ceiling
    (CAE_improved_modeltrain.py:68-77 of the reference)."""
    border_ok = ((props.min_r >= border_margin) & (props.min_c >= border_margin)
                 & (props.max_r <= height - border_margin)
                 & (props.max_c <= width - border_margin))
    area_ok = (props.area >= min_area) & (props.area <= max_area)
    ecc_ok = props.eccentricity <= max_eccentricity
    return props.valid & border_ok & area_ok & ecc_ok
