"""Stage A of screening: label maps -> QC'd, capacity-bounded cell crops.

Counterpart of `cell_image_analysis_tpu/ops/extract.py`
(`extract_candidates_from_labels_runs`, `_candidates_from_props`):
run-length regionprops -> geometric QC -> the first `cell_capacity`
passing labels in ascending order -> (crop_capacity)^2 crop gather ->
bbox-rectangle mean/std intensity QC -> survivors repacked to the front.
The static capacities and their truncation are kept exactly: they decide
which cells survive.  Batched over frames.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cell_image_analysis_tpu_torch.ops import gather_rows
from cell_image_analysis_tpu_torch.ops.regionprops import qc_mask
from cell_image_analysis_tpu_torch.ops.runs import regionprops_from_labels


class Candidates(NamedTuple):
    """All arrays have leading dims (B, cell_capacity)."""

    crops: torch.Tensor           # (B, C, cap, cap) raw green crops
    heights: torch.Tensor         # (B, C) int32
    widths: torch.Tensor
    valid: torch.Tensor           # (B, C) bool
    label_ids: torch.Tensor       # (B, C) int32
    area: torch.Tensor
    eccentricity: torch.Tensor
    mean_intensity: torch.Tensor
    std_intensity: torch.Tensor
    n_valid: torch.Tensor         # (B,) int32


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """`jnp.nonzero(mask_b, size=size, fill_value=fill)[0]` per row of a
    (B, N) mask: ascending indices of the True entries, truncated or padded
    to `size`."""
    B, N = mask.shape
    idx = torch.arange(N, device=mask.device).expand(B, N)
    keys = torch.where(mask, idx, N).sort(dim=1).values
    if size <= N:
        keys = keys[:, :size]
    else:
        keys = torch.cat([keys, torch.full((B, size - N), N, device=mask.device,
                                           dtype=keys.dtype)], dim=1)
    return torch.where(keys < N, keys, fill_value)


def _candidates_from_props(props, green: torch.Tensor, label_capacity: int,
                           cell_capacity: int, crop_capacity: int, border_margin: int,
                           min_area: int, max_area: int, max_eccentricity: float,
                           min_mean_intensity: float, min_std_intensity: float) -> Candidates:
    B, h, w = green.shape
    dev = green.device
    green = green.float()
    geo = qc_mask(props, h, w, border_margin=border_margin, min_area=min_area,
                  max_area=max_area, max_eccentricity=max_eccentricity)
    sel = nonzero_static(geo, cell_capacity, label_capacity)
    in_range = sel < label_capacity
    sel_c = torch.clamp(sel, max=label_capacity - 1)
    minr = gather_rows(props.min_r, sel_c)
    minc = gather_rows(props.min_c, sel_c)
    ch = gather_rows(props.max_r, sel_c) - minr
    cw = gather_rows(props.max_c, sel_c) - minc
    cand = in_range & (ch <= crop_capacity) & (cw <= crop_capacity)
    ch = torch.clamp(ch, 1, crop_capacity)
    cw = torch.clamp(cw, 1, crop_capacity)

    # crop gather from the zero-padded frame (dynamic_slice clamps starts)
    padded = torch.nn.functional.pad(green, (0, crop_capacity, 0, crop_capacity))
    ar = torch.arange(crop_capacity, device=dev)
    rows = torch.clamp(minr, 0, h).long()[..., None] + ar            # (B, C, cap)
    cols = torch.clamp(minc, 0, w).long()[..., None] + ar
    flat = rows[..., :, None] * (w + crop_capacity) + cols[..., None, :]
    crops = torch.gather(padded.reshape(B, 1, -1).expand(B, flat.shape[1], -1), 2,
                         flat.reshape(B, flat.shape[1], -1)).reshape(flat.shape)

    rect = (ar[:, None] < ch[..., None, None]) & (ar[None, :] < cw[..., None, None])
    area_rect = torch.clamp((ch * cw).float(), min=1.0)
    zero = torch.zeros((), device=dev)
    mean = torch.where(rect, crops, zero).sum(dim=(2, 3)) / area_rect
    centered = torch.where(rect, crops - mean[..., None, None], zero)
    std = torch.sqrt(torch.clamp((centered * centered).sum(dim=(2, 3)) / area_rect, min=0.0))
    valid = cand & (mean >= min_mean_intensity) & (std >= min_std_intensity)

    # repack the valid cells to the front (stable: ascending label order)
    order = nonzero_static(valid, cell_capacity, cell_capacity)
    ok = order < cell_capacity
    o = torch.clamp(order, max=cell_capacity - 1)
    zf = torch.zeros_like(mean)
    return Candidates(
        crops=gather_rows(crops, o),
        heights=torch.where(ok, gather_rows(ch, o), 1),
        widths=torch.where(ok, gather_rows(cw, o), 1),
        valid=ok,
        label_ids=torch.where(ok, gather_rows(sel_c, o) + 1, 0).int(),
        area=torch.where(ok, gather_rows(gather_rows(props.area, sel_c), o), 0),
        eccentricity=torch.where(ok, gather_rows(gather_rows(props.eccentricity, sel_c), o), zf),
        mean_intensity=torch.where(ok, gather_rows(mean, o), zf),
        std_intensity=torch.where(ok, gather_rows(std, o), zf),
        n_valid=valid.sum(dim=1).int(),
    )


def extract_candidates_from_labels_runs(
    labels: torch.Tensor, green: torch.Tensor, label_capacity: int = 1024,
    cell_capacity: int = 512, crop_capacity: int = 192, border_margin: int = 10,
    min_area: int = 200, max_area: int = 8000, max_eccentricity: float = 0.95,
    min_mean_intensity: float = 0.5, min_std_intensity: float = 0.1, rcap: int = 32,
):
    """Stage A from label maps (B, H, W) and raw green channels (B, H, W).
    Returns (Candidates, run-table overflow (B,))."""
    props, overflow = regionprops_from_labels(labels, capacity=label_capacity, rcap=rcap)
    cand = _candidates_from_props(
        props, green, label_capacity=label_capacity, cell_capacity=cell_capacity,
        crop_capacity=crop_capacity, border_margin=border_margin, min_area=min_area,
        max_area=max_area, max_eccentricity=max_eccentricity,
        min_mean_intensity=min_mean_intensity, min_std_intensity=min_std_intensity)
    return cand, overflow
