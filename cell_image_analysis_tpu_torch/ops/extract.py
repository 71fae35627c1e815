"""Stage A of screening: segmentations -> QC'd, capacity-bounded cell crops.

Counterpart of `cell_image_analysis_tpu/ops/extract.py`: regionprops ->
geometric QC -> the first `cell_capacity` passing labels in ascending
order -> (crop_capacity)^2 crop gather -> bbox-rectangle mean/std
intensity QC -> survivors repacked to the front (`_candidates_from_props`).
The regionprops come from one of three routes:

- `extract_candidates`: label maps through the pixel regionprops (the
  exact route of both overflow fallbacks);
- `extract_candidates_from_labels_runs`: label maps through the run-length
  regionprops (the StarDist backend's fast route);
- `extract_candidates_from_mask`: boolean masks through the run-length
  connected components (the threshold backend's fast route).

The static capacities and their truncation are kept exactly: they decide
which cells survive.  Batched over frames.

`extract_cells_chunked` is the host-facing form for one frame: stage A
through the pixel regionprops, then CLAHE and resize by size bucket; it
returns the preprocessed cells as numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cell_image_analysis_tpu_torch.ops import gather_rows, nonzero_static
from cell_image_analysis_tpu_torch.ops.regionprops import qc_mask, regionprops
from cell_image_analysis_tpu_torch.ops.runs import regionprops_from_labels, regionprops_from_mask


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


def extract_candidates(
    labels: torch.Tensor, green: torch.Tensor, label_capacity: int = 1024,
    cell_capacity: int = 512, crop_capacity: int = 192, border_margin: int = 10,
    min_area: int = 200, max_area: int = 8000, max_eccentricity: float = 0.95,
    min_mean_intensity: float = 0.5, min_std_intensity: float = 0.1,
    fg_fraction: float = 0.25,
) -> Candidates:
    """Stage A from label maps (B, H, W) through the pixel regionprops."""
    props = regionprops(labels, capacity=label_capacity, fg_fraction=fg_fraction)
    return _candidates_from_props(
        props, green, label_capacity=label_capacity, cell_capacity=cell_capacity,
        crop_capacity=crop_capacity, border_margin=border_margin, min_area=min_area,
        max_area=max_area, max_eccentricity=max_eccentricity,
        min_mean_intensity=min_mean_intensity, min_std_intensity=min_std_intensity)


def extract_candidates_from_mask(
    mask: torch.Tensor, green: torch.Tensor, label_capacity: int = 1024,
    cell_capacity: int = 512, crop_capacity: int = 192, border_margin: int = 10,
    min_area: int = 200, max_area: int = 8000, max_eccentricity: float = 0.95,
    min_mean_intensity: float = 0.5, min_std_intensity: float = 0.1, rcap: int = 32,
    connectivity: int = 1,
):
    """Stage A from boolean masks (B, H, W) through the run-length
    connected components.  Returns (Candidates, run-table overflow (B,));
    where the flag is set the caller re-runs the exact label route."""
    props, overflow = regionprops_from_mask(mask, capacity=label_capacity, rcap=rcap,
                                            connectivity=connectivity)
    cand = _candidates_from_props(
        props, green, label_capacity=label_capacity, cell_capacity=cell_capacity,
        crop_capacity=crop_capacity, border_margin=border_margin, min_area=min_area,
        max_area=max_area, max_eccentricity=max_eccentricity,
        min_mean_intensity=min_mean_intensity, min_std_intensity=min_std_intensity)
    return cand, overflow


@torch.inference_mode()
def extract_cells_chunked(labels: torch.Tensor, green: torch.Tensor, chunk: int = 128,
                          caps: tuple = (64, 96), out_size: int = 64,
                          clip_limit: float = 0.02, **candidate_kwargs):
    """One frame's label map (H, W) and raw green channel (H, W) -> (cells
    (n, out, out) float32 numpy in ascending label order, stats dict of
    numpy arrays): stage A once, then CLAHE (once a size bucket) and the
    resize in chunks.  The buckets are `ops.clahe.size_buckets`';
    the capacity only pads the layout, so the cells do not depend on them."""
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, size_buckets
    from cell_image_analysis_tpu_torch.ops.resize import resize_cells

    cand = extract_candidates(labels[None], green[None], **candidate_kwargs)
    n = int(cand.n_valid[0])
    stats = {k: getattr(cand, k)[0, :n].cpu().numpy()
             for k in ("label_ids", "area", "eccentricity", "mean_intensity", "std_intensity")}
    cells = torch.zeros((n, out_size, out_size), dtype=torch.float32, device=green.device)
    if n == 0:
        return cells.cpu().numpy(), stats
    crops = cand.crops[0].float().contiguous()
    heights, widths = cand.heights[0].int(), cand.widths[0].int()
    for idx, cap_b, ns_cap in size_buckets(heights, widths, cand.valid[0], caps,
                                           crops.shape[-1]):
        if idx.numel() == 0:
            continue
        eq_all = clahe_bucket(crops, idx.int(), heights, widths, cap_b, clip_limit=clip_limit,
                              ns_cap=ns_cap)
        for start in range(0, idx.numel(), chunk):
            ids = idx[start:start + chunk]
            cells[ids] = resize_cells(eq_all[start:start + chunk], heights[ids], widths[ids],
                                      out_size=out_size)
    return cells.cpu().numpy(), stats
