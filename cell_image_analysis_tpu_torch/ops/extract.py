"""Stage A of screening: segmentations -> QC'd, capacity-bounded cell crops.

Counterpart of `cell_image_analysis_tpu/ops/extract.py`: regionprops ->
geometric QC -> the first `cell_capacity` passing labels in ascending
order -> (crop_capacity)^2 crop gather -> bbox-rectangle mean/std
intensity QC -> survivors repacked to the front (`_candidates_from_props`).
Every segmentation backend returns label maps, and their regionprops come
from one of two routes:

- `extract_candidates_from_labels_runs`: the run-length regionprops (every
  backend's main route; a row with more than `rcap` runs sets the
  overflow flag);
- `extract_candidates`: the pixel regionprops (the exact twins' route,
  which every overflow re-runs).

The static capacities and their truncation are kept exactly: they decide
which cells survive.  Batched over frames.

`stage_a` picks the route by the segment_fn's `runs_props` flag
(`stage_a_reasons` also says which capacity fired, `OVERFLOW_REASONS`);
neither holds the label maps through the crop gather, which sets the
peak of device memory, unless they are returned; `preprocess_buckets`
is stage B, CLAHE once a size bucket (`clahe_buckets`, whose buckets the
screening path, `pipeline.scoring`, resizes and scores itself) and the
resize in chunks, which the host-facing forms share:

- `extract_cells_chunked`: one frame's label map through the pixel
  regionprops, then stage B; the preprocessed cells come back as numpy;
- `extract_cells`: the same, in JAX's single-frame layout
  (`ExtractedCells`: slot i holds the i-th geometry-passing label, valid
  or not, on the device);
- `extract_cells_frames`: a batch of frames through a segment_fn and stage
  A, re-run through `fallback_segment_fn` (the exact twin) when a capacity
  flag fires, then stage B over the pooled cells of all frames; the cells
  come back as numpy, with the label maps as uint16 on request (the
  training's solidity).
"""

from __future__ import annotations

from typing import NamedTuple

import warnings

import numpy as np
import torch

from cell_image_analysis_tpu_torch.ops import gather_rows, nonzero_static
from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, size_buckets
from cell_image_analysis_tpu_torch.ops.regionprops import qc_mask, regionprops
from cell_image_analysis_tpu_torch.ops.resize import resize_cells
from cell_image_analysis_tpu_torch.ops.runs import regionprops_from_labels
from cell_image_analysis_tpu_torch.utils.profiler import count, span

# the overflow reasons of a frame, bit i for OVERFLOW_REASONS[i]: the
# StarDist backend's candidate cap K, NMS pair budget and raster tile cap,
# stage A's run table (`rcap`), and a segment_fn's flag that names no
# capacity (one without `overflow_reasons`)
OVERFLOW_REASONS = ("candidates", "nms_pairs", "raster", "stage_a", "segmentation")


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
    n_geometry: torch.Tensor      # (B,) int32 geometry-passing labels; at or above
                                  # cell_capacity the selection kept the first C


def gather_crops(green: torch.Tensor, minr: torch.Tensor, minc: torch.Tensor, ch: torch.Tensor,
                 cw: torch.Tensor, crop_capacity: int):
    """(crops (B, C, cap, cap), mean (B, C), std (B, C)): the crops of the
    float32 frames green (B, H, W) at the bbox corners (minr, minc) (B, C),
    read from the zero-padded frame (JAX's `dynamic_slice`, whose starts
    clamp), and the intensity mean and standard deviation over each
    crop's [:ch, :cw] rectangle."""
    B, h, w = green.shape
    padded = torch.nn.functional.pad(green, (0, crop_capacity, 0, crop_capacity))
    ar = torch.arange(crop_capacity, device=green.device)
    rows = torch.clamp(minr, 0, h).long()[..., None] + ar            # (B, C, cap)
    cols = torch.clamp(minc, 0, w).long()[..., None] + ar
    flat = rows[..., :, None] * (w + crop_capacity) + cols[..., None, :]
    crops = torch.gather(padded.reshape(B, 1, -1).expand(B, flat.shape[1], -1), 2,
                         flat.reshape(B, flat.shape[1], -1)).reshape(flat.shape)

    rect = (ar[:, None] < ch[..., None, None]) & (ar[None, :] < cw[..., None, None])
    area_rect = torch.clamp((ch * cw).float(), min=1.0)
    zero = torch.zeros((), device=green.device)
    mean = torch.where(rect, crops, zero).sum(dim=(2, 3)) / area_rect
    centered = torch.where(rect, crops - mean[..., None, None], zero)
    std = torch.sqrt(torch.clamp((centered * centered).sum(dim=(2, 3)) / area_rect, min=0.0))
    return crops, mean, std


class _Selected(NamedTuple):
    """The first `cell_capacity` geometry-passing labels of each frame in
    ascending order, before the repacking; all (B, C) but crops."""

    sel: torch.Tensor       # label index - 1, clamped into [0, label_capacity)
    cand: torch.Tensor      # a label there whose bbox fits the crop capacity
    valid: torch.Tensor     # cand and the intensity gates
    ch: torch.Tensor        # bbox sides, clamped into [1, crop_capacity]
    cw: torch.Tensor
    crops: torch.Tensor     # (B, C, cap, cap)
    mean: torch.Tensor
    std: torch.Tensor
    n_geometry: torch.Tensor  # (B,) geometry-passing labels before the selection


def _select(props, green: torch.Tensor, label_capacity: int, cell_capacity: int,
            crop_capacity: int, border_margin: int, min_area: int, max_area: int,
            max_eccentricity: float, min_mean_intensity: float,
            min_std_intensity: float) -> _Selected:
    """Geometric QC, the capacity-bounded selection, the crop gather and
    the intensity QC of float32 frames green (B, H, W)."""
    B, h, w = green.shape
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

    crops, mean, std = gather_crops(green, minr, minc, ch, cw, crop_capacity)
    valid = cand & (mean >= min_mean_intensity) & (std >= min_std_intensity)
    return _Selected(sel=sel_c, cand=cand, valid=valid, ch=ch, cw=cw, crops=crops, mean=mean,
                     std=std, n_geometry=geo.sum(dim=1).int())


def _candidates_from_props(props, green: torch.Tensor, label_capacity: int = 1024,
                           cell_capacity: int = 512, crop_capacity: int = 192,
                           border_margin: int = 10, min_area: int = 200, max_area: int = 8000,
                           max_eccentricity: float = 0.95, min_mean_intensity: float = 0.5,
                           min_std_intensity: float = 0.1) -> Candidates:
    s = _select(props, green.float(), label_capacity=label_capacity,
                cell_capacity=cell_capacity, crop_capacity=crop_capacity,
                border_margin=border_margin, min_area=min_area, max_area=max_area,
                max_eccentricity=max_eccentricity, min_mean_intensity=min_mean_intensity,
                min_std_intensity=min_std_intensity)
    # repack the valid cells to the front (stable: ascending label order)
    order = nonzero_static(s.valid, cell_capacity, cell_capacity)
    ok = order < cell_capacity
    o = torch.clamp(order, max=cell_capacity - 1)
    zf = torch.zeros_like(s.mean)
    return Candidates(
        crops=gather_rows(s.crops, o),
        heights=torch.where(ok, gather_rows(s.ch, o), 1),
        widths=torch.where(ok, gather_rows(s.cw, o), 1),
        valid=ok,
        label_ids=torch.where(ok, gather_rows(s.sel, o) + 1, 0).int(),
        area=torch.where(ok, gather_rows(gather_rows(props.area, s.sel), o), 0),
        eccentricity=torch.where(ok, gather_rows(gather_rows(props.eccentricity, s.sel), o), zf),
        mean_intensity=torch.where(ok, gather_rows(s.mean, o), zf),
        std_intensity=torch.where(ok, gather_rows(s.std, o), zf),
        n_valid=s.valid.sum(dim=1).int(),
        n_geometry=s.n_geometry,
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


def stage_a(segment_fn, segs: torch.Tensor, greens: torch.Tensor, candidate_kwargs: dict,
            return_labels: bool = False):
    """Segmentation and stage-A candidates of a batch: the segment_fn's
    label maps through the run-length regionprops where it has
    `runs_props`, else through the pixel regionprops.  Returns
    (Candidates, overflow (B,), the label maps with `return_labels`, else
    None)."""
    cand, reasons, labels = stage_a_reasons(segment_fn, segs, greens, candidate_kwargs,
                                            return_labels)
    return cand, reasons != 0, labels


def stage_a_reasons(segment_fn, segs: torch.Tensor, greens: torch.Tensor,
                    candidate_kwargs: dict, return_labels: bool = False):
    """`stage_a` with each frame's overflow reasons in place of its flag:
    (Candidates, reasons (B,) int32, bit i set where OVERFLOW_REASONS[i]
    fired, the label maps with `return_labels`, else None).  A segment_fn
    with `returns_overflow` gives its reasons through
    `overflow_reasons(segs)` where it has one."""
    kw = dict(candidate_kwargs)
    reasons = None
    if getattr(segment_fn, "returns_overflow", False):
        if hasattr(segment_fn, "overflow_reasons"):
            labels, reasons = segment_fn.overflow_reasons(segs)
        else:
            labels, seg_ovf = segment_fn(segs)
            reasons = seg_ovf.int() << OVERFLOW_REASONS.index("segmentation")
    else:
        labels = segment_fn(segs)
    with span("extract.stage_a"):
        capacity = kw.get("label_capacity", 1024)
        if getattr(segment_fn, "runs_props", False):
            kw.pop("fg_fraction", None)
            props, ovf = regionprops_from_labels(labels, capacity=capacity,
                                                 rcap=kw.pop("rcap", 32))
        else:
            kw.pop("rcap", None)
            props = regionprops(labels, capacity=capacity,
                                fg_fraction=kw.pop("fg_fraction", 0.25))
            ovf = torch.zeros(segs.shape[0], dtype=torch.bool, device=segs.device)
        if not return_labels:
            labels = None   # 4 bytes a pixel, not to be held through the crop gather
        cand = _candidates_from_props(props, greens, **kw)
        code = ovf.int() << OVERFLOW_REASONS.index("stage_a")
        if reasons is not None:
            code = code | reasons.int()
    return cand, code, labels


def preprocess_buckets(crops: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor,
                       heights_h: torch.Tensor, widths_h: torch.Tensor, valid_h: torch.Tensor,
                       caps: tuple = (64, 96), chunk: int = 128, out_size: int = 64,
                       clip_limit: float = 0.02):
    """Stage B of the (N, cap, cap) crop slots with heights and widths (N,)
    on the device: CLAHE once a size bucket (`ops.clahe.size_buckets`,
    from the host copies `heights_h`, `widths_h`, `valid_h`: no wait on
    the device), then the resize in chunks.  Yields (slot ids (n,) on the
    device, cells (n, out_size, out_size)); the buckets only pad the
    layout, so the cells do not depend on them.  Each bucket is an
    `extract.bucket` span (its cap the argument), open while the caller
    takes its chunks."""
    for idx, _, eq_all in clahe_buckets(crops, heights, widths, heights_h, widths_h, valid_h,
                                        caps=caps, clip_limit=clip_limit):
        for start in range(0, idx.numel(), chunk):
            count("chunks")
            ids = idx[start:start + chunk]
            with span("resize.chunk"):
                cells = resize_cells(eq_all[start:start + chunk], heights[ids], widths[ids],
                                     out_size=out_size)
            yield ids, cells


def clahe_buckets(crops: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor,
                  heights_h: torch.Tensor, widths_h: torch.Tensor, valid_h: torch.Tensor,
                  caps: tuple = (64, 96), clip_limit: float = 0.02):
    """The CLAHE half of `preprocess_buckets`: yields (slot ids (n,) on the
    device, the bucket's cap, its CLAHE'd crops (n, cap, cap)) a non-empty
    size bucket, inside the bucket's `extract.bucket` span."""
    for idx, cap_b, ns_cap in size_buckets(heights_h, widths_h, valid_h, caps, crops.shape[-1]):
        if idx.numel() == 0:
            continue
        count(f"cells.bucket_{cap_b}", idx.numel())
        with span("extract.bucket", arg=cap_b):
            idx = idx.to(crops.device, non_blocking=True)
            with span("clahe.bucket"):
                eq_all = clahe_bucket(crops, idx.int(), heights, widths, cap_b,
                                      clip_limit=clip_limit, ns_cap=ns_cap)
            yield idx, cap_b, eq_all


@torch.inference_mode()
def extract_cells_chunked(labels: torch.Tensor, green: torch.Tensor, chunk: int = 128,
                          caps: tuple = (64, 96), out_size: int = 64,
                          clip_limit: float = 0.02, **candidate_kwargs):
    """One frame's label map (H, W) and raw green channel (H, W) -> (cells
    (n, out, out) float32 numpy in ascending label order, stats dict of
    numpy arrays): stage A once, then stage B (`preprocess_buckets`)."""
    cand = extract_candidates(labels[None], green[None], **candidate_kwargs)
    n = int(cand.n_valid[0])
    stats = {k: getattr(cand, k)[0, :n].cpu().numpy()
             for k in ("label_ids", "area", "eccentricity", "mean_intensity", "std_intensity")}
    cells = torch.zeros((n, out_size, out_size), dtype=torch.float32, device=green.device)
    if n == 0:
        return cells.cpu().numpy(), stats
    heights, widths = cand.heights[0].int(), cand.widths[0].int()
    for ids, c in preprocess_buckets(cand.crops[0].float().contiguous(), heights, widths,
                                     heights, widths, cand.valid[0], caps=caps, chunk=chunk,
                                     out_size=out_size, clip_limit=clip_limit):
        cells[ids] = c
    return cells.cpu().numpy(), stats


class ExtractedCells(NamedTuple):
    """`extract_cells`' slots: the i-th geometry-passing label in slot i;
    all (C,) but cells, zero in a slot that is not valid."""

    cells: torch.Tensor           # (C, out, out) float32 in [0, 1]
    valid: torch.Tensor           # (C,) bool: passed geometry and intensity QC
    label_ids: torch.Tensor       # (C,) int32 label (1-based); 0 if not valid
    area: torch.Tensor            # (C,) int32
    eccentricity: torch.Tensor    # (C,) float32
    mean_intensity: torch.Tensor  # (C,) float32: raw bbox-crop mean
    std_intensity: torch.Tensor   # (C,) float32: raw bbox-crop std (ddof 0)
    n_candidates: torch.Tensor    # () int32: geometry-passing labels that fit the crop


@torch.inference_mode()
def extract_cells(labels: torch.Tensor, green: torch.Tensor, label_capacity: int = 1024,
                  cell_capacity: int = 512, crop_capacity: int = 192, out_size: int = 64,
                  border_margin: int = 10, min_area: int = 200, max_area: int = 8000,
                  max_eccentricity: float = 0.95, min_mean_intensity: float = 0.5,
                  min_std_intensity: float = 0.1, fg_fraction: float = 0.25) -> ExtractedCells:
    """One frame's label map (H, W) and raw green channel (H, W) -> its
    cells in JAX's single-frame layout (`ExtractedCells`), on their
    device: the pixel regionprops, stage A's selection (not repacked) and
    stage B (`preprocess_buckets`) over the valid slots."""
    props = regionprops(labels[None], capacity=label_capacity, fg_fraction=fg_fraction)
    s = _select(props, green[None].float(), label_capacity=label_capacity,
                cell_capacity=cell_capacity, crop_capacity=crop_capacity,
                border_margin=border_margin, min_area=min_area, max_area=max_area,
                max_eccentricity=max_eccentricity, min_mean_intensity=min_mean_intensity,
                min_std_intensity=min_std_intensity)
    valid, sel = s.valid[0], s.sel[0]
    heights, widths = s.ch[0].int(), s.cw[0].int()
    cells = torch.zeros((cell_capacity, out_size, out_size), dtype=torch.float32,
                        device=green.device)
    for ids, c in preprocess_buckets(s.crops[0].contiguous(), heights, widths, heights.cpu(),
                                     widths.cpu(), valid.cpu(), out_size=out_size):
        cells[ids] = c
    zf = torch.zeros_like(s.mean[0])
    return ExtractedCells(
        cells=cells, valid=valid,
        label_ids=torch.where(valid, sel + 1, 0).int(),
        area=torch.where(valid, props.area[0][sel], 0),
        eccentricity=torch.where(valid, props.eccentricity[0][sel], zf),
        mean_intensity=torch.where(valid, s.mean[0], zf),
        std_intensity=torch.where(valid, s.std[0], zf),
        n_candidates=s.cand[0].sum().int())


@torch.inference_mode()
def extract_cells_frames(segs: torch.Tensor, greens: torch.Tensor, segment_fn,
                         fallback_segment_fn=None, chunk: int = 128, caps: tuple = (64, 96),
                         out_size: int = 64, clip_limit: float = 0.02,
                         return_labels: bool = False, **candidate_kwargs):
    """Batched extraction of (B, H, W) same-shape frames: `stage_a` through
    `segment_fn` once for the batch (the whole batch re-runs through
    `fallback_segment_fn` when a capacity flag fires in any frame; without
    one the port warns), the candidates pooled across frames, then stage B
    over the pool.  Returns (cells (n, out, out) float32 numpy in
    frame-major, label-ascending order, stats dict of numpy arrays with
    `frame_index`); with `return_labels` also the (B, H, W) uint16 label
    maps as numpy."""
    cand, ovf, labels = stage_a(segment_fn, segs, greens, candidate_kwargs, return_labels)
    if bool(ovf.any()):
        if fallback_segment_fn is not None:
            return extract_cells_frames(segs, greens, fallback_segment_fn, chunk=chunk, caps=caps,
                                        out_size=out_size, clip_limit=clip_limit,
                                        return_labels=return_labels, **candidate_kwargs)
        warnings.warn(
            "extract_cells_frames: capacity overflow with no fallback_segment_fn — "
            "candidate extraction may have dropped or corrupted cells",
            RuntimeWarning, stacklevel=2)
    B, ccap, full_cap = cand.crops.shape[:3]
    flat = {k: getattr(cand, k).reshape(-1) for k in (
        "heights", "widths", "valid", "label_ids", "area", "eccentricity", "mean_intensity",
        "std_intensity")}
    host = {k: v.cpu() for k, v in flat.items()}
    pool = torch.nonzero(host["valid"]).flatten()       # frame-major, label-ascending
    stats = {k: host[k][pool].numpy() for k in (
        "label_ids", "area", "eccentricity", "mean_intensity", "std_intensity")}
    stats["frame_index"] = (pool // ccap).numpy()
    labels16 = None
    if return_labels:
        labels16 = labels.int().cpu().numpy().astype(np.uint16)
    crops = cand.crops.reshape(B * ccap, full_cap, full_cap).float().contiguous()
    slots = torch.zeros((B * ccap, out_size, out_size), dtype=torch.float32, device=segs.device)
    for ids, c in preprocess_buckets(crops, flat["heights"].int(), flat["widths"].int(),
                                     host["heights"], host["widths"], host["valid"], caps=caps,
                                     chunk=chunk, out_size=out_size, clip_limit=clip_limit):
        slots[ids] = c
    cells = slots[pool.to(segs.device)].cpu().numpy()
    return (cells, stats, labels16) if return_labels else (cells, stats)
