"""Run-length regionprops of instance label maps.

Counterpart of `cell_image_analysis_tpu/ops/runs.py`
(`regionprops_from_labels`, `_run_moments`): each row's runs of constant
positive label go into a static `(H, rcap)` table (the `rcap` leftmost
runs; more set the overflow flag), and area, bbox, centroid and
eccentricity follow from closed-form per-run moments reduced per label.

The six moments are integers, so the port computes them in int64 and
reduces them with `ops.segsum.segment_sums` (the CUDA segment-sum kernel on
the GPU): exact in any summation order.  The bbox maxima are a plain
`scatter_reduce`.  Batched over frames: label maps (B, H, W).
"""

from __future__ import annotations

import torch

from cell_image_analysis_tpu_torch.ops.regionprops import RegionProps
from cell_image_analysis_tpu_torch.ops.segsum import segment_sums

_INF = 1 << 30
_I32_MIN = -(1 << 31)


def _moment_rows(seg, r, sf, ef, vf, capacity: int, h: int, w: int):
    """Per-slot bbox maxima and int64 run moments.  All inputs are (B, S)
    over run slots; `seg` holds the 0-based label index per slot
    (capacity = dump).  Returns (flat segment ids (B*S,) int32 over
    B*(capacity+1) segments, moments (B*S, 6) int64, bbox maxima
    (B, capacity, 4))."""
    B = seg.shape[0]
    n_seg = capacity + 1
    dev = seg.device
    flat_seg = (seg.long() + n_seg * torch.arange(B, device=dev)[:, None]).reshape(-1)

    # bbox: one 4-wide segment max (empty segments keep INT32_MIN, as JAX)
    feats = torch.stack([r, ef - 1, -r, -torch.where(vf, sf, _INF)], dim=-1).reshape(-1, 4)
    mx = torch.full((B * n_seg, 4), _I32_MIN, dtype=torch.int32, device=dev)
    mx.scatter_reduce_(0, flat_seg[:, None].expand(-1, 4), feats.int(), reduce="amax")
    mx = mx.reshape(B, n_seg, 4)[:, :capacity]

    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    anchor_r = torch.cat([torch.clamp(-mx[..., 2], 0, h - 1), zero], dim=1)
    anchor_c = torch.cat([torch.clamp(-mx[..., 3], 0, w - 1), zero], dim=1)
    ln = torch.where(vf, ef - sf, 0).long()
    dr = (r - torch.gather(anchor_r, 1, seg.long())).long()
    c0 = (sf - torch.gather(anchor_c, 1, seg.long())).long()
    # sums over the run's columns c0 .. c0 + ln - 1 (arithmetic series)
    tri = ln * (ln - 1) // 2
    sum_dc = ln * c0 + tri
    sum_dc2 = ln * c0 * c0 + 2 * c0 * tri + (ln - 1) * ln * (2 * ln - 1) // 6
    data = torch.stack([ln, dr * ln, sum_dc, dr * dr * ln, sum_dc2, dr * sum_dc], dim=-1)
    return flat_seg.int(), data.reshape(-1, 6), mx


def _run_moments(seg, r, sf, ef, vf, capacity: int, h: int, w: int) -> RegionProps:
    """Per-run moments -> per-label props (see `_moment_rows`)."""
    B = seg.shape[0]
    n_seg = capacity + 1
    flat_seg, data, mx = _moment_rows(seg, r, sf, ef, vf, capacity, h, w)
    mxr, mxc = mx[..., 0], mx[..., 1]
    mnr_raw, mnc_raw = -mx[..., 2], -mx[..., 3]
    sums = segment_sums(flat_seg, data, B * n_seg)
    sums = sums.reshape(B, n_seg, 6)[:, :capacity].float()

    area = sums[..., 0].int()
    valid_lab = area > 0
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
        min_r=torch.where(valid_lab, mnr_raw, 0),
        min_c=torch.where(valid_lab, mnc_raw, 0),
        max_r=torch.where(valid_lab, mxr + 1, 0),
        max_c=torch.where(valid_lab, mxc + 1, 0),
        centroid_r=torch.where(valid_lab, cy, zf),
        centroid_c=torch.where(valid_lab, cx, zf),
        eccentricity=torch.where(valid_lab, ecc, zf),
        valid=valid_lab,
    )


def _label_runs(labels: torch.Tensor, capacity: int, rcap: int):
    """The (B, H*rcap) run-slot table of label maps (B, H, W): label index,
    row, start and end column, validity, and the per-frame overflow flag."""
    B, h, w = labels.shape
    lab = labels.int()
    left = torch.nn.functional.pad(lab, (1, 0))[..., :-1]
    right = torch.nn.functional.pad(lab, (0, 1))[..., 1:]
    is_start = (lab > 0) & (lab != left)
    is_end = (lab > 0) & (lab != right)
    overflow = torch.any(is_start.sum(dim=-1) > rcap, dim=-1)

    # the rcap leftmost runs per row: keys descend with the column, and the
    # start key carries the run's label in its low digits
    c = torch.arange(w, dtype=torch.int32, device=lab.device)
    L = capacity + 2
    plab = torch.clamp(lab, max=capacity + 1)
    vs = torch.topk(torch.where(is_start, (w - c) * L + plab, 0), rcap, dim=-1).values
    ve = torch.topk(torch.where(is_end, w - c, 0), rcap, dim=-1).values
    start = torch.where(vs > 0, w - vs // L, w).reshape(B, -1)
    end = torch.where(ve > 0, w - ve + 1, 0).reshape(B, -1)
    run_lab = torch.where(vs > 0, vs % L, 0).reshape(B, -1)

    vf = end > 0
    seg = torch.clamp(torch.where(vf, run_lab - 1, capacity), max=capacity)
    r = torch.arange(h, dtype=torch.int32, device=lab.device)[:, None].expand(h, rcap)
    r = r.reshape(1, -1).expand(B, -1)
    return seg, r, start, end, vf, overflow


def run_moment_table(labels: torch.Tensor, capacity: int, rcap: int = 64):
    """The segment-sum input of `regionprops_from_labels`: (segment ids
    (B*H*rcap,) int32, int64 moments (B*H*rcap, 6), number of segments)."""
    B, h, w = labels.shape
    seg, r, start, end, vf, _ = _label_runs(labels, capacity, rcap)
    flat_seg, data, _ = _moment_rows(seg, r, start, end, vf, capacity, h, w)
    return flat_seg, data, B * (capacity + 1)


def regionprops_from_labels(labels: torch.Tensor, capacity: int, rcap: int = 64):
    """RegionProps of int32 label maps (B, H, W) for labels 1..capacity, and
    the (B,) flag that some row held more than `rcap` runs."""
    B, h, w = labels.shape
    seg, r, start, end, vf, overflow = _label_runs(labels, capacity, rcap)
    return _run_moments(seg, r, start, end, vf, capacity, h, w), overflow
