"""Run-length connected components and regionprops.

Counterpart of `cell_image_analysis_tpu/ops/runs.py`: each row's runs go
into a static `(H, rcap)` table (the `rcap` leftmost runs; more set the
per-frame overflow flag), and area, bbox, centroid and eccentricity follow
from closed-form per-run moments reduced per region.

- `regionprops_from_labels`: runs of constant positive label of instance
  label maps — stage A's main route, for every segmentation backend (the
  exact twins take the pixel regionprops, `ops.regionprops`);
- `labels_from_mask`: the connected components of boolean masks as label
  maps, by the run path (API and tests; the pipeline labels masks with
  `ops.cc.label_components`): runs of the mask (`run_table`, top-k form),
  joined into components by neighbour-min hooks over the runs of adjacent
  rows (`cc_runs`) and numbered in scipy's raster order
  (`_component_numbers`).

The six moments are integers, so the port computes them in int64 and
reduces them with `ops.segsum.segment_sums` (the CUDA segment-sum kernel on
the GPU): exact in any summation order.  The bbox maxima are a plain
`scatter_reduce`.  Batched over frames (B, H, W); the hook loop runs until
no frame changes, which leaves frames that converged earlier as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.ops.regionprops import (
    RegionProps,
    bbox_anchors,
    props_from_moments,
    segment_bbox_max,
)
from cell_image_analysis_tpu_torch.ops.segsum import segment_sums
from cell_image_analysis_tpu_torch.utils.profiler import count, span

_INF = 1 << 30
_CHECK_EVERY = 4  # hook sweeps between two convergence checks (JAX's default)


class RunTable(NamedTuple):
    """Row runs of boolean masks, padded to `rcap` slots per row.  Unused
    slots have start = W and end = 0."""

    start: torch.Tensor     # (B, H, rcap) int32 first column
    end: torch.Tensor       # (B, H, rcap) int32 one past the last column
    overflow: torch.Tensor  # (B,) bool: some row had more than rcap runs


def _moment_rows(seg, r, sf, ef, vf, capacity: int, h: int, w: int):
    """Per-slot bbox maxima and int64 run moments.  All inputs are (B, S)
    over run slots; `seg` holds the 0-based region index per slot
    (capacity = dump).  Returns (flat segment ids (B*S,) int32 over
    B*(capacity+1) segments, moments (B*S, 6) int64, bbox maxima
    (B, capacity, 4))."""
    B = seg.shape[0]
    n_seg = capacity + 1
    flat_seg = (seg.long() + n_seg * torch.arange(B, device=seg.device)[:, None]).reshape(-1)
    feats = torch.stack([r, ef - 1, -r, -torch.where(vf, sf, _INF)], dim=-1).reshape(-1, 4)
    mx = segment_bbox_max(flat_seg, feats, B * n_seg).reshape(B, n_seg, 4)[:, :capacity]

    anchor_r, anchor_c = bbox_anchors(mx, h, w)
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
    """Per-run moments -> per-region props (see `_moment_rows`)."""
    B = seg.shape[0]
    n_seg = capacity + 1
    flat_seg, data, mx = _moment_rows(seg, r, sf, ef, vf, capacity, h, w)
    sums = segment_sums(flat_seg, data, B * n_seg)
    return props_from_moments(sums.reshape(B, n_seg, 6)[:, :capacity], mx, h, w)


def _row_index(B: int, h: int, rcap: int, device) -> torch.Tensor:
    r = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, rcap)
    return r.reshape(1, -1).expand(B, -1)


def _label_runs(labels: torch.Tensor, capacity: int, rcap: int):
    """The (B, H*rcap) run-slot table of label maps (B, H, W): label index,
    row, start and end column, validity, and the per-frame overflow flag."""
    B, h, w = labels.shape
    lab = labels.int()
    left = F.pad(lab, (1, 0))[..., :-1]
    right = F.pad(lab, (0, 1))[..., 1:]
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
    return seg, _row_index(B, h, rcap, lab.device), start, end, vf, overflow


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


def run_table(mask: torch.Tensor, rcap: int = 64) -> RunTable:
    """The padded row-run table of boolean masks (B, H, W): the start
    (end) columns are the rcap largest keys W - c over the start (end)
    flags, i.e. the leftmost runs in ascending order."""
    B, h, w = mask.shape
    m = mask.bool()
    left = F.pad(m, (1, 0))[..., :-1]
    right = F.pad(m, (0, 1))[..., 1:]
    is_start, is_end = m & ~left, m & ~right
    overflow = torch.any(is_start.sum(dim=-1) > rcap, dim=-1)
    c = torch.arange(w, dtype=torch.int32, device=m.device)
    vs = torch.topk(torch.where(is_start, w - c, 0), rcap, dim=-1).values
    ve = torch.topk(torch.where(is_end, w - c, 0), rcap, dim=-1).values
    return RunTable(start=torch.where(vs > 0, w - vs, w).int(),
                    end=torch.where(ve > 0, w - ve + 1, 0).int(), overflow=overflow)


def _shift_rows(x: torch.Tensor, off: int, fill) -> torch.Tensor:
    """x (B, H, ...) with row r holding row r + off (off = +-1), `fill`
    past the edge."""
    pad = torch.full_like(x[:, :1], fill)
    if off < 0:
        return torch.cat([pad, x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], pad], dim=1)


def cc_runs(table: RunTable, connectivity: int = 1) -> torch.Tensor:
    """Component-min run ids (r*rcap + j of each component's raster-first
    run) via neighbour-min hooks between the runs of adjacent rows; INF on
    unused slots.  (B, H, rcap) int32.  The span `runs.cc`; each check of
    the fixpoint is one host wait (`host_waits.runs_cc`)."""
    with span("runs.cc"):
        return _cc_runs(table, connectivity)


def _cc_runs(table: RunTable, connectivity: int) -> torch.Tensor:
    start, end = table.start, table.end
    B, h, rcap = start.shape
    dev = start.device
    valid = end > 0
    own = (torch.arange(h, dtype=torch.int32, device=dev)[:, None] * rcap
           + torch.arange(rcap, dtype=torch.int32, device=dev)[None, :])
    p = torch.where(valid, own, _INF)
    d = 1 if connectivity == 2 else 0
    # interval overlap (touch at 8-connectivity), masked with the validity
    # of both slots: at d = 1 the unused-slot sentinel (start W, end 0)
    # would pass the test against a full-width run and relay labels
    # across an empty row
    ov = []
    for off in (-1, 1):
        s_n, e_n = _shift_rows(start, off, 1 << 20), _shift_rows(end, off, 0)
        v_n = _shift_rows(valid, off, False)
        ov.append((start[..., :, None] < e_n[..., None, :] + d)
                  & (s_n[..., None, :] < end[..., :, None] + d)
                  & valid[..., :, None] & v_n[..., None, :])
    while True:
        new = p
        for _ in range(_CHECK_EVERY):
            best = new
            for off, ov_n in zip((-1, 1), ov):
                p_n = _shift_rows(new, off, _INF)
                best = torch.minimum(best, torch.where(ov_n, p_n[..., None, :], _INF).amin(-1))
            new = best
        count("host_waits.runs_cc")
        if torch.equal(new, p):
            return new
        p = new


def _component_numbers(parent: torch.Tensor, valid: torch.Tensor):
    """1..K component numbers per run slot (0 unused), in raster order of
    each component's first run — scipy.ndimage.label numbering — and the
    count K per frame.  parent, valid: (B, H, rcap)."""
    B, h, rcap = parent.shape
    own = torch.arange(h * rcap, dtype=torch.int32, device=parent.device)
    flatp = parent.reshape(B, -1)
    v = valid.reshape(B, -1)
    cnum = torch.cumsum(v & (flatp == own), dim=1)
    comp = torch.where(v, torch.gather(cnum, 1, torch.clamp(flatp, max=h * rcap - 1).long()), 0)
    return comp.reshape(B, h, rcap).int(), cnum[:, -1].int()


def labels_from_mask(mask: torch.Tensor, rcap: int = 64, connectivity: int = 1) -> tuple:
    """(labels int32, count int32, overflow bool) of boolean masks (H, W)
    or (B, H, W), with a leading (B,) on count and overflow in the second
    form: the label maps in scipy numbering by the run path, the API and
    test counterpart of `ops.cc.label_components`.  A pixel takes the
    component of its run's rank in the row's table; past `rcap` runs it
    takes the last slot's, as JAX."""
    single = mask.dim() == 2
    m = (mask[None] if single else mask).bool()
    table = run_table(m, rcap=rcap)
    comp, count = _component_numbers(cc_runs(table, connectivity=connectivity), table.end > 0)
    is_start = m & ~F.pad(m, (1, 0))[..., :-1]
    rank = torch.clamp(torch.cumsum(is_start.int(), dim=-1) - 1, 0, rcap - 1)
    labels = torch.where(m, torch.gather(comp, 2, rank), 0).int()
    if single:
        return labels[0], count[0], table.overflow[0]
    return labels, count, table.overflow

