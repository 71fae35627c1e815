"""Cellpose's masks from flows, its flow-error QC and its clean-up, batched
over the frames on the device.

The JAX package has no counterpart.  The source is MouseLand/cellpose 3:
`dynamics.get_masks`, `dynamics.masks_to_flows_gpu` with
`metrics.flow_error` (`dynamics.remove_bad_flow_masks`) and
`utils.fill_holes_and_remove_small_masks`.  No Python loop runs over
cells or seeds; the host waits only where a size is read (the label
table, the mask pixels, the QC's iterations, the hole crops).

- `get_masks`: every pixel's final position (`ops.flows.follow_flows`;
  non-cell pixels keep their own), truncated to int, makes a histogram
  over the frame padded by `RPAD`; the seeds are the pixels that equal
  their 5x5 maximum with more than 10 counts, numbered in raster order
  (Cellpose's `isort` never reorders them, so a later seed wins an
  overlap); each seed grows five times by 3x3 through pixels with more
  than 2 counts.  The later seed winning is the largest number, so the
  growth is five rounds of a 3x3 max filter of the seed numbers, masked
  where the histogram is above 2.  Every pixel takes the number at its
  final position; masks above `max_size_fraction` of the frame go, and
  the rest are renumbered by first appearance in raster order
  (`fastremap.renumber`).  The seed table is sized to the batch's most
  seeds (one host read).
- `masks_to_flows` (the GPU form: one `n_iter` a frame, 2 x the largest
  (rows + 1) + (cols + 1) of its masks' boxes) and `flow_errors`: a
  float64 heat map on the frame padded by 1, each step 1 added at every
  mask's centre (the mask pixel nearest the median of its rows and of its
  columns, ties in raster order) and each mask pixel set to the mean of
  its 9 neighbours, those of another label counting 0; the flows are the
  central differences of log(1 + T) over their norm (+ 1e-60); a mask's
  error is the mean over its pixels of sum_k (flow_k - dP_k / 5)^2.
  `remove_bad_flow_masks` zeroes the masks whose error is above the
  threshold.
- `fill_holes_and_remove_small`: masks under `min_size` pixels go; every
  other one takes the holes of its box (4-connected background of the
  mask's box crop that does not reach the box's edge: the connected
  components of the crops, `ops.cc.label_components`) and the next
  label.  Cellpose does this one mask at a time, in label order, so a
  pixel ends with the last mask whose fill holds it, and a mask that an
  earlier one's fill took whole is gone at its turn and not numbered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.ops.cc import label_components
from cell_image_analysis_tpu_torch.ops.flows import MIN_POINTS
from cell_image_analysis_tpu_torch.utils.profiler import count

RPAD = 20            # get_masks' histogram padding
SEED_MIN = 10        # a seed has more counts than this
GROW_MIN = 2         # growth goes through pixels with more counts than this
GROW_ROUNDS = 5
CROP_BUDGET = 1 << 26  # pixels of hole crops labelled in one call
# the 9 neighbours of masks_to_flows_gpu, in its order: self, up, down,
# left, right, then the diagonals
NEIGHBOURS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1))


def _grid(B: int, h: int, w: int, device) -> torch.Tensor:
    yy, xx = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([yy, xx]).expand(B, 2, h, w)


def get_masks(p: torch.Tensor, iscell: torch.Tensor, n_moving: torch.Tensor,
              max_size_fraction: float = 0.4) -> tuple:
    """(labels (B, H, W) int32 numbered 1.. in raster order of first
    appearance, seeds (B,) int64) of the final
    positions p (B, 2, H, W) of `follow_flows`, the cell pixels iscell
    (B, H, W) and each frame's moving points (frames with fewer than 5 get
    no masks)."""
    B, _, h, w = p.shape
    # the histogram of the truncated final positions over the padded frame
    own = _grid(B, h, w, p.device)
    pos = torch.where(iscell[:, None], p.to(torch.int32).long(), own) + RPAD
    hp, wp = h + 2 * RPAD, w + 2 * RPAD
    frame = torch.arange(B, device=p.device)[:, None, None]
    at = (frame * hp + pos[:, 0]) * wp + pos[:, 1]
    hist = torch.bincount(at.reshape(-1), minlength=B * hp * wp).reshape(B, hp, wp).float()
    hmax = F.max_pool2d(hist[:, None], 5, stride=1, padding=2)[:, 0]
    seeds = (hist >= hmax) & (hist > SEED_MIN)
    rank = torch.cumsum(seeds.reshape(B, -1).int(), dim=1)
    n_seeds = rank[:, -1].long()
    cap = int(n_seeds.max())
    ids = torch.where(seeds.reshape(B, -1), rank, 0)
    grid = ids.reshape(seeds.shape).float()
    through = hist > GROW_MIN
    for _ in range(GROW_ROUNDS):
        grid = torch.where(through, F.max_pool2d(grid[:, None], 3, stride=1, padding=1)[:, 0],
                           0.0)
    m0 = grid[frame, pos[:, 0], pos[:, 1]].long()                       # (B, H, W)
    m0 = torch.where((n_moving >= MIN_POINTS)[:, None, None], m0, 0)
    s1 = cap + 1
    flat = m0.reshape(B, -1)
    seg = flat + torch.arange(B, device=p.device)[:, None] * s1
    counts = torch.bincount(seg.reshape(-1), minlength=B * s1).reshape(B, s1)
    big = (counts > h * w * max_size_fraction)
    big[:, 0] = False
    flat = torch.where(big.gather(1, flat), 0, flat)
    return renumber(flat, s1).reshape(B, h, w).int(), n_seeds


def renumber(flat: torch.Tensor, s1: int) -> torch.Tensor:
    """(B, N) labels in [0, s1) -> 1.. by first appearance in each row, 0
    kept (`fastremap.renumber`)."""
    B, n = flat.shape
    idx = torch.arange(n, device=flat.device).expand(B, n)
    first = torch.full((B, s1), n, dtype=torch.long, device=flat.device)
    first.scatter_reduce_(1, flat, idx, reduce="amin")
    first[:, 0] = n + 1
    order = torch.argsort(first, dim=1)
    new = torch.zeros((B, s1), dtype=torch.long, device=flat.device)
    new.scatter_(1, order, torch.arange(1, s1 + 1, device=flat.device).expand(B, s1))
    new = torch.where(first < n, new, 0)
    return new.gather(1, flat)


def _segment_median(key: torch.Tensor, vals: torch.Tensor, start: torch.Tensor,
                    cnt: torch.Tensor) -> torch.Tensor:
    """np.median of `vals` within each segment (`key`), float64."""
    order = torch.argsort(key * (int(vals.max()) + 1) + vals)
    sv = vals[order].double()
    last = sv.numel() - 1          # empty segments read any element
    lo = sv[torch.clamp(start + (cnt - 1) // 2, 0, last)]
    hi = sv[torch.clamp(start + cnt // 2, 0, last)]
    return (lo + hi) / 2


def masks_to_flows(labels: torch.Tensor, s1: int | None = None) -> tuple:
    """(flows (B, 2, H, W) float64 (dy, dx), n_iter (B,) int64) of label
    maps (B, H, W), as `masks_to_flows_gpu` computes them frame by frame;
    labels in [0, s1)."""
    B, h, w = labels.shape
    dev = labels.device
    hp, wp = h + 2, w + 2
    lp = F.pad(labels.long(), (1, 1, 1, 1))
    s1 = int(labels.max()) + 1 if s1 is None else s1
    mu0 = torch.zeros((B, 2, h, w), dtype=torch.float64, device=dev)
    b, y, x = torch.nonzero(lp > 0, as_tuple=True)          # raster order
    n_iter = torch.zeros(B, dtype=torch.long, device=dev)
    if b.numel() == 0:
        return mu0, n_iter
    lab = lp[b, y, x]
    seg = b * s1 + lab
    n_seg = B * s1
    cnt = torch.bincount(seg, minlength=n_seg)
    start = torch.cumsum(cnt, 0) - cnt
    big = torch.iinfo(torch.long).max
    ext = []
    for v in (y, x):
        lo = torch.full((n_seg,), big, dtype=torch.long, device=dev).scatter_reduce(
            0, seg, v, reduce="amin")
        hi = torch.full((n_seg,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, seg, v, reduce="amax")
        ext.append(hi - lo + 2)            # (stop - start) + 1 of find_objects' slice
    present = cnt > 0
    span_ = torch.where(present, ext[0] + ext[1], 0).reshape(B, s1)
    n_iter = 2 * span_.max(dim=1).values
    ymed = _segment_median(seg, y, start, cnt)
    xmed = _segment_median(seg, x, start, cnt)
    d = (x - xmed[seg]) ** 2 + (y - ymed[seg]) ** 2
    dmin = torch.full((n_seg,), float("inf"), dtype=torch.float64, device=dev).scatter_reduce(
        0, seg, d, reduce="amin")
    flat = (b * hp + y) * wp + x
    at = torch.where(d == dmin[seg], flat, big)
    centre = torch.full((n_seg,), big, dtype=torch.long, device=dev).scatter_reduce(
        0, seg, at, reduce="amin")[present]
    centre_frame = centre // (hp * wp)
    nbr = torch.stack([((b * hp + y + dy) * wp + x + dx) for dy, dx in NEIGHBOURS])  # (9, N)
    isneigh = (lp.reshape(-1)[nbr] == lab).double()
    T = torch.zeros(B * hp * wp, dtype=torch.float64, device=dev)
    steps = int(n_iter.max())
    pix_iter, cen_iter = n_iter[b], n_iter[centre_frame]
    for i in range(steps):
        T.index_add_(0, centre, (cen_iter > i).double())
        mean = (T[nbr] * isneigh).mean(dim=0)
        T[flat] = torch.where(pix_iter > i, mean, T[flat])
    T = torch.log(1.0 + T)
    dy = T[nbr[2]] - T[nbr[1]]
    dx = T[nbr[4]] - T[nbr[3]]
    norm = 1e-60 + torch.sqrt(dy ** 2 + dx ** 2)
    mu0[b, 0, y - 1, x - 1] = dy / norm
    mu0[b, 1, y - 1, x - 1] = dx / norm
    return mu0, n_iter


def flow_errors(labels: torch.Tensor, dP: torch.Tensor, s1: int | None = None) -> tuple:
    """(errors (B, s1) float64, label 0 and absent labels 0; n_iter (B,))
    of `metrics.flow_error`: per mask, the mean over its pixels of
    sum_k (flow_k - dP_k / 5)^2, the flows of `masks_to_flows`."""
    B = labels.shape[0]
    s1 = int(labels.max()) + 1 if s1 is None else s1
    mu, n_iter = masks_to_flows(labels, s1)
    five = torch.full((), 5.0, dtype=torch.float32, device=dP.device)
    net = (dP.float() / five).double()
    seg = (labels.long() + torch.arange(B, device=labels.device)[:, None, None] * s1).reshape(-1)
    cnt = torch.bincount(seg, minlength=B * s1).double()
    err = torch.zeros(B * s1, dtype=torch.float64, device=labels.device)
    for k in range(2):
        sq = ((mu[:, k] - net[:, k]) ** 2).reshape(-1)
        err += torch.bincount(seg, weights=sq, minlength=B * s1) / torch.clamp(cnt, min=1)
    err = err.reshape(B, s1)
    err[:, 0] = 0
    return err, n_iter


def remove_bad_flow_masks(labels: torch.Tensor, dP: torch.Tensor, threshold: float = 0.4,
                          s1: int | None = None) -> tuple:
    """(labels with the masks whose flow error is above `threshold` zeroed,
    removed masks (B,), QC iterations (B,))."""
    err, n_iter = flow_errors(labels, dP, s1)
    bad = err > threshold
    flat = labels.long().reshape(labels.shape[0], -1)
    out = torch.where(bad.gather(1, flat), 0, flat).reshape(labels.shape).int()
    return out, bad.sum(1), n_iter


def _mask_holes(labels: torch.Tensor, b: torch.Tensor, lab: torch.Tensor, r0: torch.Tensor,
                c0: torch.Tensor, hh: torch.Tensor, ww: torch.Tensor, side: int) -> tuple:
    """(crop index, row, col) of the hole pixels of the masks (b, lab) with
    boxes at (r0, c0) of hh x ww, within side^2 crops: `binary_fill_holes`
    of each mask's box crop, less the mask."""
    B, h, w = labels.shape
    ar = torch.arange(side + 2, device=labels.device)
    rr = r0[:, None] - 1 + ar
    cc = c0[:, None] - 1 + ar
    inb = (((ar >= 1) & (ar <= hh[:, None]))[:, :, None]
           & ((ar >= 1) & (ar <= ww[:, None]))[:, None, :])
    vals = labels[b[:, None, None], rr.clamp(0, h - 1)[:, :, None],
                  cc.clamp(0, w - 1)[:, None, :]]
    other = ~(inb & (vals == lab[:, None, None]))
    comp, _ = label_components(other.contiguous(), connectivity=1)
    hole = other & inb & (comp != comp[:, :1, :1])
    k, i, j = torch.nonzero(hole, as_tuple=True)
    return k, rr[k, i], cc[k, j]


def fill_holes_and_remove_small(labels: torch.Tensor, min_size: int = 15,
                                s1: int | None = None) -> tuple:
    """(labels renumbered 1.. in label order, removed small masks (B,)) of
    `fill_holes_and_remove_small_masks` on label maps (B, H, W), labels in
    [0, s1); counter `cellpose.removed_small`."""
    B, h, w = labels.shape
    dev = labels.device
    s1 = int(labels.max()) + 1 if s1 is None else s1
    flat = labels.long().reshape(B, -1)
    seg = (flat + torch.arange(B, device=dev)[:, None] * s1).reshape(-1)
    n_seg = B * s1
    npix = torch.bincount(seg, minlength=n_seg)
    npix[::s1] = 0
    pix = torch.arange(h * w, device=dev).expand(B, h * w).reshape(-1)
    big = torch.iinfo(torch.long).max
    box = []
    for v, red, init in ((pix // w, "amin", big), (pix % w, "amin", big),
                         (pix // w, "amax", -1), (pix % w, "amax", -1)):
        box.append(torch.full((n_seg,), init, dtype=torch.long, device=dev).scatter_reduce(
            0, seg, v, reduce=red))
    keep = npix >= max(min_size, 1)
    removed = (((npix > 0) & ~keep).reshape(B, s1)).sum(1)
    owner_min = torch.full((B * h * w,), big, dtype=torch.long, device=dev)
    holes = []                     # (frame pixel, frame, label) of every hole pixel
    kept = torch.nonzero(keep).flatten()
    if kept.numel():
        kb, klab = kept // s1, kept % s1
        r0, c0 = box[0][kept], box[1][kept]
        hh, ww = box[2][kept] - r0 + 1, box[3][kept] - c0 + 1
        side, n_small = torch.stack([torch.maximum(hh, ww).max(), removed.sum()]).tolist()
        per = max(1, CROP_BUDGET // (side + 2) ** 2)
        for s in range(0, kept.numel(), per):
            sl = slice(s, s + per)
            k, r, c = _mask_holes(labels, kb[sl], klab[sl], r0[sl], c0[sl], hh[sl], ww[sl], side)
            k = k + s
            holes.append(((kb[k] * h + r) * w + c, kb[k], klab[k]))
            owner_min.scatter_reduce_(0, holes[-1][0], klab[k], reduce="amin")
    # a mask whose pixels an earlier mask's fill took is gone at its turn
    lab = flat.reshape(-1)
    early = owner_min < lab
    npix_now = npix - torch.bincount(seg[early], minlength=n_seg)
    counted = (npix_now >= max(min_size, 1)).reshape(B, s1)
    counted[:, 0] = False
    new = (torch.cumsum(counted.long(), dim=1) * counted).reshape(-1)
    # every pixel takes the last mask in label order whose fill holds it:
    # its own mask's unless an earlier fill took it
    last = torch.where(counted.reshape(-1)[seg] & ~early, lab, 0)
    for at, hb, hl in holes:
        writes = counted.reshape(-1)[hb * s1 + hl]
        last.scatter_reduce_(0, at[writes], hl[writes], reduce="amax")
    frame = torch.arange(B * h * w, device=dev) // (h * w)
    out = new[frame * s1 + last]
    count("cellpose.removed_small", n_small if kept.numel() else int(removed.sum()))
    return out.reshape(B, h, w).int(), removed
