"""The reference's segmentation, one frame at a time, in plain PyTorch and SciPy.

- Percentile normalization (csbdeep's `normalize`): numpy's
  linear-interpolation percentiles of the raw frame, from its sorted
  values, lerped and applied in float32 as the configuration states.
- StarDist: the U-Net (`models.unet_forward`), the top-K grid pixels by
  probability (ties: lower index first) above `prob_thresh`, greedy
  star-polygon NMS in descending probability whose overlap of a pair is
  the intersection over union integrated on a 24 x 8 polar quadrature of
  the smaller polygon, and the label map: the kept polygons, the
  `raster_cap` most probable, numbered 1.. in descending probability, a
  pixel taking the polygon of largest (probability quantized to 15 bits,
  lower number) among those whose boundary radius at its angle reaches it.
- Threshold: the percentile threshold of the normalized frame, a binary
  opening with the 4-connected cross and SciPy's 4-connected labels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.models import dist_head, unet_forward

_N_ANGLES, _N_RADII = 24, 8


def _lerp(s: torch.Tensor, q: float) -> tuple:
    """numpy's linear-interpolation percentile q of the sorted flat values
    s: the two order statistics around the float64 rank, lerped in float32;
    also (rank below, rank above, float32 fraction)."""
    idx = q / 100.0 * (s.numel() - 1)
    lo, hi = int(math.floor(idx)), int(math.ceil(idx))
    f = torch.tensor(np.float32(idx - lo), device=s.device)
    return s[lo] * (1.0 - f) + s[hi] * f, (lo, hi, f)


def _lo_scale(s: torch.Tensor, pmin: float, pmax: float) -> tuple:
    lo, _ = _lerp(s, pmin)
    hi, _ = _lerp(s, pmax)
    return lo, hi - lo + torch.tensor(1e-20, dtype=torch.float32, device=s.device)


def normalize(x: torch.Tensor, pmin: float, pmax: float) -> torch.Tensor:
    """(x - p_min) / (p_max - p_min + 1e-20) of a float32 frame."""
    lo, scale = _lo_scale(torch.sort(x.reshape(-1)).values, pmin, pmax)
    return (x - lo) / scale


def threshold_labels(seg: torch.Tensor, cfg: dict) -> np.ndarray:
    """(H, W) raw seg channel -> int32 label map of the threshold backend."""
    from scipy import ndimage as ndi

    x = seg.float()
    s = torch.sort(x.reshape(-1)).values
    lo, scale = _lo_scale(s, cfg["norm_pmin"], cfg["norm_pmax"])
    # the percentile of the normalized frame: the normalization is monotone,
    # so it lerps the normalized order statistics
    _, (k0, k1, f) = _lerp(s, cfg["threshold_percentile"])
    thresh = (s[k0] - lo) / scale * (1.0 - f) + (s[k1] - lo) / scale * f
    mask = ((x - lo) / scale > thresh).cpu().numpy()
    cross = ndi.generate_binary_structure(2, 1)
    mask = ndi.binary_opening(mask, structure=cross, border_value=0)
    labels, _ = ndi.label(mask, structure=cross)
    return labels.astype(np.int32)


def radius_at(dists: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The boundary radius of star polygons (..., R) at angles theta (...):
    linear between the two rays around theta, ray k at 2 pi k / R."""
    R = dists.shape[-1]
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=theta.device)
    t = torch.remainder(theta, two_pi) / two_pi * R
    k0 = torch.floor(t)
    frac = t - k0
    shape = torch.broadcast_shapes(theta.shape, dists.shape[:-1])
    i0 = (k0.long() % R).expand(shape)
    i1 = (i0 + 1) % R
    d = dists.expand(*shape, R)
    r0 = torch.gather(d, -1, i0[..., None])[..., 0]
    r1 = torch.gather(d, -1, i1[..., None])[..., 0]
    return r0 * (1.0 - frac) + r1 * frac


def polygon_areas(dists: torch.Tensor) -> torch.Tensor:
    R = dists.shape[-1]
    s = torch.sin(torch.tensor(2.0 * math.pi / R, dtype=torch.float32, device=dists.device))
    return 0.5 * s * (dists * torch.roll(dists, -1, dims=-1)).sum(-1)


def pair_iou(centers: torch.Tensor, dists: torch.Tensor, valid: torch.Tensor):
    """(i, j, iou) of the candidate pairs i < j that can overlap (centre
    distance below the sum of their largest radii), the intersection
    integrated on the smaller polygon's polar quadrature."""
    areas = polygon_areas(dists)
    rmax = dists.amax(-1)
    d = centers[:, None, :] - centers[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    rs = rmax[:, None] + rmax[None, :]
    near = (d2 < rs * rs) & valid[:, None] & valid[None, :]
    near = torch.triu(near, diagonal=1)
    ii, jj = torch.nonzero(near, as_tuple=True)
    small_j = areas[jj] < areas[ii]
    pi = torch.where(small_j, jj, ii)
    pj = torch.where(small_j, ii, jj)
    dev = centers.device
    ang = (torch.arange(_N_ANGLES, dtype=torch.float32, device=dev) + 0.5) / _N_ANGLES
    ang = ang * 2.0 * math.pi
    f = torch.sqrt((torch.arange(_N_RADII, dtype=torch.float32, device=dev) + 0.5) / _N_RADII)
    ious = []
    for s in range(0, pi.numel(), 4096):
        a, b = pi[s:s + 4096], pj[s:s + 4096]
        rb = radius_at(dists[a][:, None, :], ang[None, :])                    # (P, A)
        rr = rb[:, :, None] * f                                               # (P, A, F)
        yy = centers[a, 0, None, None] + rr * torch.sin(ang)[:, None]
        xx = centers[a, 1, None, None] + rr * torch.cos(ang)[:, None]
        w = (0.5 * rb * rb * (2.0 * math.pi / _N_ANGLES) / _N_RADII)[:, :, None]
        py = yy - centers[b, 0, None, None]
        px = xx - centers[b, 1, None, None]
        inside = torch.sqrt(py * py + px * px) <= radius_at(dists[b][:, None, None, :],
                                                            torch.atan2(py, px))
        inter = (w * inside).sum(dim=(1, 2))
        inter = torch.minimum(inter, torch.minimum(areas[a], areas[b]))
        ious.append(inter / torch.clamp(areas[a] + areas[b] - inter, min=1e-12))
    iou = torch.cat(ious) if ious else torch.zeros(0, device=dev)
    return ii.cpu().numpy(), jj.cpu().numpy(), iou.cpu().numpy()


def greedy_nms(probs: np.ndarray, valid: np.ndarray, ii, jj, iou, thresh: float) -> np.ndarray:
    """Walk the valid candidates in descending probability (ties: lower
    index first); keep one unless a kept one overlaps it by more than
    `thresh`.  Returns the keep mask."""
    K = len(probs)
    over = iou > thresh
    neigh = [[] for _ in range(K)]
    for a, b in zip(ii[over].tolist(), jj[over].tolist()):
        neigh[a].append(b)
        neigh[b].append(a)
    keep = np.zeros(K, bool)
    order = sorted(np.flatnonzero(valid).tolist(), key=lambda k: (-probs[k], k))
    for k in order:
        if not any(keep[j] for j in neigh[k]):
            keep[k] = True
    return keep


def rasterize(centers: torch.Tensor, dists: torch.Tensor, probs: torch.Tensor,
              keep: np.ndarray, h: int, w: int, raster_cap: int) -> np.ndarray:
    """The (h, w) int32 label map of the kept polygons (see the module)."""
    dev = centers.device
    p = probs.cpu().numpy()
    kept = sorted(np.flatnonzero(keep).tolist(), key=lambda k: (-p[k], k))
    if raster_cap:
        kept = kept[:raster_cap]
    canvas = torch.zeros(h * w + 1, dtype=torch.int64, device=dev)
    if not kept:
        return np.zeros((h, w), np.int32)
    sel = torch.tensor(kept, device=dev)
    labels = torch.arange(1, len(kept) + 1, device=dev)
    prob_q = torch.clamp((probs[sel] * 32767.0).int(), 0, 32767).long()
    keys = (prob_q << 16) | (0xFFFF - labels)
    c, d = centers[sel], dists[sel]
    half = int(math.ceil(float(d.max()))) + 2
    ar = torch.arange(-half, half + 1, device=dev)
    for s in range(0, len(kept), 256):
        cc, dd, kk = c[s:s + 256], d[s:s + 256], keys[s:s + 256]
        gy = cc[:, 0].round().long()[:, None, None] + ar[:, None]
        gx = cc[:, 1].round().long()[:, None, None] + ar[None, :]
        py = gy.float() - cc[:, 0, None, None]
        px = gx.float() - cc[:, 1, None, None]
        inside = (torch.sqrt(py * py + px * px) <= radius_at(dd[:, None, None, :],
                                                            torch.atan2(py, px)))
        inside &= (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        flat = torch.where(inside, gy * w + gx, h * w).reshape(-1)
        vals = torch.where(inside, kk[:, None, None], 0).reshape(-1)
        canvas.scatter_reduce_(0, flat, vals, reduce="amax")
    canvas = canvas[:h * w].reshape(h, w)
    return torch.where(canvas > 0, 0xFFFF - (canvas & 0xFFFF), 0).int().cpu().numpy()


def stardist_labels(seg: torch.Tensor, unet: dict, cfg: dict) -> np.ndarray:
    """(H, W) raw seg channel -> int32 label map of StarDist (module)."""
    h, w = seg.shape
    depth = cfg["unet_depth"]
    if h % 2 ** depth or w % 2 ** depth:
        raise ValueError(f"frame {h}x{w}: sides must be multiples of {2 ** depth}")
    x = normalize(seg.float(), cfg["norm_pmin"], cfg["norm_pmax"])
    prob, feat, head = unet_forward(x[None, None], unet, depth)
    gy, gx = cfg["grid"]
    wp = prob.shape[2]
    order = torch.sort(prob[0].reshape(-1), descending=True, stable=True)
    K = cfg["max_candidates"]
    top_p, top_i = order.values[:K], order.indices[:K]
    rows = feat[0].reshape(feat.shape[1], -1)[:, top_i].t()
    dists = torch.clamp(dist_head(rows, head), min=1e-3)
    centers = torch.stack([(top_i // wp).float() * gy, (top_i % wp).float() * gx], dim=1)
    valid = top_p > cfg["prob_thresh"]
    ii, jj, iou = pair_iou(centers, dists, valid)
    keep = greedy_nms(top_p.cpu().numpy(), valid.cpu().numpy(), ii, jj, iou, cfg["nms_thresh"])
    return rasterize(centers, dists, top_p, keep, h, w, cfg.get("raster_cap") or 0)
