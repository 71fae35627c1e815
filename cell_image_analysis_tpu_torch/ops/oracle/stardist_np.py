"""Numpy oracle for the StarDist `predict_instances` post-processing.

Executable specification of StarDist's C++ NMS + polygon rasterization
(consumed inside `predict_instances`, CAE_improved_modeltrain.py:54,
improved_detection.py:62-63): candidate selection above prob_thresh, greedy
sequential NMS over star polygons (pixel-counted overlap on local patches),
and ascending-probability rasterization to an int label map.

Used by the StarDist CPU reference baseline (utils/bench.py) and as the
parity oracle for the device path (tests/test_stardist_backend.py).  The
network forward producing (prob, dist) is supplied by the caller — the CPU
baseline runs it through Keras/TF on CPU (the reference's stack).
"""

from __future__ import annotations

import numpy as np


def radius_at_np(dists: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Linear-interpolated boundary radius of star polygons at angles theta
    (same convention as ops/nms.radius_at)."""
    R = dists.shape[-1]
    t = (np.asarray(theta) % (2.0 * np.pi)) / (2.0 * np.pi) * R
    k0 = np.floor(t).astype(np.int64) % R
    k1 = (k0 + 1) % R
    frac = t - np.floor(t)
    r0 = np.take_along_axis(dists, k0[..., None], axis=-1)[..., 0]
    r1 = np.take_along_axis(dists, k1[..., None], axis=-1)[..., 0]
    return r0 * (1.0 - frac) + r1 * frac


def _patch_mask(center, dists, r0, c0, patch):
    """Boolean inside-mask of one star polygon on a patch anchored at
    (r0, c0)."""
    yy, xx = np.mgrid[0:patch, 0:patch]
    py = yy + r0 - center[0]
    px = xx + c0 - center[1]
    rho = np.sqrt(py * py + px * px)
    theta = np.arctan2(py, px)
    rb = radius_at_np(np.broadcast_to(dists, rho.shape + dists.shape), theta)
    return rho <= rb


def greedy_star_nms_np(centers, dists, probs, nms_thresh=0.3, metric="iou",
                       patch=None):
    """Sequential greedy NMS (the C++ algorithm): walk candidates in
    descending probability; keep a candidate iff its overlap with every
    already-kept polygon is <= nms_thresh.  Overlap is pixel-counted on a
    shared local patch (exact to rasterization resolution)."""
    K = len(probs)
    if patch is None:
        patch = int(2 * np.ceil(dists.max()) + 4) if K else 8
    order = np.argsort(-probs, kind="stable")
    keep: list[int] = []
    masks: dict[int, tuple[int, int, np.ndarray]] = {}

    def mask_of(i):
        if i not in masks:
            r0 = int(np.round(centers[i, 0])) - patch // 2
            c0 = int(np.round(centers[i, 1])) - patch // 2
            masks[i] = (r0, c0, _patch_mask(centers[i], dists[i], r0, c0, patch))
        return masks[i]

    for i in order:
        ok = True
        r0i, c0i, mi = mask_of(i)
        ai = mi.sum()
        for j in keep:
            # quick reject on center distance
            if np.hypot(*(centers[i] - centers[j])) > dists[i].max() + dists[j].max():
                continue
            r0j, c0j, mj = mask_of(j)
            # intersect the two patches in global coords
            rlo = max(r0i, r0j)
            rhi = min(r0i + patch, r0j + patch)
            clo = max(c0i, c0j)
            chi = min(c0i + patch, c0j + patch)
            if rlo >= rhi or clo >= chi:
                continue
            a = mi[rlo - r0i:rhi - r0i, clo - c0i:chi - c0i]
            b = mj[rlo - r0j:rhi - r0j, clo - c0j:chi - c0j]
            inter = np.logical_and(a, b).sum()
            aj = mj.sum()
            denom = min(ai, aj) if metric == "ios" else ai + aj - inter
            if denom > 0 and inter / denom > nms_thresh:
                ok = False
                break
        if ok:
            keep.append(int(i))
    mask = np.zeros(K, bool)
    mask[keep] = True
    return mask


def rasterize_polygons_np(centers, dists, probs, keep, height, width):
    """Ascending-probability draw (the best polygon overwrites), labels
    1..n_kept in DESCENDING prob order — StarDist's instance numbering
    (matches ops/rasterize.rasterize_polygons)."""
    labels = np.zeros((height, width), np.int32)
    kept = np.flatnonzero(keep)
    order_desc = kept[np.argsort(-probs[kept], kind="stable")]
    # draw ascending so the higher-prob polygon lands last
    for rank, i in reversed(list(enumerate(order_desc))):
        rmax = float(dists[i].max())
        patch = int(2 * np.ceil(rmax) + 4)
        r0 = int(np.round(centers[i, 0])) - patch // 2
        c0 = int(np.round(centers[i, 1])) - patch // 2
        m = _patch_mask(centers[i], dists[i], r0, c0, patch)
        rlo, rhi = max(r0, 0), min(r0 + patch, height)
        clo, chi = max(c0, 0), min(c0 + patch, width)
        if rlo >= rhi or clo >= chi:
            continue
        sub = m[rlo - r0:rhi - r0, clo - c0:chi - c0]
        labels[rlo:rhi, clo:chi][sub] = rank + 1
    return labels


def predict_instances_np(prob, dist, grid=(2, 2), prob_thresh=0.479071,
                         nms_thresh=0.3, metric="iou", max_candidates=None,
                         height=None, width=None):
    """Full post-processing oracle: (h', w') prob + (h', w', R) dist maps ->
    (labels, (centers, dists, probs, keep))."""
    hp, wp = prob.shape
    height = height if height is not None else hp * grid[0]
    width = width if width is not None else wp * grid[1]
    ys, xs = np.nonzero(prob > prob_thresh)
    probs = prob[ys, xs]
    if max_candidates is not None and len(probs) > max_candidates:
        sel = np.argsort(-probs, kind="stable")[:max_candidates]
        ys, xs, probs = ys[sel], xs[sel], probs[sel]
    centers = np.stack([ys * grid[0], xs * grid[1]], axis=1).astype(np.float64)
    cand = np.maximum(dist[ys, xs].astype(np.float64), 1e-3)
    keep = greedy_star_nms_np(centers, cand, probs.astype(np.float64),
                              nms_thresh=nms_thresh, metric=metric)
    labels = rasterize_polygons_np(centers, cand, probs, keep, height, width)
    return labels, (centers, cand, probs, keep)
