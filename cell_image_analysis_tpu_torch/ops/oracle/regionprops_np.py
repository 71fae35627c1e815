"""Numpy oracle for region properties (skimage.measure.regionprops semantics).

Counterpart of `cell_image_analysis_tpu/ops/oracle/regionprops_np.py`:

- `regionprops_np`: per labeled region the bbox, area, centroid,
  eccentricity, solidity, and mean/std intensity of the *bbox rectangle*
  crop (not the masked region), as the reference QC loop reads them
  (CAE_improved_modeltrain.py:59-105, improved_detection.py:67-109); the
  parity harness (`utils/parity.oracle_extract_cells`) extracts with it;
- `convex_area`: the pixels whose centres lie inside or on the convex hull
  (monotone chain) of the region's pixel centres.  It approximates
  skimage's `convex_image`; solidity is a report statistic, never a QC
  gate.  The chain runs over each row's leftmost and rightmost pixel only:
  every other pixel lies on the segment between those two, so the hull
  (collinear points dropped) and the count are JAX's, and the chain's
  Python loop is two points a row long instead of the region's area.
"""

from __future__ import annotations

import numpy as np


def eccentricity_from_moments(mu20: float, mu11: float, mu02: float) -> float:
    """skimage eccentricity: sqrt(1 - l2/l1) from the (area-normalized)
    central-moment inertia eigenvalues l1 >= l2."""
    t = (mu20 + mu02) / 2.0
    d = np.sqrt(((mu20 - mu02) / 2.0) ** 2 + mu11 ** 2)
    l1, l2 = t + d, t - d
    if l1 <= 0:
        return 0.0
    return float(np.sqrt(max(0.0, 1.0 - l2 / l1)))


def convex_area(coords: np.ndarray) -> int:
    """Pixels whose centers lie inside/on the convex hull of the region's
    (n, 2) (row, col) pixel centers."""
    coords = np.asarray(coords, np.int64)
    r, c = coords[:, 0], coords[:, 1]
    n_unique = len(np.unique((r - r.min()) * (c.max() - c.min() + 1) + (c - c.min())))
    if n_unique <= 2:
        return n_unique
    rows = np.unique(r)
    lo = np.full(rows[-1] + 1, np.iinfo(np.int64).max)
    hi = np.full(rows[-1] + 1, np.iinfo(np.int64).min)
    np.minimum.at(lo, r, c)
    np.maximum.at(hi, r, c)
    # each row's extremes, in (row, col) lexicographic order
    ends = np.stack([np.repeat(rows, 2), np.stack([lo[rows], hi[rows]], 1).ravel()], 1)
    keep = np.ones(len(ends), bool)
    keep[1::2] = hi[rows] != lo[rows]
    pts = ends[keep].astype(np.float64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    hull = np.array(lower[:-1] + upper[:-1])
    if len(hull) < 3:
        return n_unique

    minr, minc = pts.min(axis=0).astype(int)
    maxr, maxc = pts.max(axis=0).astype(int)
    rr, cc = np.mgrid[minr : maxr + 1, minc : maxc + 1]
    test = np.stack([rr.ravel(), cc.ravel()], axis=1).astype(np.float64)
    # point-in-polygon: sign of cross product against every hull edge (hull is
    # counter-clockwise in (row, col) space per the chain above)
    inside = np.ones(len(test), dtype=bool)
    n = len(hull)
    for i in range(n):
        o, a = hull[i], hull[(i + 1) % n]
        cr = (a[0] - o[0]) * (test[:, 1] - o[1]) - (a[1] - o[1]) * (test[:, 0] - o[0])
        inside &= cr >= -1e-9
    return int(inside.sum())


def regionprops_np(labels: np.ndarray, intensity: np.ndarray) -> list[dict]:
    """Per-region properties for labels 1..K (0 = background)."""
    out = []
    for lab in range(1, int(labels.max()) + 1):
        mask = labels == lab
        n = int(mask.sum())
        if n == 0:
            continue
        rs, cs = np.nonzero(mask)
        minr, maxr = int(rs.min()), int(rs.max()) + 1
        minc, maxc = int(cs.min()), int(cs.max()) + 1
        cy, cx = rs.mean(), cs.mean()
        mu20 = np.mean((rs - cy) ** 2)
        mu02 = np.mean((cs - cx) ** 2)
        mu11 = np.mean((rs - cy) * (cs - cx))
        crop = intensity[minr:maxr, minc:maxc]
        ca = convex_area(np.stack([rs, cs], axis=1))
        out.append(
            dict(
                label=lab,
                area=n,
                bbox=(minr, minc, maxr, maxc),
                centroid=(float(cy), float(cx)),
                eccentricity=eccentricity_from_moments(mu20, mu11, mu02),
                solidity=n / ca if ca else 0.0,
                mean_intensity_bbox=float(crop.mean()),
                std_intensity_bbox=float(crop.std()),
            )
        )
    return out
