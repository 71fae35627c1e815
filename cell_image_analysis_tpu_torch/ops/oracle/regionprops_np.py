"""Convex area of a region, on the host (the training report's solidity).

Counterpart of `convex_area` in
`cell_image_analysis_tpu/ops/oracle/regionprops_np.py`: the pixels whose
centres lie inside or on the convex hull (monotone chain) of the region's
pixel centres.  It approximates skimage's `convex_image`; solidity is a
report statistic, never a QC gate.  The chain runs over each row's
leftmost and rightmost pixel only: every other pixel lies on the segment
between those two, so the hull (collinear points dropped) and the count
are JAX's, and the chain's Python loop is two points a row long instead of
the region's area.
"""

from __future__ import annotations

import numpy as np


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
