"""The comparison that decides `correct`: the program's screening of a batch
against the reference's (`reference/screen.py`) of the same frames.

Cells are matched within a frame by what the program returns of them and
no label numbering: the same area, a raw crop mean within `MEAN_TOLERANCE`
of each other (the bounding-box mean pins the box) and an eccentricity
within `ECC_TOLERANCE` (a pixel that moved from one edge of a cell to
another moves it by about 1e-3).  Two numbers are compared, each with its
limit from the cell's workload file:

- `cells_unmatched_pct`: the cells of either side that found no partner,
  in % of the reference's cells.  A pixel on the knife edge of a star
  polygon, where float32 rounding decides, moves an area by one;
- `value_gap`: over the matched cells, the widest gap of any value the
  program returns of a cell (eccentricity, crop mean and standard
  deviation, reconstruction MSE and MAE, the three decision scores, the
  four predictions, the 27 FFT features), as |program - reference| over
  the larger of |reference| and the median |reference| of that value.
"""

from __future__ import annotations

import numpy as np

MEAN_TOLERANCE = 1e-4
ECC_TOLERANCE = 1e-4
VALUE_KEYS = ("eccentricity", "mean_intensity", "std_intensity", "reconstruction_mse",
              "reconstruction_mae", "conservative_scores", "moderate_scores", "fft_scores",
              "conservative_predictions", "moderate_predictions", "ensemble_predictions",
              "fft_predictions")


def match(got: dict, ref: dict) -> list:
    """[(program row, reference row)] of the cells matched frame by frame."""
    pairs = []
    for f in np.union1d(got["frame_index"], ref["frame_index"]):
        by_area: dict = {}
        for r in np.flatnonzero(ref["frame_index"] == f):
            by_area.setdefault(int(ref["area"][r]), []).append(r)
        for g in np.flatnonzero(got["frame_index"] == f):
            rows = [r for r in by_area.get(int(got["area"][g]), [])
                    if abs(got["eccentricity"][g] - ref["eccentricity"][r]) <= ECC_TOLERANCE]
            d = [abs(got["mean_intensity"][g] - ref["mean_intensity"][r])
                 / max(abs(ref["mean_intensity"][r]), 1e-12) for r in rows]
            if d and min(d) <= MEAN_TOLERANCE:
                r = rows[int(np.argmin(d))]
                pairs.append((g, r))
                by_area[int(got["area"][g])].remove(r)
    return pairs


def _columns(scores: dict, stats: dict) -> dict:
    cols = {k: np.asarray(stats[k], np.float64) for k in VALUE_KEYS[:3]}
    n = len(stats["area"])
    for k in VALUE_KEYS[3:]:
        cols[k] = np.asarray(scores.get(k, np.zeros(n)), np.float64)
    fft = np.asarray(scores.get("fft_features", np.zeros((n, 0))), np.float64)
    for j in range(fft.shape[1] if fft.ndim == 2 else 0):
        cols[f"fft_{j}"] = fft[:, j]
    return cols


def compare(samples: list) -> dict:
    """{number: value} of the program's (scores, stats) against the
    reference's over [(program result, reference result)] of the sampled
    batches, plus the counts behind them."""
    n_got = n_ref = matched = 0
    gap = 0.0
    for (gs, gt), (rs, rt) in samples:
        pairs = match(gt, rt)
        n_got, n_ref, matched = n_got + len(gt["area"]), n_ref + len(rt["area"]), matched + len(pairs)
        if not pairs:
            continue
        g = np.array([p[0] for p in pairs])
        r = np.array([p[1] for p in pairs])
        gc, rc = _columns(gs, gt), _columns(rs, rt)
        for k, rv in rc.items():
            rv = rv[r]
            scale = np.maximum(np.abs(rv), np.median(np.abs(rv)))
            gv = gc[k][g] if k in gc else np.full(len(g), np.nan)
            d = np.abs(gv - rv) / np.where(scale > 0, scale, 1.0)
            gap = max(gap, float(np.max(np.where(np.isfinite(d), d, np.inf))))
    unmatched = (n_got - matched) + (n_ref - matched)
    return dict(cells_unmatched_pct=100.0 * unmatched / max(n_ref, 1), value_gap=gap,
                cells_program=n_got, cells_reference=n_ref, cells_matched=matched)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {value, limit}}): every number at or below its
    limit, and cells to compare on both sides."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = (all(c["value"] <= c["limit"] for c in checks.values())
          and numbers["cells_reference"] > 0 and numbers["cells_matched"] > 0)
    return ok, checks
