"""Parity checks between two screenings of the same frames.

Counterpart, in part, of `cell_image_analysis_tpu/utils/parity.py`: it
compares two `score_frames_fused` results — the port against the JAX
package, or the port on the GPU against the port on the CPU — and says
where they may differ and where they did.

Two kinds of decision may legitimately flip between float32
implementations that sum in different orders, and both are reported:

- a pixel whose center lies within `KNIFE_EDGE_PX` of a kept star
  polygon's boundary (the rasterizer's `rho <= r(theta)` test);
- a prediction whose decision value lies within `tol` of its threshold.

A cell touched by either is excluded from the checks that depend on it.
Every other difference fails the comparison with an AssertionError.  A
caller may also name cells to leave out of the comparison altogether
(`exclude`), such as the StarDist polygons that the scatter rasterizer
clips to its patch by design.
"""

from __future__ import annotations

import numpy as np
import torch

from cell_image_analysis_tpu_torch.ops.nms import radius_at

KNIFE_EDGE_PX = 1e-3


def boundary_margin(centers, dists, keep, rows, cols) -> torch.Tensor:
    """Distance (px) from each pixel center (rows, cols) to the nearest
    kept polygon boundary, measured along the ray: min_k |rho_k - r_k|.
    centers (K, 2), dists (K, R), keep (K,)."""
    py = rows.float()[:, None] - centers[None, :, 0]
    px = cols.float()[:, None] - centers[None, :, 1]
    rho = torch.sqrt(py * py + px * px)
    rb = radius_at(dists[None], torch.atan2(py, px))
    m = torch.where(keep[None], (rho - rb).abs(), torch.full_like(rho, np.inf))
    return m.min(dim=1).values


def boundary_flips(labels_a, labels_b, centers, dists, keep,
                   eps: float = KNIFE_EDGE_PX) -> dict:
    """{label id: pixels where the two (H, W) label maps of one frame
    differ}.  Every differing pixel must be a knife edge of a kept polygon
    (margin < eps) of that frame."""
    a, b = torch.as_tensor(labels_a), torch.as_tensor(labels_b)
    rr, cc = torch.nonzero(a != b, as_tuple=True)
    if rr.numel() == 0:
        return {}
    margin = boundary_margin(torch.as_tensor(centers), torch.as_tensor(dists),
                             torch.as_tensor(keep), rr, cc)
    if bool((margin >= eps).any()):
        worst = float(margin.max())
        raise AssertionError(f"label maps differ {worst:.3e} px from any polygon boundary")
    counts: dict = {}
    for lab in torch.cat([a[rr, cc], b[rr, cc]]).tolist():
        if lab > 0:
            counts[lab] = counts.get(lab, 0) + 1
    return counts


def _drop_cells(result: tuple, exclude: set) -> tuple:
    """The (scores, stats) result without the (frame, label id) cells in
    `exclude`."""
    scores, stats = result
    keep = np.array([c not in exclude for c in zip(stats["frame_index"].tolist(),
                                                   stats["label_ids"].tolist())], bool)
    return ({k: v[keep] if isinstance(v, np.ndarray) else v for k, v in scores.items()},
            {k: v[keep] for k, v in stats.items()})


def compare_screens(ref: tuple, got: tuple, flips: dict, mse_threshold: float,
                    tol: float = 1e-4, exclude=()) -> dict:
    """Compare two `(scores, stats)` results of the same frames.

    `flips`: {(frame, label id): knife-edge pixels} from `boundary_flips`;
    `mse_threshold`: the ensemble's reconstruction-error vote threshold;
    `exclude`: (frame, label id) cells left out of both results.
    Returns a report
    of the cells compared, those excluded and why, and the largest score
    difference among the compared cells."""
    if exclude:
        ref, got = _drop_cells(ref, set(exclude)), _drop_cells(got, set(exclude))
    (s_ref, t_ref), (s_got, t_got) = ref, got
    for k in ("frame_index", "label_ids"):
        if not np.array_equal(t_ref[k], t_got[k]):
            raise AssertionError(f"cell sets differ in {k}")
    n = len(t_ref["area"])
    cell = list(zip(t_ref["frame_index"].tolist(), t_ref["label_ids"].tolist()))
    flipped = np.array([flips.get(c, 0) for c in cell], np.int64)
    d_area = np.abs(t_ref["area"].astype(np.int64) - t_got["area"].astype(np.int64))
    if np.any(d_area > flipped):
        raise AssertionError("cell areas differ beyond their knife-edge pixels")
    keep = flipped == 0

    near = {}
    for k in ("conservative", "moderate", "fft"):
        near[k] = np.abs(s_ref[f"{k}_scores"]) < tol
    near["ensemble"] = (near["conservative"] | near["moderate"]
                        | (np.abs(s_ref["reconstruction_mse"] - mse_threshold) < tol))
    for k, close in near.items():
        differ = s_ref[f"{k}_predictions"] != s_got[f"{k}_predictions"]
        if np.any(differ & keep & ~close):
            raise AssertionError(f"{k} predictions differ away from the threshold")
    worst = 0.0
    for k in ("reconstruction_mse", "reconstruction_mae", "conservative_scores",
              "moderate_scores", "fft_scores", "fft_features"):
        if keep.any():
            worst = max(worst, float(np.abs(s_ref[k][keep] - s_got[k][keep]).max()))
    if not worst < tol:
        raise AssertionError(f"scores differ by {worst:.3e} >= {tol}")
    return dict(
        n_cells=n,
        knife_edge_cells=[cell[i] for i in np.flatnonzero(~keep)],
        near_threshold={k: [cell[i] for i in np.flatnonzero(v)] for k, v in near.items()},
        max_score_diff=worst,
    )
