"""Anomaly scoring and fused frame screening.

Counterpart of `cell_image_analysis_tpu/pipeline/scoring.py`:

- `score_cells`: CAE forward, reconstruction MSE/MAE, RobustScaler, PCA,
  the conservative and moderate RBF SVMs, the ensemble vote, the FFT
  features and the FFT SVM, for a (B, 64, 64, 1) batch of cells;
- `score_frames_fused`: the screening of a frame batch on one device —
  segmentation, stage A, size buckets (`size_buckets`: caps 64 and 96 at
  ns_cap 12, the full crop capacity at ns_cap 16), CLAHE once a bucket
  (one kernel launch on the GPU), then resize -> `score_cells` per chunk
  of it — returning the same `(scores, stats)` pair as the JAX
  `score_frames_fused_wait`.

Stage A takes one of JAX `_stage_a_one`'s three routes, by the
segment_fn's flags: boolean masks (`returns_mask`) through the run-length
connected components, label maps with `runs_props` through the run-length
regionprops, other label maps through the pixel regionprops.  When a
capacity flag fires in any frame (a run table's `rcap`, or a flag the
segment_fn returns with `returns_overflow`), the whole batch re-runs
through `fallback_segment_fn`, the exact twin; without one the port warns
as JAX does.  The port checks the flags before stage B, JAX after it: the
result is the same.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from cell_image_analysis_tpu_torch.models.svm import SVMParams, decision_function
from cell_image_analysis_tpu_torch.ops.clahe import NS_CAP, NS_CAP_16PX, clahe_bucket
from cell_image_analysis_tpu_torch.ops.extract import (
    extract_candidates,
    extract_candidates_from_labels_runs,
    extract_candidates_from_mask,
)
from cell_image_analysis_tpu_torch.ops.fft_features import fft_features
from cell_image_analysis_tpu_torch.ops.resize import resize_cells


class ScoringParams(NamedTuple):
    """The fitted scoring state (the CAE module is passed separately)."""

    scaler_center: torch.Tensor          # (2048,)
    scaler_scale: torch.Tensor           # (2048,)
    pca_mean: torch.Tensor               # (2048,)
    pca_components: torch.Tensor         # (K, 2048)
    svm_conservative: SVMParams
    svm_moderate: SVMParams
    ensemble_mse_threshold: torch.Tensor  # ()
    fft_scaler_center: torch.Tensor      # (F,)
    fft_scaler_scale: torch.Tensor       # (F,)
    svm_fft: SVMParams


class CellScores(NamedTuple):
    reconstruction_mse: torch.Tensor
    reconstruction_mae: torch.Tensor
    conservative_predictions: torch.Tensor  # int32 {+1, -1}
    moderate_predictions: torch.Tensor
    conservative_scores: torch.Tensor       # negated decision function
    moderate_scores: torch.Tensor
    ensemble_predictions: torch.Tensor
    fft_predictions: torch.Tensor
    fft_scores: torch.Tensor
    fft: torch.Tensor                       # (B, F)


def _pm1(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d > 0, 1, -1).int()


@torch.inference_mode()
def score_cells(model, params: ScoringParams, X: torch.Tensor, min_votes: int = 2) -> CellScores:
    """Score a (B, 64, 64, 1) batch of preprocessed cells."""
    X = X.float()
    recon, encoded = model(X)
    diff = X - recon
    mse = torch.mean(diff * diff, dim=(1, 2, 3))
    mae = torch.mean(torch.abs(diff), dim=(1, 2, 3))

    feats = encoded.reshape(encoded.shape[0], -1)
    scaled = (feats - params.scaler_center) / params.scaler_scale
    reduced = torch.matmul(scaled - params.pca_mean, params.pca_components.T)
    d_cons = decision_function(params.svm_conservative, reduced)
    d_mod = decision_function(params.svm_moderate, reduced)
    p_cons, p_mod = _pm1(d_cons), _pm1(d_mod)
    votes = ((mse > params.ensemble_mse_threshold).int() + (p_cons == -1).int()
             + (p_mod == -1).int())
    p_ens = torch.where(votes >= min_votes, -1, 1).int()

    fft = fft_features(X)
    d_fft = decision_function(params.svm_fft,
                              (fft - params.fft_scaler_center) / params.fft_scaler_scale)
    return CellScores(
        reconstruction_mse=mse, reconstruction_mae=mae,
        conservative_predictions=p_cons, moderate_predictions=p_mod,
        conservative_scores=-d_cons, moderate_scores=-d_mod,
        ensemble_predictions=p_ens, fft_predictions=_pm1(d_fft), fft_scores=-d_fft,
        fft=fft,
    )


_FUSED_D = 9 + 16 + 8 + 3


def _score_rows(s: CellScores) -> torch.Tensor:
    cols = [s.reconstruction_mse, s.reconstruction_mae, s.conservative_predictions,
            s.moderate_predictions, s.conservative_scores, s.moderate_scores,
            s.ensemble_predictions, s.fft_predictions, s.fft_scores]
    return torch.cat([torch.stack([c.float() for c in cols], dim=1), s.fft], dim=1)


def _stage_a(segment_fn, segs: torch.Tensor, greens: torch.Tensor, candidate_kwargs: dict):
    """Segmentation and stage-A candidates of a batch by the segment_fn's
    route; returns (Candidates, overflow (B,))."""
    kw = dict(candidate_kwargs)
    out = segment_fn(segs)
    seg_ovf = None
    if getattr(segment_fn, "returns_overflow", False):
        out, seg_ovf = out
    if getattr(segment_fn, "returns_mask", False):
        kw.pop("fg_fraction", None)
        cand, ovf = extract_candidates_from_mask(out, greens, **kw)
    elif getattr(segment_fn, "runs_props", False):
        kw.pop("fg_fraction", None)
        kw.pop("connectivity", None)
        cand, ovf = extract_candidates_from_labels_runs(out, greens, **kw)
    else:
        kw.pop("rcap", None)
        kw.pop("connectivity", None)
        cand = extract_candidates(out, greens, **kw)
        ovf = torch.zeros(segs.shape[0], dtype=torch.bool, device=segs.device)
    if seg_ovf is not None:
        ovf = ovf | seg_ovf
    return cand, ovf


def size_buckets(heights: torch.Tensor, widths: torch.Tensor, valid: torch.Tensor,
                 caps: tuple, full_cap: int) -> list:
    """The CLAHE size buckets of the (N,) cells: [(cell indices, cap,
    ns_cap)], each cell in the tightest capacity that fits; cells with a
    side of 13-15 px need 13-15 tiles on that axis, so they ride the last
    bucket (the full crop capacity, ns_cap 16)."""
    all_caps = tuple(c for c in sorted(caps) if c < full_cap) + (full_cap,)
    ns_ok = (((heights >= 16) | (heights <= 12)) & ((widths >= 16) | (widths <= 12)))
    buckets = []
    fits_prev = torch.zeros_like(valid)
    for cap_b in all_caps[:-1]:
        fits = (heights <= cap_b) & (widths <= cap_b) & ns_ok
        buckets.append((valid & fits & ~fits_prev, cap_b, NS_CAP_16PX))
        fits_prev = fits
    buckets.append((valid & ~fits_prev, all_caps[-1], NS_CAP))
    return [(torch.nonzero(mask).flatten(), cap_b, ns_cap) for mask, cap_b, ns_cap in buckets]


@torch.inference_mode()
def score_frames_fused(model, params: ScoringParams, segs: torch.Tensor, greens: torch.Tensor,
                       segment_fn, chunk: int = 256, caps: tuple = (64, 96), min_votes: int = 2,
                       out_size: int = 64, clip_limit: float = 0.02,
                       fallback_segment_fn=None, **candidate_kwargs) -> tuple:
    """Screen a (B, H, W) frame batch on one device; returns (scores dict,
    stats dict) of numpy arrays, as JAX `score_frames_fused_wait`."""
    cand, ovf = _stage_a(segment_fn, segs, greens, candidate_kwargs)
    if bool(ovf.any()):
        if fallback_segment_fn is not None:
            return score_frames_fused(model, params, segs, greens, fallback_segment_fn,
                                      chunk=chunk, caps=caps, min_votes=min_votes,
                                      out_size=out_size, clip_limit=clip_limit,
                                      **candidate_kwargs)
        warnings.warn(
            "score_frames_fused: capacity overflow with no fallback_segment_fn — "
            "candidate extraction may have dropped or corrupted cells; pass "
            "fallback_segment_fn or raise the capacity (rcap; for the StarDist "
            "backend also max_candidates, raster_m_cap and nms_max_pairs)",
            RuntimeWarning, stacklevel=2)

    B, ccap, full_cap = cand.crops.shape[:3]
    N = B * ccap
    crops = cand.crops.reshape(N, full_cap, full_cap).float().contiguous()
    heights = cand.heights.reshape(-1).int()
    widths = cand.widths.reshape(-1).int()
    valid = cand.valid.reshape(-1)

    rows = torch.zeros((N, _FUSED_D), dtype=torch.float32, device=crops.device)
    for idx, cap_b, ns_cap in size_buckets(heights, widths, valid, caps, full_cap):
        if idx.numel() == 0:
            continue
        eq_all = clahe_bucket(crops, idx.int(), heights, widths, cap_b, clip_limit=clip_limit,
                              ns_cap=ns_cap)
        for start in range(0, idx.numel(), chunk):
            ids = idx[start:start + chunk]
            eq = eq_all[start:start + chunk]
            h, w = heights[ids], widths[ids]
            cells = resize_cells(eq, h, w, out_size=out_size)
            rows[ids] = _score_rows(score_cells(model, params, cells[..., None],
                                                min_votes=min_votes))

    pool = torch.nonzero(valid).flatten()
    stats_t = dict(label_ids=cand.label_ids, area=cand.area, eccentricity=cand.eccentricity,
                   mean_intensity=cand.mean_intensity, std_intensity=cand.std_intensity)
    stats = {k: v.reshape(-1)[pool].cpu().numpy() for k, v in stats_t.items()}
    stats["label_ids"] = stats["label_ids"].astype(np.int32)
    stats["area"] = stats["area"].astype(np.int32)
    stats["frame_index"] = (pool // ccap).cpu().numpy()
    packed = rows[pool].cpu().numpy()
    if packed.shape[0] == 0:
        return {}, stats
    out = {
        "reconstruction_mse": packed[:, 0],
        "reconstruction_mae": packed[:, 1],
        "conservative_predictions": packed[:, 2].astype(np.int32),
        "moderate_predictions": packed[:, 3].astype(np.int32),
        "conservative_scores": packed[:, 4],
        "moderate_scores": packed[:, 5],
        "ensemble_predictions": packed[:, 6].astype(np.int32),
        "fft_predictions": packed[:, 7].astype(np.int32),
        "fft_scores": packed[:, 8],
        "fft_features": packed[:, 9:],
    }
    for name in ("conservative", "moderate", "ensemble", "fft"):
        out[f"{name}_anomaly_rate"] = float(np.mean(out[f"{name}_predictions"] == -1))
    return out, stats
