"""Anomaly scoring and fused frame screening.

Counterpart of `cell_image_analysis_tpu/pipeline/scoring.py`:

- `score_cells`: CAE forward, reconstruction MSE/MAE, RobustScaler, PCA,
  the conservative and moderate RBF SVMs, the ensemble vote, the FFT
  features and the FFT SVM, for a (B, 64, 64, 1) batch of cells;
- `score_frames_fused`: the screening of a frame batch on one device —
  segmentation, stage A, size buckets (caps 64 and 96 at ns_cap 12, the
  full crop capacity at ns_cap 16), CLAHE -> resize -> `score_cells` per
  chunk — returning the same `(scores, stats)` pair as the JAX
  `score_frames_fused_wait`.

The JAX pipeline re-runs a batch through an exact twin (scatter
rasterizer, K^2 NMS pairs, pixel regionprops) when a capacity flag fires.
That twin is not ported yet, so here any such flag raises
`CapacityOverflowError`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cell_image_analysis_tpu_torch.models.svm import SVMParams, decision_function
from cell_image_analysis_tpu_torch.ops.clahe import NS_CAP, NS_CAP_16PX, clahe_cells
from cell_image_analysis_tpu_torch.ops.extract import extract_candidates_from_labels_runs
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


class CapacityOverflowError(RuntimeError):
    """A capacity flag fired whose exact re-run twin is not ported."""


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


def _raise_on_overflow(seg_ovf: torch.Tensor, run_ovf: torch.Tensor) -> None:
    seg_any, run_any = bool(seg_ovf.any()), bool(run_ovf.any())
    if not (seg_any or run_any):
        return
    frames = torch.nonzero(seg_ovf | run_ovf).flatten().tolist()
    what = []
    if seg_any:
        what.append("a segmentation capacity (tiled raster m_cap, NMS pair budget or "
                    "max_candidates) -> the scatter rasterizer / K^2 NMS twin")
    if run_any:
        what.append("the run-table rcap -> the pixel regionprops twin")
    raise CapacityOverflowError(
        f"score_frames_fused: capacity overflow in frames {frames}: {'; '.join(what)}. "
        "The exact overflow twin is not ported yet; raise the capacity instead.")


@torch.inference_mode()
def score_frames_fused(model, params: ScoringParams, segs: torch.Tensor, greens: torch.Tensor,
                       segment_fn, chunk: int = 256, caps: tuple = (64, 96), min_votes: int = 2,
                       out_size: int = 64, clip_limit: float = 0.02,
                       **candidate_kwargs) -> tuple:
    """Screen a (B, H, W) frame batch on one device; returns (scores dict,
    stats dict) of numpy arrays, as JAX `score_frames_fused_wait`."""
    labels, seg_ovf = segment_fn(segs)
    cand, run_ovf = extract_candidates_from_labels_runs(labels, greens, **candidate_kwargs)
    _raise_on_overflow(seg_ovf, run_ovf)

    B, ccap, full_cap = cand.crops.shape[:3]
    N = B * ccap
    crops = cand.crops.reshape(N, full_cap, full_cap)
    heights = cand.heights.reshape(-1)
    widths = cand.widths.reshape(-1)
    valid = cand.valid.reshape(-1)

    # size buckets: the tightest capacity that fits; cells with a side of
    # 13-15 px need 13-15 tiles on that axis, so they ride the last bucket
    all_caps = tuple(c for c in sorted(caps) if c < full_cap) + (full_cap,)
    ns_ok = (((heights >= 16) | (heights <= 12)) & ((widths >= 16) | (widths <= 12)))
    buckets = []
    fits_prev = torch.zeros_like(valid)
    for cap_b in all_caps[:-1]:
        fits = (heights <= cap_b) & (widths <= cap_b) & ns_ok
        buckets.append((valid & fits & ~fits_prev, cap_b, NS_CAP_16PX))
        fits_prev = fits
    buckets.append((valid & ~fits_prev, all_caps[-1], NS_CAP))

    rows = torch.zeros((N, _FUSED_D), dtype=torch.float32, device=crops.device)
    for mask, cap_b, ns_cap in buckets:
        idx = torch.nonzero(mask).flatten()
        for start in range(0, idx.numel(), chunk):
            ids = idx[start:start + chunk]
            c = crops[ids][:, :cap_b, :cap_b]
            h, w = heights[ids], widths[ids]
            eq = clahe_cells(c, h, w, clip_limit=clip_limit, ns_cap=ns_cap)
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
