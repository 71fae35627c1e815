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
  `score_frames_fused_wait`.  It is `score_frames_fused_wait` of
  `score_frames_fused_start`: the first enqueues segmentation and stage A
  and returns a handle, the second does the host's part, so a caller keeps
  one batch in flight;
- `compute_anomaly_scores`: `score_cells` on host cells, as a dict.

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
from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, size_buckets
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


def score_frames_fused(model, params: ScoringParams, segs: torch.Tensor, greens: torch.Tensor,
                       segment_fn, chunk: int = 256, caps: tuple = (64, 96), min_votes: int = 2,
                       out_size: int = 64, clip_limit: float = 0.02,
                       fallback_segment_fn=None, **candidate_kwargs) -> tuple:
    """Screen a (B, H, W) frame batch on one device; returns (scores dict,
    stats dict) of numpy arrays, as JAX `score_frames_fused_wait`."""
    return score_frames_fused_wait(score_frames_fused_start(
        model, params, segs, greens, segment_fn, chunk=chunk, caps=caps, min_votes=min_votes,
        out_size=out_size, clip_limit=clip_limit, fallback_segment_fn=fallback_segment_fn,
        **candidate_kwargs))


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`; from the card it goes into pinned memory without
    waiting (the caller records an event behind it)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


@torch.inference_mode()
def score_frames_fused_start(model, params: ScoringParams, segs: torch.Tensor,
                             greens: torch.Tensor, segment_fn, chunk: int = 256,
                             caps: tuple = (64, 96), min_votes: int = 2, out_size: int = 64,
                             clip_limit: float = 0.02, fallback_segment_fn=None,
                             **candidate_kwargs) -> dict:
    """The dispatch half of `score_frames_fused`: enqueues segmentation and
    stage A of the batch, begins the copies of the small per-cell arrays
    that the host needs next (overflow flags, heights, widths, valid, the
    statistics) into pinned memory behind a CUDA event, and returns a
    pending handle without waiting for them.  `score_frames_fused_wait`
    takes the handle.  A caller with many batches starts batch k+1 before
    it waits on batch k, so that the host's part of k overlaps the device's
    stage A of k+1."""
    cand, ovf = _stage_a(segment_fn, segs, greens, candidate_kwargs)
    B, ccap, full_cap = cand.crops.shape[:3]
    flat = [t.reshape(-1) for t in (cand.heights, cand.widths, cand.valid, cand.label_ids,
                                    cand.area)]
    ints = _to_host(torch.cat([ovf.reshape(-1).int(), *(t.int() for t in flat)]))
    floats = _to_host(torch.cat([t.reshape(-1).float() for t in (
        cand.eccentricity, cand.mean_intensity, cand.std_intensity)]))
    event = None
    if segs.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(segs.device))
    return dict(
        model=model, params=params, segs0=segs, greens0=greens, chunk=chunk, caps=caps,
        min_votes=min_votes, out_size=out_size, clip_limit=clip_limit,
        fallback_segment_fn=fallback_segment_fn, candidate_kwargs=candidate_kwargs,
        crops=cand.crops.reshape(B * ccap, full_cap, full_cap).float().contiguous(),
        heights=flat[0].int(), widths=flat[1].int(), ints=ints, floats=floats, event=event,
        shape=(B, ccap, full_cap))


@torch.inference_mode()
def score_frames_fused_wait(pend: dict) -> tuple:
    """The fetch half of `score_frames_fused`: waits for the handle's host
    copies, takes the overflow decision (the fallback re-runs the batch
    synchronously), runs the size-bucket loop (CLAHE, resize, `score_cells`)
    and fetches the scored rows once.  Returns (scores dict, stats dict) of
    numpy arrays, as JAX `score_frames_fused_wait`."""
    if pend["event"] is not None:
        pend["event"].synchronize()
    B, ccap, full_cap = pend["shape"]
    N = B * ccap
    ints, floats = pend["ints"], pend["floats"]
    ovf = ints[:B]
    heights_h, widths_h, valid_h, label_ids, area = (ints[B + k * N:B + (k + 1) * N]
                                                     for k in range(5))
    valid_h = valid_h.bool()
    if bool(ovf.any()):
        if pend["fallback_segment_fn"] is not None:
            return score_frames_fused(
                pend["model"], pend["params"], pend["segs0"], pend["greens0"],
                pend["fallback_segment_fn"], chunk=pend["chunk"], caps=pend["caps"],
                min_votes=pend["min_votes"], out_size=pend["out_size"],
                clip_limit=pend["clip_limit"], **pend["candidate_kwargs"])
        warnings.warn(
            "score_frames_fused: capacity overflow with no fallback_segment_fn — "
            "candidate extraction may have dropped or corrupted cells; pass "
            "fallback_segment_fn or raise the capacity (rcap; for the StarDist "
            "backend also max_candidates, raster_m_cap and nms_max_pairs)",
            RuntimeWarning, stacklevel=2)

    crops, heights, widths = pend["crops"], pend["heights"], pend["widths"]
    dev = crops.device
    chunk = pend["chunk"]
    rows = torch.zeros((N, _FUSED_D), dtype=torch.float32, device=dev)
    # the buckets come from the host copies: no wait on the device for them
    for idx, cap_b, ns_cap in size_buckets(heights_h, widths_h, valid_h, pend["caps"], full_cap):
        if idx.numel() == 0:
            continue
        idx = idx.to(dev, non_blocking=True)
        eq_all = clahe_bucket(crops, idx.int(), heights, widths, cap_b,
                              clip_limit=pend["clip_limit"], ns_cap=ns_cap)
        for start in range(0, idx.numel(), chunk):
            ids = idx[start:start + chunk]
            eq = eq_all[start:start + chunk]
            cells = resize_cells(eq, heights[ids], widths[ids], out_size=pend["out_size"])
            rows[ids] = _score_rows(score_cells(pend["model"], pend["params"], cells[..., None],
                                                min_votes=pend["min_votes"]))

    pool = torch.nonzero(valid_h).flatten()
    stats_h = dict(label_ids=label_ids, area=area, eccentricity=floats[:N],
                   mean_intensity=floats[N:2 * N], std_intensity=floats[2 * N:])
    stats = {k: v[pool].numpy() for k, v in stats_h.items()}
    stats["frame_index"] = (pool // ccap).numpy()
    packed = rows[pool.to(dev, non_blocking=True)].cpu().numpy()   # the one fetch
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


_SCORE_KEYS = ("reconstruction_mse", "reconstruction_mae", "conservative_predictions",
               "moderate_predictions", "conservative_scores", "moderate_scores",
               "ensemble_predictions", "fft_predictions", "fft_scores")


def compute_anomaly_scores(model, params: ScoringParams, cells, valid=None,
                           min_votes: int = 2) -> dict:
    """`score_cells` on (n, 64, 64) or (n, 64, 64, 1) host cells, on the
    device of `params`, as a dict of numpy arrays with the reference's
    schema plus the ensemble and FFT entries.  `valid` optionally masks
    padding; rates are over the valid entries only."""
    X = torch.as_tensor(np.asarray(cells, dtype=np.float32), device=params.pca_mean.device)
    if X.dim() == 3:
        X = X[..., None]
    if X.shape[0] == 0:
        return {}
    s = score_cells(model, params, X, min_votes=min_votes)
    v = np.ones(X.shape[0], bool) if valid is None else np.asarray(valid, bool)
    n = max(int(v.sum()), 1)
    out = {k: getattr(s, k).cpu().numpy()[v] for k in _SCORE_KEYS}
    out["fft_features"] = s.fft.cpu().numpy()[v]
    for name in ("conservative", "moderate", "ensemble", "fft"):
        pred = getattr(s, f"{name}_predictions").cpu().numpy()
        out[f"{name}_anomaly_rate"] = float(np.sum((pred == -1) & v) / n)
    return out
