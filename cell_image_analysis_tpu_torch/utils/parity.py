"""Parity: the port's screening against the reference stack, and two
screenings of the same frames against each other.

Counterpart of `cell_image_analysis_tpu/utils/parity.py`.

`measure_parity` is the north-star correctness measurement: the same
synthetic frames through the fused device pipeline (`score_frames_fused`
on the card, at the JAX harness's settings) and through the CPU reference
stack, library for library as the reference (improved_detection.py:48-153)
runs it, and the largest absolute anomaly-rate deviation between the two,
to be held below 1e-3 over identical cell sets:

- segmentation: the scipy percentile-threshold oracle (threshold backend),
  or for StarDist the port's `StarDistUNet` over the same weights in
  float64 on the CPU with plain `F.conv2d`, then the numpy greedy star-NMS
  and rasterize oracle (`ops/oracle/stardist_np`, 256 candidates).  JAX
  runs a Keras/TF twin of the U-Net there; the card's machine has no
  TensorFlow;
- regionprops + QC: `ops/oracle/regionprops_np`; CLAHE: `ops/oracle/clahe_np`;
  resize: scipy gaussian + zoom;
- CAE forward: the port's `CAE` over the same weights in float64 on the
  CPU (JAX: Keras where importable, else flax);
- scaler, PCA and SVM decisions in float64 numpy (libsvm's closed form
  sum_i alpha_i K(x, sv_i) - rho), the FFT features in float64 numpy, and
  the same >= min_votes ensemble rule.

Rates are fractions over identical cell sets, so a deviation below 1e-3
means the two paths flag the same cells.

`compare_screens` compares two `score_frames_fused` results — the port
against the JAX package, or the port on the GPU against the port on the
CPU — and says where they may differ and where they did.  Two kinds of
decision may legitimately flip between float32 implementations that sum
in different orders, and both are reported:

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

import copy

import numpy as np
import torch

from cell_image_analysis_tpu_torch.ops.nms import radius_at

KNIFE_EDGE_PX = 1e-3
ORACLE_MAX_CANDIDATES = 256


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


# ------------------------------------------------------ the reference stack --

def oracle_extract_cells(frame: np.ndarray, segment=None) -> np.ndarray:
    """Reference-stack oracle extraction for one (H, W, 3) frame:
    normalize -> segment -> QC -> CLAHE -> resize.  `segment` maps the
    percentile-normalized seg channel to an int label map; default is the
    scipy threshold backend.  Returns (N, 64, 64) float32 cells (reference
    extract_quality_cells, CAE_improved_modeltrain.py:39-111)."""
    from scipy import ndimage as ndi

    from cell_image_analysis_tpu_torch.ops.oracle.clahe_np import equalize_adapthist_np
    from cell_image_analysis_tpu_torch.ops.oracle.regionprops_np import regionprops_np

    seg = frame[..., 2].astype(np.float64)
    green = frame[..., 1].astype(np.float64)
    lo, hi = np.percentile(seg, 3), np.percentile(seg, 99.8)
    norm = (seg - lo) / (hi - lo + 1e-20)
    if segment is not None:
        labels = segment(norm)
    else:
        thresh = np.percentile(norm, 90.0)
        mask = ndi.binary_opening(norm > thresh)
        labels, _ = ndi.label(mask)
    h, w = labels.shape

    def resize_oracle(img, out=64):
        factors = np.array([img.shape[0] / out, img.shape[1] / out])
        sigma = np.maximum(0.0, (factors - 1.0) / 2.0)
        x = img.astype(np.float64)
        if np.any(sigma > 0):
            x = ndi.gaussian_filter(x, sigma, mode="mirror")
        return ndi.zoom(x, (out / img.shape[0], out / img.shape[1]), order=1,
                        mode="mirror", grid_mode=True)

    cells = []
    for p in regionprops_np(labels, green):
        minr, minc, maxr, maxc = p["bbox"]
        if minr < 10 or minc < 10 or maxr > h - 10 or maxc > w - 10:
            continue
        if p["area"] < 200 or p["area"] > 8000 or p["eccentricity"] > 0.95:
            continue
        crop = green[minr:maxr, minc:maxc]
        if crop.mean() < 0.5 or crop.std() < 0.1:
            continue
        cells.append(resize_oracle(equalize_adapthist_np(crop)))
    if not cells:
        return np.zeros((0, 64, 64), np.float32)
    return np.stack(cells).astype(np.float32)


def oracle_stardist_segment(unet_variables=None):
    """The StarDist oracle segmentation: normalized seg channel (H, W),
    sides multiples of 8 -> int32 labels.  The port's `StarDistUNet` over
    `unet_variables` (default: the committed U-Net) in float64 on the CPU
    (its 3x3 convs take the plain `F.conv2d` there), both heads over every
    grid pixel, then `predict_instances_np` at 256 candidates."""
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables, unet_state_from_jax
    from cell_image_analysis_tpu_torch.models.unet import StarDistUNet
    from cell_image_analysis_tpu_torch.ops.oracle.stardist_np import predict_instances_np

    cfg = SegConfig()
    model = StarDistUNet(n_rays=cfg.n_rays, depth=cfg.unet_depth, base_filters=cfg.base_filters,
                         head_filters=cfg.head_filters, grid=cfg.grid)
    model.load_state_dict(unet_state_from_jax(
        unet_variables if unet_variables is not None else load_unet_variables()))
    model = model.double().eval()

    def segment(norm: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(norm, np.float64))[None, :, :, None]
        with torch.no_grad():
            prob, dist = model.forward_train(x)
        labels, _ = predict_instances_np(prob[0].numpy(), dist[0].numpy(), grid=cfg.grid,
                                         prob_thresh=cfg.prob_thresh,
                                         nms_thresh=cfg.nms_thresh,
                                         max_candidates=ORACLE_MAX_CANDIDATES)
        return labels

    return segment


def fft_features_np(cells: np.ndarray, radial_bins=16, angular_bins=8) -> np.ndarray:
    """float64 numpy mirror of ops/fft_features.fft_features."""
    b, h, w = cells.shape
    x = cells.astype(np.float64)
    F = np.fft.fftshift(np.fft.fft2(x), axes=(-2, -1))
    power = np.abs(F) ** 2
    cy, cx = h // 2, w // 2
    yy = (np.arange(h) - cy)[:, None].astype(np.float64)
    xx = (np.arange(w) - cx)[None, :].astype(np.float64)
    r = np.sqrt(yy * yy + xx * xx)
    r_norm = r / (min(h, w) / 2.0)
    theta = np.arctan2(yy, xx) % np.pi
    ac = np.where((r == 0.0)[None], 0.0, power)
    total = np.maximum(ac.sum(axis=(-2, -1)), 1e-20)
    r_bin = np.clip((r_norm * radial_bins).astype(np.int64), 0, radial_bins - 1)
    radial = np.stack([
        np.where(r_bin[None] == k, ac, 0.0).sum(axis=(-2, -1)) for k in range(radial_bins)
    ], axis=1) / total[:, None]
    a_bin = np.clip((theta / np.pi * angular_bins).astype(np.int64), 0, angular_bins - 1)
    angular = np.stack([
        np.where(a_bin[None] == k, ac, 0.0).sum(axis=(-2, -1)) for k in range(angular_bins)
    ], axis=1) / total[:, None]
    centroid = (ac * r_norm[None]).sum(axis=(-2, -1)) / total
    high = np.where(r_norm[None] > 0.5, ac, 0.0).sum(axis=(-2, -1)) / total
    tp = np.log10(total)
    return np.concatenate([radial, angular, centroid[:, None], high[:, None],
                           tp[:, None]], axis=1)


def _svm_decision_np(svm, X64: np.ndarray) -> np.ndarray:
    sv = np.asarray(svm.support_vectors_, np.float64)
    alpha = np.asarray(svm.dual_coef_, np.float64).reshape(-1)
    gamma = float(svm.gamma_)
    d2 = ((X64[:, None, :] - sv[None, :, :]) ** 2).sum(-1)
    return np.exp(-gamma * d2) @ alpha + float(svm.intercept_)


def _cae_forward_f64(model, X: np.ndarray) -> tuple:
    """(reconstructions, encoded) of (N, 64, 64, 1) cells through a float64
    copy of the CAE `model` on the CPU, in eval mode."""
    net = copy.deepcopy(model).to("cpu", torch.float64).eval()
    with torch.no_grad():
        recon, enc = net(torch.as_tensor(X, dtype=torch.float64))
    return recon.numpy(), enc.numpy()


def oracle_score(cells: np.ndarray, host: dict, min_votes: int = 2) -> dict:
    """Reference-stack scoring of (N, 64, 64) cells with the fitted host
    estimators of `utils/bench._fit_params` (improved_detection.py:117-153
    conventions); the CAE runs in float64 on the CPU.  Returns predictions
    and rates per detector."""
    X = cells[..., None].astype(np.float32)
    recon, enc = _cae_forward_f64(host["model"], X)

    diff = X.astype(np.float64) - recon.astype(np.float64)
    mse = (diff ** 2).mean(axis=(1, 2, 3))
    feats = enc.reshape(enc.shape[0], -1).astype(np.float64)
    scaled = (feats - np.asarray(host["scaler"].center_, np.float64)) / \
        np.asarray(host["scaler"].scale_, np.float64)
    reduced = (scaled - np.asarray(host["pca"].mean_, np.float64)) @ \
        np.asarray(host["pca"].components_, np.float64).T

    out = {"n_cells": len(cells), "mse": mse}
    for name, svm in (("conservative", host["cons"]), ("moderate", host["mod"])):
        d = _svm_decision_np(svm, reduced)
        pred = np.where(d > 0, 1, -1)
        out[f"{name}_predictions"] = pred
        out[f"{name}_anomaly_rate"] = float((pred == -1).mean()) if len(pred) else 0.0
    votes = ((mse > float(host["ens"].mse_threshold)).astype(int)
             + (out["conservative_predictions"] == -1).astype(int)
             + (out["moderate_predictions"] == -1).astype(int))
    ens = np.where(votes >= min_votes, -1, 1)
    out["ensemble_predictions"] = ens
    out["ensemble_anomaly_rate"] = float((ens == -1).mean()) if len(ens) else 0.0
    if "fft_scaler" in host and "fft_det" in host:
        f = fft_features_np(cells)
        fs = (f - np.asarray(host["fft_scaler"].center_, np.float64)) / \
            np.asarray(host["fft_scaler"].scale_, np.float64)
        d = _svm_decision_np(host["fft_det"], fs)
        pred = np.where(d > 0, 1, -1)
        out["fft_predictions"] = pred
        out["fft_anomaly_rate"] = float((pred == -1).mean()) if len(pred) else 0.0
    return out


def measure_parity(n_frames: int = 4, size: int = 512, n_cells: int = 30, seed: int = 11,
                   backend: str = "threshold", fit_on_extracted: bool = False,
                   device=None) -> dict:
    """The same synthetic frames through `score_frames_fused` on `device`
    (default: the card) and through the CPU reference stack; per-detector
    rates and the largest absolute rate deviation (the north star).

    backend="stardist" runs the StarDist stack on both sides: the bench's
    `StarDistBackend` (its exact twin as the fallback, rcap 64) against
    the float64 U-Net oracle (`oracle_stardist_segment`).

    fit_on_extracted=True fits the detectors on cells oracle-extracted from
    eight other frames of the same generator (seed + 7919), so the test
    cells score near nu instead of saturating: many cells then sit near
    the SVM boundary, and the deviation check is as sensitive to numeric
    drift as it gets.  Otherwise the committed scoring fit is used."""
    from cell_image_analysis_tpu_torch.io.artifacts import resolve_device
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.utils.bench import (
        _fit_params,
        _make_frames,
        stardist_backend,
    )

    dev = resolve_device(device)
    fit_X = None
    if fit_on_extracted:
        fit_frames = _make_frames(8, size, n_cells, seed=seed + 7919)
        fit_cells = np.concatenate([oracle_extract_cells(f) for f in fit_frames], axis=0)
        if len(fit_cells) < 65:
            raise ValueError(f"only {len(fit_cells)} fit cells; PCA(64) needs >= 65")
        fit_X = fit_cells[..., None].astype(np.float32)
    model, params, host = _fit_params(X=fit_X, device=dev)
    frames = _make_frames(n_frames, size, n_cells, seed=seed)
    stack = np.stack(frames)
    segs = torch.tensor(stack[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(stack[..., 1].astype(np.float32), device=dev)
    common = dict(chunk=32, caps=(64, 96), cell_capacity=128)

    oracle_segment = None
    if backend == "stardist":
        sd = stardist_backend(device=dev)
        scores, stats = score_frames_fused(model, params, segs, greens, sd,
                                           fallback_segment_fn=sd.exact_twin(), rcap=64,
                                           label_capacity=sd.cfg.raster_cap, **common)
        oracle_segment = oracle_stardist_segment()
    elif backend == "threshold":
        th = ThresholdBackend()
        scores, stats = score_frames_fused(model, params, segs, greens, th,
                                           fallback_segment_fn=th.exact_twin(),
                                           label_capacity=4096, fg_fraction=0.12, **common)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    dev_rates = {"n_cells": len(stats["area"])}
    for d in ("conservative", "moderate", "ensemble", "fft"):
        dev_rates[f"{d}_anomaly_rate"] = float(
            (np.asarray(scores[f"{d}_predictions"]) == -1).mean())

    cells = [oracle_extract_cells(f, segment=oracle_segment) for f in frames]
    cells = np.concatenate([c for c in cells if len(c)], axis=0)
    ref = oracle_score(cells, host)

    detectors = ["conservative", "moderate", "ensemble"]
    if "fft_anomaly_rate" in ref:
        detectors.append("fft")
    deviations = {d: abs(dev_rates[f"{d}_anomaly_rate"] - ref[f"{d}_anomaly_rate"])
                  for d in detectors}
    return {
        "device": dev_rates,
        "reference": {k: v for k, v in ref.items() if k.endswith("rate") or k == "n_cells"},
        "deviations": deviations,
        "max_deviation": max(deviations.values()),
        "cell_count_match": dev_rates["n_cells"] == ref["n_cells"],
    }
