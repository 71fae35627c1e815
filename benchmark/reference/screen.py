"""The reference screening of a batch of frames, plain PyTorch, NumPy and SciPy.

What `Reference.screen` works out again from the raw frames and the two
weight files, frame by frame:

1. segmentation: the configuration's backend's `backends/<backend>/reference.py`
   (StarDist and threshold: `segment.py`);
2. stage A: per label (1..label_capacity) the area, bounding box and
   eccentricity (from the central second moments); geometric QC (a
   `border_margin` from every edge, area in [min_area, max_area],
   eccentricity <= max_eccentricity); the first `cell_capacity` passing
   labels in ascending order; a bounding box within `crop_capacity`; the
   raw green crop's mean >= min_mean_intensity and standard deviation
   (ddof 0) >= min_std_intensity;
3. each cell's crop through CLAHE (`clahe_np`, clip 0.02) and the
   anti-aliased resize to 64 x 64 (SciPy: Gaussian pre-filter of sigma
   max(0, (s - 1) / 2) per axis, mirror boundary, then order-1 zoom in
   grid mode), as skimage's `resize(..., anti_aliasing=True)`;
4. scoring: the CAE (`models.CAE`, float32 on the device), reconstruction
   MSE and MAE, RobustScaler, PCA and the two RBF one-class SVMs and the
   FFT features and their SVM in float64, the ensemble vote.

The result has the program's layout: (scores dict, stats dict) of numpy
arrays, one row a cell, frame-major and label-ascending.  No module of the
program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import backends
from benchmark.reference.clahe_np import equalize_adapthist_np
from benchmark.reference.models import CAE, checked_weights, load_scoring, tf32

STAT_KEYS = ("label_ids", "area", "eccentricity", "mean_intensity", "std_intensity",
             "frame_index")


def regionprops(labels: np.ndarray, capacity: int) -> dict:
    """Per label 1..n (n = min(max label, capacity)): area, bbox (min row,
    min col, max row, max col; max exclusive), eccentricity; float64."""
    n = int(min(labels.max(initial=0), capacity))
    rr, cc = np.nonzero((labels > 0) & (labels <= n))
    lab = labels[rr, cc] - 1
    cnt = np.bincount(lab, minlength=n).astype(np.float64)
    out = dict(area=cnt.astype(np.int64))
    big = np.iinfo(np.int64).max
    for name, vals, fn, init in (("min_r", rr, np.minimum, big), ("min_c", cc, np.minimum, big),
                                 ("max_r", rr + 1, np.maximum, -1),
                                 ("max_c", cc + 1, np.maximum, -1)):
        acc = np.full(n, init, np.int64)
        fn.at(acc, lab, vals)
        out[name] = acc
    a = np.maximum(cnt, 1.0)
    r, c = rr.astype(np.float64), cc.astype(np.float64)
    mr = np.bincount(lab, r, n) / a
    mc = np.bincount(lab, c, n) / a
    dr, dc = r - mr[lab], c - mc[lab]
    mu20 = np.bincount(lab, dr * dr, n) / a
    mu02 = np.bincount(lab, dc * dc, n) / a
    mu11 = np.bincount(lab, dr * dc, n) / a
    t = (mu20 + mu02) / 2.0
    d = np.sqrt(((mu20 - mu02) / 2.0) ** 2 + mu11 ** 2)
    l1, l2 = t + d, t - d
    out["eccentricity"] = np.where(l1 > 0, np.sqrt(np.clip(1.0 - l2 / np.where(l1 > 0, l1, 1.0),
                                                           0.0, 1.0)), 0.0)
    return out


def stage_a(labels: np.ndarray, green: np.ndarray, qc: dict, fused: dict) -> list:
    """The cells of one frame: [(label id, area, ecc, mean, std, crop)]."""
    h, w = labels.shape
    p = regionprops(labels, fused["label_capacity"])
    m = qc["border_margin"]
    geo = ((p["area"] > 0) & (p["min_r"] >= m) & (p["min_c"] >= m)
           & (p["max_r"] <= h - m) & (p["max_c"] <= w - m)
           & (p["area"] >= qc["min_area"]) & (p["area"] <= qc["max_area"])
           & (p["eccentricity"] <= qc["max_eccentricity"]))
    cells = []
    for i in np.flatnonzero(geo)[:fused["cell_capacity"]]:
        r0, c0, r1, c1 = (int(p[k][i]) for k in ("min_r", "min_c", "max_r", "max_c"))
        if r1 - r0 > qc["crop_capacity"] or c1 - c0 > qc["crop_capacity"]:
            continue
        crop = green[r0:r1, c0:c1]
        mean, std = crop.mean(), crop.std()
        if mean >= qc["min_mean_intensity"] and std >= qc["min_std_intensity"]:
            cells.append((i + 1, int(p["area"][i]), float(p["eccentricity"][i]), mean, std, crop))
    return cells


def resize(img: np.ndarray, out: int) -> np.ndarray:
    """skimage's anti-aliased order-1 resize to (out, out), float64."""
    from scipy import ndimage as ndi

    factors = np.array(img.shape, np.float64) / out
    sigma = np.maximum(0.0, (factors - 1.0) / 2.0)
    x = img.astype(np.float64)
    if np.any(sigma > 0):
        x = ndi.gaussian_filter(x, sigma, mode="mirror", truncate=4.0)
    return ndi.zoom(x, (out / img.shape[0], out / img.shape[1]), order=1, mode="mirror",
                    grid_mode=True)


def fft_features(cells: np.ndarray, radial_bins: int, angular_bins: int) -> np.ndarray:
    """Per cell: the AC power's fractions in `radial_bins` rings and
    `angular_bins` sectors of the shifted 2-D FFT, its centroid radius,
    its fraction beyond half the radius and log10 of its total; float64."""
    b, h, w = cells.shape
    power = np.abs(np.fft.fftshift(np.fft.fft2(cells.astype(np.float64)), axes=(-2, -1))) ** 2
    yy = (np.arange(h) - h // 2)[:, None].astype(np.float64)
    xx = (np.arange(w) - w // 2)[None, :].astype(np.float64)
    r = np.sqrt(yy * yy + xx * xx)
    r_norm = r / (min(h, w) / 2.0)
    theta = np.arctan2(yy, xx) % np.pi
    ac = np.where((r == 0.0)[None], 0.0, power)
    total = np.maximum(ac.sum(axis=(-2, -1)), 1e-20)
    r_bin = np.clip((r_norm * radial_bins).astype(np.int64), 0, radial_bins - 1)
    a_bin = np.clip((theta / np.pi * angular_bins).astype(np.int64), 0, angular_bins - 1)
    radial = np.stack([ac[:, r_bin == k].sum(-1) for k in range(radial_bins)], 1)
    angular = np.stack([ac[:, a_bin == k].sum(-1) for k in range(angular_bins)], 1)
    centroid = (ac * r_norm[None]).sum(axis=(-2, -1)) / total
    high = ac[:, r_norm > 0.5].sum(-1) / total
    return np.concatenate([radial / total[:, None], angular / total[:, None],
                           centroid[:, None], high[:, None], np.log10(total)[:, None]], 1)


def svm_decision(arrays: dict, name: str, X: np.ndarray) -> np.ndarray:
    """sum_i alpha_i exp(-gamma |x - sv_i|^2) - rho, float64."""
    sv = arrays[f"svm_{name}/support_vectors"].astype(np.float64)
    d2 = ((X[:, None, :] - sv[None]) ** 2).sum(-1)
    return (np.exp(-float(arrays[f"svm_{name}/gamma"]) * d2)
            @ arrays[f"svm_{name}/dual_coef"].astype(np.float64)
            - float(arrays[f"svm_{name}/rho"]))


class Reference:
    """The reference of one configuration: its weights, read and checked
    once, and `screen`."""

    def __init__(self, config: dict, workload: dict, root: str, device):
        self.config, self.workload, self.device = config, workload, torch.device(device)
        self.seg = dict(config["segmentation"], **workload["segmentation"])
        self.backend = backends.module(self.seg["backend"], "reference")
        paths = checked_weights(config["weights"], root)
        self.state = self.backend.load(self.seg, {k: p for k, p in paths.items()
                                                  if k != "scoring"}, self.device)
        self.arrays = load_scoring(paths["scoring"])
        self.cae = CAE(self.arrays, self.device)

    def labels(self, seg: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(seg.astype(np.float32), device=self.device)
        return self.backend.labels(self.state, x, self.seg)

    def screen(self, frames: np.ndarray, use_tf32: bool = False) -> tuple:
        """(scores, stats) of the (B, H, W, 3) uint16 frames, frame by
        frame; `use_tf32` computes the networks with TF32 (the control)."""
        qc, sc, fused = self.config["qc"], self.config["scoring"], self.workload["fused"]
        stats = {k: [] for k in STAT_KEYS}
        cells = []
        with tf32(use_tf32):
            for b, frame in enumerate(frames):
                labels = self.labels(frame[..., 2])
                green = frame[..., 1].astype(np.float64)
                for lab, area, ecc, mean, std, crop in stage_a(labels, green, qc, fused):
                    for k, v in zip(STAT_KEYS, (lab, area, ecc, mean, std, b)):
                        stats[k].append(v)
                    cells.append(resize(equalize_adapthist_np(crop, clip_limit=sc["clip_limit"]),
                                        sc["out_size"]))
            stats = {k: np.asarray(v) for k, v in stats.items()}
            if not cells:
                return {}, stats
            return self._score(np.stack(cells).astype(np.float32), sc), stats

    def _score(self, X: np.ndarray, sc: dict) -> dict:
        a = self.arrays
        recon, enc = [], []
        for s in range(0, len(X), 512):
            x = torch.as_tensor(X[s:s + 512, None], device=self.device)
            r, e = self.cae(x)
            recon.append(r[:, 0].double().cpu().numpy())
            enc.append(e.double().cpu().numpy())
        recon, enc = np.concatenate(recon), np.concatenate(enc)
        diff = X.astype(np.float64) - recon
        mse, mae = (diff ** 2).mean(axis=(1, 2)), np.abs(diff).mean(axis=(1, 2))
        scaled = (enc - a["scaler_center"]) / a["scaler_scale"]
        reduced = (scaled - a["pca_mean"]) @ a["pca_components"].astype(np.float64).T
        d_cons = svm_decision(a, "conservative", reduced)
        d_mod = svm_decision(a, "moderate", reduced)
        fft = fft_features(X, *sc["fft_bins"])
        d_fft = svm_decision(a, "fft", (fft - a["fft_scaler_center"]) / a["fft_scaler_scale"])
        pm1 = lambda d: np.where(d > 0, 1, -1).astype(np.int32)  # noqa: E731
        votes = ((mse > float(a["ensemble_mse_threshold"])).astype(int)
                 + (pm1(d_cons) == -1) + (pm1(d_mod) == -1))
        return dict(reconstruction_mse=mse, reconstruction_mae=mae,
                    conservative_predictions=pm1(d_cons), moderate_predictions=pm1(d_mod),
                    conservative_scores=-d_cons, moderate_scores=-d_mod,
                    ensemble_predictions=np.where(votes >= sc["min_votes"], -1, 1).astype(np.int32),
                    fft_predictions=pm1(d_fft), fft_scores=-d_fft, fft_features=fft)
