"""Training of the StarDist-style U-Net, on one device.

Counterpart of `cell_image_analysis_tpu/train/unet_trainer.py`.  The
ground truth is host numpy/scipy, as in JAX: per-instance normalized
distance transforms for the object probability (`prob_gt`) and per-pixel
star-ray lengths (`star_dist_gt`), kept at the grid's stride.  The step
(`unet_train_step`) is the StarDist loss, BCE on the clipped probability
plus 0.2 x the probability-weighted MAE on the rays, and one Adam update
(`OptaxAdam`: optax's defaults and arithmetic, b1 0.9, b2 0.999, eps 1e-8
outside the sqrt).  The
U-Net's 3x3 convs run forward and data-gradient through the Winograd
kernel (`ops.winograd.WinogradConv3x3Fn`).  `fit_unet` takes one
full-batch step an epoch, as JAX's does.

The clip is `jnp.clip`'s `minimum(maximum(x, lo), hi)`, whose gradient at
an exact bound is 1/2 (`torch.clamp` would pass 1): an overfit U-Net's
sigmoid reaches 1 - 2^-23, the float32 upper bound, on some pixels.

`synthetic_training_set` and `self_check` are the frames and the check of
`scripts/make_unet_weights.py` (seeded synthetic plates, true instance
labels or the threshold oracle's), shared by
`scripts/make_unet_weights_torch.py` and `chip_smoke.py`.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage as ndi

from cell_image_analysis_tpu_torch.io.artifacts import resolve_device
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet, init_unet

CLIP_EPS = 1e-7
DIST_WEIGHT = 0.2


def star_dist_gt(labels: np.ndarray, n_rays: int = 32, max_dist: int = 64,
                 grid: int = 1) -> np.ndarray:
    """Star-ray distances to the instance boundary at the pixels
    `[::grid, ::grid]`: for each such foreground pixel and ray direction,
    the steps (px) walked until leaving the pixel's instance or the frame.
    Each pixel's rays are independent of every other pixel, so `grid` > 1
    gives `star_dist_gt(labels)[::grid, ::grid]` bit for bit at 1/grid^2 of
    the work.  A direction stops once no ray is alive."""
    h, w = labels.shape
    ys, xs = np.mgrid[0:h:grid, 0:w:grid]
    own = labels[::grid, ::grid]
    dists = np.zeros(own.shape + (n_rays,), np.float32)
    phis = 2 * np.pi * np.arange(n_rays) / n_rays
    for k, phi in enumerate(phis):
        dy, dx = np.sin(phi), np.cos(phi)
        alive = own > 0
        d = np.zeros(own.shape, np.float32)
        for t in range(1, max_dist + 1):
            yy = np.clip(np.round(ys + t * dy).astype(int), 0, h - 1)
            xx = np.clip(np.round(xs + t * dx).astype(int), 0, w - 1)
            same = labels[yy, xx] == own
            # walking off the frame edge ends the ray too
            on_grid = ((np.abs(ys + t * dy - yy) < 0.5 + 1e-6)
                       & (np.abs(xs + t * dx - xx) < 0.5 + 1e-6))
            alive = alive & same & on_grid
            if not alive.any():
                break
            d += alive
        dists[..., k] = d
    return dists


def prob_gt(labels: np.ndarray) -> np.ndarray:
    """StarDist object probabilities: per-instance normalized Euclidean
    distance transform (1 at the medial axis, ->0 at the boundary)."""
    out = np.zeros(labels.shape, np.float32)
    edt = ndi.distance_transform_edt(labels > 0)
    for lab in range(1, int(labels.max()) + 1):
        m = labels == lab
        if not m.any():
            continue
        mx = edt[m].max()
        if mx > 0:
            out[m] = edt[m] / mx
    return out


def make_unet_training_batch(labels: np.ndarray, image: np.ndarray, grid: int = 2,
                             n_rays: int = 32):
    """(image, gt_prob, gt_dist) with the ground truth at the grid's stride."""
    p = prob_gt(labels)[::grid, ::grid]
    d = star_dist_gt(labels, n_rays=n_rays, grid=grid)
    return image.astype(np.float32), p, d


def clip_like_jax(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`: `minimum(maximum(x, lo), hi)` with float32
    bounds; the gradient at an exact bound is 1/2."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def unet_loss(model: StarDistUNet, batch):
    """(loss, bce, wd) of `batch` = (imgs (B, H, W), gt_prob (B, H/g, W/g),
    gt_dist (B, H/g, W/g, n_rays)), as JAX's `loss_fn`."""
    imgs, gt_prob, gt_dist = batch
    prob, dist = model.forward_train(imgs[..., None])
    prob = clip_like_jax(prob, CLIP_EPS, 1 - CLIP_EPS)
    bce = -torch.mean(gt_prob * torch.log(prob) + (1 - gt_prob) * torch.log(1 - prob))
    # prob-weighted MAE on ray distances (StarDist dist loss)
    wd = torch.mean(gt_prob[..., None] * torch.abs(dist - gt_dist))
    return bce + DIST_WEIGHT * wd, bce, wd


class OptaxAdam(torch.optim.Optimizer):
    """`optax.adam(lr, b1, b2, eps)` step for step, in float32 as optax
    computes it: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu with the
    decays' float64 complements rounded to float32, the bias corrections
    1 - b^t from the float32 decays, u = mu_hat / (sqrt(nu_hat) + eps), p +=
    -lr u.  (`torch.optim.Adam` takes 1 - b2^t in float64, which puts its
    first update 6.4e-6 off optax's.)  Multi-tensor (`torch._foreach_*`)
    ops, a handful of launches a step."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                                     "count": 0}
            b1, b2 = group["b1"], group["b2"]
            count = self.state[ps[0]]["count"] + 1
            for p in ps:
                self.state[p]["count"] = count
            gs = [p.grad for p in ps]
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(ps, updates)


def make_unet_optimizer(model: StarDistUNet, lr: float) -> OptaxAdam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 added to sqrt(nu_hat)."""
    return OptaxAdam(model.parameters(), lr)


def unet_train_step(model: StarDistUNet, opt: torch.optim.Optimizer, batch):
    """One step: loss, backward, Adam.  Returns (loss, bce, wd) as tensors on
    the device (no host wait)."""
    opt.zero_grad(set_to_none=True)
    loss, bce, wd = unet_loss(model, batch)
    loss.backward()
    opt.step()
    return loss.detach(), bce.detach(), wd.detach()


def training_tensors(frames: list, label_maps: list, n_rays: int = 32, grid: int = 2,
                     device=None):
    """The host ground truth of `frames` and `label_maps`, stacked and on
    `device`: (imgs, probs, dists)."""
    parts = [make_unet_training_batch(lab, img, grid=grid, n_rays=n_rays)
             for img, lab in zip(frames, label_maps)]
    return tuple(torch.as_tensor(np.stack(a), device=device) for a in zip(*parts))


def fit_unet(frames: list, label_maps: list, epochs: int = 40, lr: float = 3e-4,
             n_rays: int = 32, grid: int = 2, seed: int = 42, verbose: bool = False,
             init_state: dict | None = None, device=None,
             history: list | None = None) -> StarDistUNet:
    """Train on (H, W) float frames and int label maps of one shape, one
    full-batch step an epoch, on `device` (default: the card).  Returns the
    U-Net module.

    init_state: a state dict to start from (warm start, e.g.
    `io.artifacts.unet_state_from_jax` of an artifact's params), instead of
    `init_unet(seed)`.  history: a list that gets each epoch's (loss, bce,
    wd) tensors, on the device."""
    device = resolve_device(device)
    batch = training_tensors(frames, label_maps, n_rays=n_rays, grid=grid, device=device)
    model = init_unet(seed, device=device, n_rays=n_rays, grid=(grid, grid))
    if init_state is not None:
        model.load_state_dict(init_state)
    opt = make_unet_optimizer(model, lr)
    for e in range(epochs):
        loss, bce, wd = unet_train_step(model, opt, batch)
        if history is not None:
            history.append((loss, bce, wd))
        if verbose and (e % 10 == 0 or e == epochs - 1):
            print(f"unet epoch {e}: loss {float(loss):.4f} (bce {float(bce):.4f}, "
                  f"dist {float(wd):.4f})", flush=True)
    return model


# ------------------------------------- the synthetic set and its check --

def threshold_labels_np(seg: np.ndarray, threshold_percentile=90.0,
                        pmin=3.0, pmax=99.8) -> np.ndarray:
    """CPU oracle of the threshold backend: percentile-normalize, threshold,
    binary opening, connected components."""
    x = seg.astype(np.float64)
    lo, hi = np.percentile(x, pmin), np.percentile(x, pmax)
    norm = (x - lo) / (hi - lo + 1e-20)
    thresh = np.percentile(norm, threshold_percentile)
    mask = ndi.binary_opening(norm > thresh)
    labels, _ = ndi.label(mask)
    return labels.astype(np.int32)


def normalize_np(seg: np.ndarray, pmin=3.0, pmax=99.8) -> np.ndarray:
    lo, hi = np.percentile(seg, pmin), np.percentile(seg, pmax)
    return ((seg - lo) / (hi - lo + 1e-20)).astype(np.float32)


def synthetic_training_set(n_frames: int = 8, size: int = 256, dense: bool = False,
                           fg_d2: float = 1.6, seed: int = 123):
    """(frames, label maps) of `scripts/make_unet_weights.py`: dense =
    crowded plates (1-4x the bench's density, 0-60% of cells touching) with
    their true instance labels; else the bench's density (4-8 cells a
    256^2 frame) with the threshold oracle's labels."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame, make_frame_instances

    rng = np.random.default_rng(seed)
    frames, labels = [], []
    for _ in range(n_frames):
        if dense:
            dens = rng.uniform(1.0, 4.0) * (size / 256) ** 2
            n = max(3, int(rng.normal(5 * dens, dens)))
            clust = float(rng.uniform(0.0, 0.6))
            f, lab = make_frame_instances(rng, size=size, n_cells=n, clustering=clust,
                                          fg_d2=fg_d2)
            frames.append(normalize_np(f[..., 2].astype(np.float64)))
            labels.append(lab)
        else:
            n = int(rng.integers(4, 9))
            f = make_frame(rng, size=size, n_cells=n)
            seg = f[..., 2].astype(np.float64)
            frames.append(normalize_np(seg))
            labels.append(threshold_labels_np(seg))
    return frames, labels


def self_check_frame(size: int = 256, dense: bool = False, fg_d2: float = 1.6):
    """(raw seg channel (size, size) float32, true labels) of the check:
    `default_rng(999)`, as the JAX script."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame, make_frame_instances

    if dense:
        f, lab_true = make_frame_instances(np.random.default_rng(999), size=size,
                                           n_cells=max(6, 10 * (size // 256) ** 2),
                                           clustering=0.5, fg_d2=fg_d2)
    else:
        f = make_frame(np.random.default_rng(999), size=size, n_cells=6)
        lab_true = threshold_labels_np(f[..., 2].astype(np.float64))
    return f[..., 2].astype(np.float32), lab_true


def self_check(model: StarDistUNet, size: int = 256, dense: bool = False,
               fg_d2: float = 1.6) -> dict:
    """`predict_instances` at `SegConfig(max_candidates=256,
    raster_patch=96)` on the check frame: {'n_pred', 'n_true', 'coverage'
    (the share of true foreground that is predicted foreground), 'labels'}."""
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances

    seg, lab_true = self_check_frame(size, dense, fg_d2)
    device = next(model.parameters()).device
    lab_pred, _ = predict_instances(torch.as_tensor(seg[None], device=device), model,
                                    SegConfig(max_candidates=256, raster_patch=96))
    lab_pred = lab_pred[0].cpu().numpy()
    n_pred, n_true = int(lab_pred.max()), int(lab_true.max())
    cover = ((lab_pred > 0) & (lab_true > 0)).sum() / max((lab_true > 0).sum(), 1)
    return {"n_pred": n_pred, "n_true": n_true, "coverage": float(cover), "labels": lab_pred}
