"""Segmentation backends: raw seg channels -> instance label maps or masks.

Counterpart of `cell_image_analysis_tpu/models/segmentation.py`:

- `threshold_mask` / `threshold_segment`: the threshold backend —
  percentile normalization, threshold, binary opening, and for the label
  maps connected components (`ops.cc.label_components`, the CC kernel on
  the GPU);
- `ThresholdBackend`: the threshold segment_fn of
  `pipeline.scoring.score_frames_fused` — the boolean mask
  (`returns_mask`, stage A through the run-length CC) or, as its exact
  twin, the `threshold_segment` label maps (stage A through the pixel
  regionprops);
- `StarDistBackend`: the U-Net on a device, returning `(labels, overflow)`
  per frame batch, where `overflow` ORs the tiled rasterizer's per-tile
  cap, the NMS pair budget and the candidate cap.  Its `exact_twin()` is
  the backend JAX's callers re-run on overflow: scatter rasterizer, the
  K^2 NMS pair set and the pixel regionprops;
- `segment_frame`: the dispatch on `SegConfig.backend`.

All of them take batches (B, H, W).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.config import SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import resolve_device, unet_state_from_jax
from cell_image_analysis_tpu_torch.models.stardist import predict_instances
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet
from cell_image_analysis_tpu_torch.ops.cc import label_components
from cell_image_analysis_tpu_torch.ops.percentile import kth_smallest, percentile_ranks


def _cross(mask: torch.Tensor, combine) -> torch.Tensor:
    """Combine each pixel with its four neighbours; outside the frame
    counts as False."""
    h, w = mask.shape[-2:]
    p = F.pad(mask, (1, 1, 1, 1))
    acc = mask
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        acc = combine(acc, p[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w])
    return acc


def binary_opening(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary opening of (B, H, W) masks with the 4-connected cross
    (scipy `binary_opening` defaults, border_value 0)."""
    mask = mask.bool()
    for _ in range(iterations):
        mask = _cross(mask, torch.logical_and)   # erosion
    for _ in range(iterations):
        mask = _cross(mask, torch.logical_or)    # dilation
    return mask


def threshold_mask(seg_channels: torch.Tensor, threshold_percentile: float = 90.0,
                   pmin: float = 3.0, pmax: float = 99.8, opening: bool = True) -> torch.Tensor:
    """Percentile-normalize, threshold and open (B, H, W) raw channels into
    boolean masks.  The pmin/pmax normalization and the threshold come from
    the six raw order statistics of each frame: the normalization is
    monotone and affine, so the threshold percentile of the normalized
    frame is that map applied to the raw order statistics.  The float32
    operations run in JAX's order."""
    x = seg_channels.float()
    B = x.shape[0]
    rk = percentile_ranks(x[0].numel(), (pmin, pmax, threshold_percentile))
    v = kth_smallest(x, tuple(k for r in rk for k in r[:2])).reshape(B, 6, 1, 1)
    f = [torch.full((), float(r[2]), dtype=torch.float32, device=x.device) for r in rk]

    def lerp(i):
        return v[:, 2 * i] * (1.0 - f[i]) + v[:, 2 * i + 1] * f[i]

    lo, hi = lerp(0), lerp(1)
    scale = hi - lo + torch.full((), 1e-20, dtype=torch.float32, device=x.device)
    norm = (x - lo) / scale

    def g(t):
        return (t - lo) / scale

    thresh = g(v[:, 4]) * (1.0 - f[2]) + g(v[:, 5]) * f[2]
    mask = norm > thresh
    return binary_opening(mask) if opening else mask


def threshold_segment(seg_channels: torch.Tensor, threshold_percentile: float = 90.0,
                      pmin: float = 3.0, pmax: float = 99.8, connectivity: int = 1,
                      opening: bool = True) -> torch.Tensor:
    """`threshold_mask`, then connected components: (B, H, W) int32 label
    maps numbered in raster order."""
    mask = threshold_mask(seg_channels, threshold_percentile=threshold_percentile,
                          pmin=pmin, pmax=pmax, opening=opening)
    labels, _ = label_components(mask, connectivity=connectivity)
    return labels


class ThresholdBackend:
    """Threshold segment_fn for `pipeline.scoring.score_frames_fused`.

    By default it returns the boolean masks (`returns_mask`): stage A runs
    through the run-length connected components, and a run-table overflow
    re-runs the batch through `exact_twin()`, which returns the
    `threshold_segment` label maps for the pixel regionprops."""

    returns_mask = True

    def __init__(self, cfg: SegConfig = SegConfig()):
        self.cfg = cfg

    def exact_twin(self) -> _ThresholdLabels:
        return _ThresholdLabels(self.cfg)

    def _kw(self) -> dict:
        return dict(threshold_percentile=self.cfg.threshold_percentile,
                    pmin=self.cfg.norm_pmin, pmax=self.cfg.norm_pmax)

    def __call__(self, seg_channels: torch.Tensor) -> torch.Tensor:
        return threshold_mask(seg_channels, **self._kw())


class _ThresholdLabels(ThresholdBackend):
    """`ThresholdBackend.exact_twin()`: the `threshold_segment` label maps."""

    returns_mask = False

    def exact_twin(self) -> _ThresholdLabels:
        return self

    def __call__(self, seg_channels: torch.Tensor) -> torch.Tensor:
        return threshold_segment(seg_channels, **self._kw())


class StarDistBackend:
    """Label-map segment_fn for `pipeline.scoring.score_frames_fused`.

    `runs_props` routes stage A through the run-length label regionprops;
    False routes it through the pixel regionprops (the exact twin).  The
    U-Net built from `variables` goes to `device`, by default the card; a
    `model` passed in stays where it is."""

    returns_mask = False
    returns_overflow = True

    def __init__(self, variables: dict | None, cfg: SegConfig = SegConfig(), device=None,
                 runs_props: bool = True, model: StarDistUNet | None = None):
        self.cfg = cfg
        self.runs_props = runs_props
        if model is None:
            model = StarDistUNet(n_rays=cfg.n_rays, depth=cfg.unet_depth,
                                 base_filters=cfg.base_filters,
                                 head_filters=cfg.head_filters, grid=cfg.grid)
            model.load_state_dict(unet_state_from_jax(variables))
            model = model.to(resolve_device(device)).eval()
        self.model = model

    def exact_twin(self) -> StarDistBackend:
        """The overflow re-run target, on the same U-Net: scatter
        rasterizer, every candidate pair in the NMS (`nms_max_pairs=None`;
        the JAX twin sets K^2, the same pair set), pixel regionprops."""
        cfg = dataclasses.replace(self.cfg, raster_mode="scatter", nms_max_pairs=None)
        return StarDistBackend(None, cfg, runs_props=False, model=self.model)

    @torch.inference_mode()
    def __call__(self, seg_channels: torch.Tensor):
        """(B, H, W) raw channels -> (labels (B, H, W) int32, overflow (B,))."""
        labels, d = predict_instances(seg_channels, self.model, self.cfg)
        return labels, d.raster_overflow | d.nms_overflow | d.cand_overflow


def segment_frame(seg_channels: torch.Tensor, cfg: SegConfig = SegConfig(),
                  model: StarDistUNet | None = None) -> torch.Tensor:
    """Dispatch on `cfg.backend`: the threshold backend's label maps, or
    StarDist's with the U-Net `model` (JAX takes its variables instead);
    without a model the threshold backend runs, as in JAX."""
    if cfg.backend == "threshold" or model is None:
        return threshold_segment(seg_channels, threshold_percentile=cfg.threshold_percentile,
                                 pmin=cfg.norm_pmin, pmax=cfg.norm_pmax)
    with torch.inference_mode():
        labels, _ = predict_instances(seg_channels, model, cfg)
    return labels
