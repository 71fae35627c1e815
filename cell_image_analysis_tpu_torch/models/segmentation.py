"""Segmentation backends: raw seg channels -> instance label maps.

Counterpart of `cell_image_analysis_tpu/models/segmentation.py`:

- `threshold_mask` / `threshold_segment`: the threshold backend —
  percentile normalization, threshold, binary opening, and for the label
  maps connected components (`ops.cc.label_components`, the CC kernel on
  the GPU);
- `ThresholdBackend`: the threshold segment_fn of
  `pipeline.scoring.score_frames_fused`, returning the `threshold_segment`
  label maps; like the other backends, stage A takes them through the
  run-length regionprops (`runs_props`), and its `exact_twin()` through
  the pixel regionprops;
- `StarDistBackend`: the U-Net on a device, returning `(labels, overflow)`
  per frame batch, where `overflow` ORs the tiled rasterizer's per-tile
  cap, the NMS pair budget and the candidate cap.  Its `exact_twin()` is
  the backend JAX's callers re-run on overflow: scatter rasterizer, the
  K^2 NMS pair set and the pixel regionprops;
- `CellposeBackend`: Cellpose 3's `cyto3` network (`models.cellpose`) or
  Cellpose-SAM's ViT (`models.vit_sam`), chosen from the weights, over
  tiles, the flow following (`ops.flows`), the masks, the flow-error QC
  and the clean-up (`ops.cellpose_masks`), returning label maps per frame
  batch; it has no capacity.  Its `exact_twin()`, which a stage-A
  overflow re-runs, is the same network on the pixel regionprops;
- `segment_frame`: the dispatch on `SegConfig.backend`;
- `select_backend`: the screener's and the trainer's choice of a
  segment_fn and its exact twin.

All of them take batches (B, H, W).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.config import CellposeConfig, SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import resolve_device, unet_state_from_jax
from cell_image_analysis_tpu_torch.models.stardist import predict_instances
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet
from cell_image_analysis_tpu_torch.ops.cc import label_components
from cell_image_analysis_tpu_torch.ops.extract import OVERFLOW_REASONS
from cell_image_analysis_tpu_torch.ops.percentile import kth_smallest, percentile_ranks
from cell_image_analysis_tpu_torch.utils.profiler import count, span

# `cellpose_sam` is the `cellpose` backend under Cellpose 4's name: the weights pick the network
BACKENDS = ("stardist", "threshold", "cellpose", "cellpose_sam")


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
    operations run in JAX's order.  The span `segmentation.threshold`."""
    with span("segmentation.threshold"):
        return _threshold_mask(seg_channels, threshold_percentile, pmin, pmax, opening)


def _threshold_mask(seg_channels, threshold_percentile, pmin, pmax, opening):
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
    maps numbered in raster order.  The components are the span
    `segmentation.cc`."""
    mask = threshold_mask(seg_channels, threshold_percentile=threshold_percentile,
                          pmin=pmin, pmax=pmax, opening=opening)
    with span("segmentation.cc"):
        labels, _ = label_components(mask, connectivity=connectivity)
    return labels


class ThresholdBackend:
    """Threshold segment_fn for `pipeline.scoring.score_frames_fused`: the
    `threshold_segment` label maps.

    `runs_props` routes stage A through the run-length label regionprops,
    whose run-table overflow re-runs the batch through `exact_twin()`;
    False routes it through the pixel regionprops (the exact twin)."""

    def __init__(self, cfg: SegConfig = SegConfig(), runs_props: bool = True):
        self.cfg = cfg
        self.runs_props = runs_props

    def exact_twin(self) -> ThresholdBackend:
        return ThresholdBackend(self.cfg, runs_props=False)

    def __call__(self, seg_channels: torch.Tensor) -> torch.Tensor:
        return threshold_segment(seg_channels, threshold_percentile=self.cfg.threshold_percentile,
                                 pmin=self.cfg.norm_pmin, pmax=self.cfg.norm_pmax)


class StarDistBackend:
    """Label-map segment_fn for `pipeline.scoring.score_frames_fused`.

    `runs_props` routes stage A through the run-length label regionprops;
    False routes it through the pixel regionprops (the exact twin).  The
    U-Net built from `variables` goes to `device`, by default the card; a
    `model` passed in stays where it is."""

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
        self._replicas: dict = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def to(self, device) -> StarDistBackend:
        """This backend with a copy of its U-Net on `device` (one copy a
        device, kept for later calls): a shard's segment_fn on a mesh
        (`parallel.sharding.replicate`)."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self._replicas:
            self._replicas[device] = StarDistBackend(
                None, self.cfg, runs_props=self.runs_props,
                model=copy.deepcopy(self.model).to(device))
        return self._replicas[device]

    def exact_twin(self) -> StarDistBackend:
        """The overflow re-run target, on the same U-Net: scatter
        rasterizer, every candidate pair in the NMS (`nms_max_pairs=None`;
        the JAX twin sets K^2, the same pair set), pixel regionprops."""
        cfg = dataclasses.replace(self.cfg, raster_mode="scatter", nms_max_pairs=None)
        return StarDistBackend(None, cfg, runs_props=False, model=self.model)

    @torch.inference_mode()
    def __call__(self, seg_channels: torch.Tensor):
        """(B, H, W) raw channels -> (labels (B, H, W) int32, overflow (B,))."""
        labels, reasons = self.overflow_reasons(seg_channels)
        return labels, reasons != 0

    @torch.inference_mode()
    def overflow_reasons(self, seg_channels: torch.Tensor):
        """(labels (B, H, W) int32, reasons (B,) int32): the overflow flag
        as the bits of `ops.extract.OVERFLOW_REASONS` that fired."""
        labels, d = predict_instances(seg_channels, self.model, self.cfg)
        bit = OVERFLOW_REASONS.index
        reasons = ((d.cand_overflow.int() << bit("candidates"))
                   | (d.nms_overflow.int() << bit("nms_pairs"))
                   | (d.raster_overflow.int() << bit("raster")))
        return labels, reasons


class CellposeBackend:
    """Label-map segment_fn for `pipeline.scoring.score_frames_fused`:
    Cellpose (`CellposeConfig`) with the network built from `arrays` (a
    dict of Cellpose-named weights) on `device`, by default the card: a
    Cellpose-SAM state (`models.vit_sam.is_vit_state`) builds the ViT
    (`build_vit_sam`), any other CPnet (`models.cellpose.build_cpnet`); a
    `model` passed in stays where it is.  The tiles are `cfg.tile`, by
    default the network's own.

    It has no capacity of its own: the seed table is sized to the batch's
    most seeds.  Stage A goes through the run-length label regionprops
    (`runs_props`), the exact twin's through the pixel regionprops.  Spans
    `cellpose.normalize`, `cellpose.tiles`, `cellpose.net`,
    `cellpose.follow_flows`, `cellpose.masks`, `cellpose.flow_qc`,
    `cellpose.fill`; counters `cellpose.tiles`, `cellpose.points` (the
    moving pixels), `cellpose.seeds`, `cellpose.qc_iterations` (the
    batch's heat-map steps), `cellpose.removed_flow`,
    `cellpose.removed_small`."""

    def __init__(self, arrays: dict | None, cfg: CellposeConfig = CellposeConfig(), device=None,
                 runs_props: bool = True, model=None):
        from cell_image_analysis_tpu_torch.models import vit_sam
        from cell_image_analysis_tpu_torch.models.cellpose import build_cpnet

        self.cfg = cfg
        self.runs_props = runs_props
        if model is None:
            build = vit_sam.build_vit_sam if vit_sam.is_vit_state(arrays) else build_cpnet
            model = build(arrays, resolve_device(device))
        self.model = model

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def exact_twin(self) -> CellposeBackend:
        """The re-run target of a stage-A overflow, on the same network:
        pixel regionprops."""
        return CellposeBackend(None, self.cfg, runs_props=False, model=self.model)

    @torch.inference_mode()
    def __call__(self, seg_channels: torch.Tensor) -> torch.Tensor:
        """(B, H, W) raw channels -> labels (B, H, W) int32."""
        from cell_image_analysis_tpu_torch.models.cellpose import run_tiled
        from cell_image_analysis_tpu_torch.ops import cellpose_masks as cm
        from cell_image_analysis_tpu_torch.ops.flows import follow_flows

        c = self.cfg
        y = run_tiled(self.model, seg_channels.to(self.device).float(), tile=c.tile,
                      overlap=c.tile_overlap, tile_chunk=c.tile_chunk, pmin=c.norm_pmin,
                      pmax=c.norm_pmax)
        dP = y[..., :2].permute(0, 3, 1, 2).contiguous()
        cellprob = y[..., 2].contiguous()
        del y
        p, n_moving = follow_flows(dP, cellprob, c.niter, c.cellprob_threshold)
        with span("cellpose.masks"):
            labels, n_seeds = cm.get_masks(p, cellprob > c.cellprob_threshold, n_moving,
                                           c.max_size_fraction)
            points, seeds, top = torch.stack([n_moving.sum().long(), n_seeds.sum(),
                                              labels.max().long()]).tolist()
            count("cellpose.points", points)
            count("cellpose.seeds", seeds)
        del p
        if c.flow_threshold > 0 and top > 0:
            with span("cellpose.flow_qc"):
                labels, bad, n_iter = cm.remove_bad_flow_masks(labels, dP, c.flow_threshold,
                                                               top + 1)
                # the fill needs the labels' size read anyway: the counts ride along
                bad, steps, top = torch.stack([bad.sum(), n_iter.max(),
                                               labels.max().long()]).tolist()
                count("cellpose.removed_flow", bad)
                count("cellpose.qc_iterations", steps)
        with span("cellpose.fill"):
            labels, _ = cm.fill_holes_and_remove_small(labels, c.min_size, top + 1)
        return labels


def segment_frame(seg_channels: torch.Tensor, cfg: SegConfig = SegConfig(),
                  model=None) -> torch.Tensor:
    """Dispatch on `cfg.backend`: the threshold backend's label maps,
    StarDist's with the U-Net `model` (JAX takes its variables instead;
    without a model the threshold backend runs, as in JAX), or Cellpose's
    with its network `model` (CPnet or the ViT) at `CellposeConfig()`'s
    settings.  Any other name raises ValueError."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"segment_frame: unknown segmentation backend {cfg.backend!r}; "
                         f"known: {BACKENDS}")
    if cfg.backend in ("cellpose", "cellpose_sam"):
        if model is None:
            raise ValueError("segment_frame: the cellpose backend needs its CPnet or ViT model")
        return CellposeBackend(None, model=model)(seg_channels)
    if cfg.backend == "threshold" or model is None:
        return threshold_segment(seg_channels, threshold_percentile=cfg.threshold_percentile,
                                 pmin=cfg.norm_pmin, pmax=cfg.norm_pmax)
    with torch.inference_mode():
        labels, _ = predict_instances(seg_channels, model, cfg)
    return labels


def select_backend(seg_cfg: SegConfig, cell_capacity: int, unet_variables=None, device=None):
    """(segment_fn, exact twin, network module or None) of the pipelines.
    With `unet_variables` and the StarDist backend: the raster-capped
    `StarDistBackend` (`raster_cap` = `cell_capacity` unless set), whose
    twin takes every overflow re-run, on `device`.  With the Cellpose
    backend `unet_variables` are the Cellpose weights (a dict of
    Cellpose-named arrays, `io.artifacts.load_cellpose_weights`: CPnet's
    or Cellpose-SAM's), required, and the backend is `CellposeBackend` at
    `CellposeConfig()`.  Otherwise `ThresholdBackend` and its exact twin.
    An unknown backend name raises ValueError."""
    if seg_cfg.backend not in BACKENDS:
        raise ValueError(f"select_backend: unknown segmentation backend {seg_cfg.backend!r}; "
                         f"known: {BACKENDS}")
    if seg_cfg.backend in ("cellpose", "cellpose_sam"):
        if unet_variables is None:
            raise ValueError("select_backend: the cellpose backend needs its weights "
                             "(--cellpose-weights)")
        primary = CellposeBackend(unet_variables, device=device)
        return primary, primary.exact_twin(), primary.model
    if seg_cfg.backend == "threshold" or unet_variables is None:
        primary = ThresholdBackend(seg_cfg)
        return primary, primary.exact_twin(), None
    if not seg_cfg.raster_cap:
        seg_cfg = dataclasses.replace(seg_cfg, raster_cap=cell_capacity)
    primary = StarDistBackend(unet_variables, seg_cfg, device=device)
    return primary, primary.exact_twin(), primary.model
