"""StarDist segmentation backend: raw seg channels -> instance label maps.

Counterpart of `cell_image_analysis_tpu/models/segmentation.py`
(`StarDistBackend`).  Holds the U-Net on a device and returns
`(labels, overflow)` per frame batch, where `overflow` ORs the tiled
rasterizer's per-tile cap, the NMS pair budget and the candidate cap — the
flags on which the JAX pipeline re-runs with its exact twin.
"""

from __future__ import annotations

import torch

from cell_image_analysis_tpu.config import SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import unet_state_from_jax
from cell_image_analysis_tpu_torch.models.stardist import predict_instances
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet


class StarDistBackend:
    """Label-map segment_fn for `pipeline.scoring.score_frames_fused`."""

    def __init__(self, variables: dict, cfg: SegConfig = SegConfig(), device=None):
        self.cfg = cfg
        self.model = StarDistUNet(n_rays=cfg.n_rays, depth=cfg.unet_depth,
                                  base_filters=cfg.base_filters,
                                  head_filters=cfg.head_filters, grid=cfg.grid)
        self.model.load_state_dict(unet_state_from_jax(variables))
        self.model = self.model.to(torch.device(device or "cpu")).eval()

    @torch.inference_mode()
    def __call__(self, seg_channels: torch.Tensor):
        """(B, H, W) raw channels -> (labels (B, H, W) int32, overflow (B,))."""
        labels, d = predict_instances(seg_channels, self.model, self.cfg)
        return labels, d.raster_overflow | d.nms_overflow | d.cand_overflow
