"""The port's StarDist backend: its U-Net over the `unet` weight file."""

from __future__ import annotations


def build(seg: dict, weights: dict, device):
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend

    cfg = SegConfig(**dict(seg, grid=tuple(seg.get("grid", (2, 2)))))
    return StarDistBackend(load_unet_variables(weights["unet"]), cfg, device=device)
