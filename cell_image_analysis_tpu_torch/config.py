"""Segmentation settings of the port.

The fields of `cell_image_analysis_tpu/config.py:SegConfig` that the port
reads, with the same defaults (a test holds them field for field).  The
JAX package's TPU knobs (`unet_dtype`, `unet_precision`, `unet_lvl0_*`,
`unet_wb16`, `unet_hilo`, `unet_winograd`) have no counterpart here: the
port's U-Net always runs float32 3x3 convs through the Winograd kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SegConfig:
    """StarDist-style segmentation settings (pretrained `2D_versatile_fluo`:
    32 rays, grid 2, U-Net depth 3 / 32 base filters / 128-channel head,
    prob threshold ~0.479, NMS 0.3)."""

    n_rays: int = 32
    grid: Tuple[int, int] = (2, 2)
    unet_depth: int = 3
    base_filters: int = 32
    head_filters: int = 128
    prob_thresh: float = 0.479071
    nms_thresh: float = 0.3
    max_candidates: int = 1024       # top-K candidate cap per frame
    nms_metric: str = "iou"          # "iou" | "ios" (intersection over smaller)
    nms_max_pairs: int = 8192        # sparse-NMS pair budget; overflow is reported
    raster_patch: int = 128          # scatter rasterizer's patch side
    raster_cap: int = 0              # >0: render only the top-N kept polygons
    raster_mode: str = "tiled"       # "tiled" | "scatter"
    raster_tile: int = 64            # tiled mode: tile side
    raster_m_cap: int = 8            # tiled mode: polygons a tile may hold
    norm_pmin: float = 3.0           # percentile normalization of the seg channel
    norm_pmax: float = 99.8
    backend: str = "stardist"        # "stardist" | "threshold"
    threshold_percentile: float = 90.0
