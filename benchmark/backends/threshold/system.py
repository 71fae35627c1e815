"""The port's threshold backend: percentile threshold, opening, components."""

from __future__ import annotations


def build(seg: dict, weights: dict, device):
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend

    return ThresholdBackend(SegConfig(**seg))
