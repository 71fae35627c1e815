"""Region properties container and the geometric QC gates.

Counterpart of `cell_image_analysis_tpu/ops/regionprops.py` (`RegionProps`,
`qc_mask`); the properties themselves come from the run-length path
(`ops.runs.regionprops_from_labels`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RegionProps(NamedTuple):
    """Arrays indexed (frame, label - 1); `valid` marks labels with area > 0."""

    area: torch.Tensor          # (B, K) int32
    min_r: torch.Tensor         # (B, K) int32
    min_c: torch.Tensor
    max_r: torch.Tensor         # exclusive
    max_c: torch.Tensor
    centroid_r: torch.Tensor    # (B, K) float32
    centroid_c: torch.Tensor
    eccentricity: torch.Tensor  # (B, K) float32
    valid: torch.Tensor         # (B, K) bool


def qc_mask(props: RegionProps, height: int, width: int, border_margin: int = 10,
            min_area: int = 200, max_area: int = 8000,
            max_eccentricity: float = 0.95) -> torch.Tensor:
    """Border margin, area window and eccentricity ceiling
    (CAE_improved_modeltrain.py:68-77 of the reference)."""
    border_ok = ((props.min_r >= border_margin) & (props.min_c >= border_margin)
                 & (props.max_r <= height - border_margin)
                 & (props.max_c <= width - border_margin))
    area_ok = (props.area >= min_area) & (props.area <= max_area)
    ecc_ok = props.eccentricity <= max_eccentricity
    return props.valid & border_ok & area_ok & ecc_ok
