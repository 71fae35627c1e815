"""The reference's StarDist: the plain U-Net (`reference/models.py`) from the
`unet` weight file, star NMS and the raster (`reference/segment.py`)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import segment
from benchmark.reference.models import load_unet


def load(seg: dict, weights: dict, device) -> dict:
    return load_unet(weights["unet"], device)


def labels(state: dict, seg_channel: torch.Tensor, seg: dict) -> np.ndarray:
    return segment.stardist_labels(seg_channel, state, seg)
