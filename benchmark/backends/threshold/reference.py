"""The reference's threshold segmentation (`reference/segment.py`)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import segment


def load(seg: dict, weights: dict, device) -> None:
    return None


def labels(state: None, seg_channel: torch.Tensor, seg: dict) -> np.ndarray:
    return segment.threshold_labels(seg_channel, seg)
