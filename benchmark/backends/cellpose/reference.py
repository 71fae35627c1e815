"""The reference's Cellpose (`reference/cellpose.py`) from the `cellpose`
weight file, one frame at a time on the reference's device."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cellpose


def load(seg: dict, weights: dict, device) -> dict:
    return cellpose.load(weights["cellpose"], device)


def labels(state: dict, seg_channel: torch.Tensor, seg: dict) -> np.ndarray:
    return cellpose.labels(state, seg_channel.cpu().numpy(), seg, seg_channel.device)
