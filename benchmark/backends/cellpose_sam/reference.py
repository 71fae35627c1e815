"""The reference's Cellpose-SAM (`reference/cellpose_sam.py`) from the
`cellpose` weight file, one frame at a time on the reference's device."""

from __future__ import annotations

import torch

from benchmark.reference import cellpose_sam


def load(seg: dict, weights: dict, device) -> dict:
    return cellpose_sam.load(weights["cellpose"], device)


def labels(state: dict, seg_channel: torch.Tensor, seg: dict):
    return cellpose_sam.labels(state, seg_channel.cpu().numpy(), seg, seg_channel.device)
