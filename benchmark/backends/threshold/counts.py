"""The threshold backend runs no network."""

from __future__ import annotations


def frame_flops(size: int, seg: dict) -> float:
    return 0.0


def conv3x3_layers(size: int, seg: dict) -> list:
    return []
