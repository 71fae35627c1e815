"""Ensemble combiner: the fitted state.

Counterpart of `cell_image_analysis_tpu/models/ensemble.py`'s dataclass: a
majority vote over reconstruction MSE above `mse_threshold`, the
conservative SVM flag and the moderate SVM flag
(`pipeline.scoring.score_cells`).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EnsembleDetector:
    """The recon-error vote threshold from training data."""

    mse_threshold: float
    min_votes: int = 2
