"""Ensemble combiner: a majority vote over three anomaly flags.

Counterpart of `cell_image_analysis_tpu/models/ensemble.py`: a cell is
anomalous when at least `min_votes` of (1) reconstruction MSE above
`mse_threshold`, the training set's `EnsembleConfig.mse_percentile`-th
percentile, (2) the conservative SVM flag and (3) the moderate SVM flag
say so (`ensemble_predict`).  `pipeline.scoring.score_cells` votes with
`ensemble_votes`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cell_image_analysis_tpu_torch.config import EnsembleConfig


def ensemble_votes(mse: torch.Tensor, cons_pred: torch.Tensor, mod_pred: torch.Tensor,
                   mse_threshold) -> torch.Tensor:
    """Votes (0..3, int32) of each cell."""
    return ((mse > mse_threshold).int() + (cons_pred == -1).int()
            + (mod_pred == -1).int())


def ensemble_predict(mse: torch.Tensor, cons_pred: torch.Tensor, mod_pred: torch.Tensor,
                     mse_threshold, min_votes: int = 2) -> torch.Tensor:
    """-1 (anomaly: at least `min_votes` votes) / +1 (normal), int32."""
    votes = ensemble_votes(mse, cons_pred, mod_pred, mse_threshold)
    return torch.where(votes >= min_votes, -1, 1).int()


@dataclass
class EnsembleDetector:
    """The recon-error vote threshold from training data."""

    mse_threshold: float
    min_votes: int = 2

    @classmethod
    def fit(cls, train_mse, cfg: EnsembleConfig = EnsembleConfig()) -> "EnsembleDetector":
        return cls(mse_threshold=float(np.percentile(np.asarray(train_mse), cfg.mse_percentile)),
                   min_votes=cfg.min_votes)

    def predict(self, mse, cons_pred, mod_pred) -> np.ndarray:
        """+1 (normal) / -1 (anomaly) of each cell, sklearn-style."""
        return ensemble_predict(torch.as_tensor(np.asarray(mse, np.float32)),
                                torch.as_tensor(np.asarray(cons_pred)),
                                torch.as_tensor(np.asarray(mod_pred)),
                                torch.tensor(np.float32(self.mse_threshold)),
                                self.min_votes).numpy()
