"""RobustScaler: median / IQR standardization.

Counterpart of `cell_image_analysis_tpu/models/scaler.py`: `fit` takes the
per-feature median and interquartile range (`ops.percentile.median_iqr`,
float32, on the input's device) and maps a zero range to 1, as sklearn
does; `transform` is `(x - center_) / scale_` on the input's device.  The
fitted state is numpy, as JAX keeps it.  `pipeline.scoring.score_cells`
applies the same transform inside the screening path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cell_image_analysis_tpu_torch.ops.percentile import median_iqr


def _as_tensor(X) -> torch.Tensor:
    return X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))


@dataclass
class RobustScaler:
    center_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    def fit(self, X) -> "RobustScaler":
        med, iqr = median_iqr(_as_tensor(X).float())
        iqr = torch.where(iqr == 0.0, torch.ones_like(iqr), iqr)
        self.center_ = med.cpu().numpy()
        self.scale_ = iqr.cpu().numpy()
        return self

    def transform(self, X) -> torch.Tensor:
        X = _as_tensor(X)
        center = torch.as_tensor(self.center_, device=X.device)
        scale = torch.as_tensor(self.scale_, device=X.device)
        return (X.float() - center) / scale

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)
