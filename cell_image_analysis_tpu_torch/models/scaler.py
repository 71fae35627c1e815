"""RobustScaler: the fitted state (median / IQR standardization).

Counterpart of `cell_image_analysis_tpu/models/scaler.py`'s dataclass;
`pipeline.scoring.score_cells` applies `(x - center_) / scale_`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RobustScaler:
    center_: np.ndarray | None = None
    scale_: np.ndarray | None = None
