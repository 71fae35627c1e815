"""PCA: the fitted state.

Counterpart of `cell_image_analysis_tpu/models/pca.py`'s dataclass;
`pipeline.scoring.score_cells` applies `(x - mean_) @ components_.T`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PCA:
    n_components: int
    mean_: np.ndarray | None = None
    components_: np.ndarray | None = None            # (K, D)
    explained_variance_: np.ndarray | None = None
    explained_variance_ratio_: np.ndarray | None = None
