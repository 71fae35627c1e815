"""PCA: a float64 SVD fit on the host, a matmul transform on the device.

Counterpart of `cell_image_analysis_tpu/models/pca.py`.  `fit` is JAX's
`_fit`, numpy in float64 on the host (JAX also fits on the host), with
sklearn's v-based `svd_flip`: each component is flipped so that its
largest-|.| coefficient is positive.  `transform` is
`(x - mean_) @ components_.T` on the input's device in float32 (TF32 off).
`pipeline.scoring.score_cells` applies the same transform inside the
screening path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PCA:
    n_components: int
    mean_: np.ndarray | None = None
    components_: np.ndarray | None = None            # (K, D)
    explained_variance_: np.ndarray | None = None
    explained_variance_ratio_: np.ndarray | None = None

    def fit(self, X) -> "PCA":
        Xh = (X.detach().cpu().numpy() if isinstance(X, torch.Tensor)
              else np.asarray(X)).astype(np.float32)
        n, d = Xh.shape
        k = min(self.n_components, d, n - 1)
        (self.mean_, self.components_, self.explained_variance_,
         self.explained_variance_ratio_) = _fit(Xh, k)
        return self

    def transform(self, X) -> torch.Tensor:
        X = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
        mean = torch.as_tensor(self.mean_, device=X.device)
        comps = torch.as_tensor(self.components_, device=X.device)
        return torch.matmul(X.float() - mean, comps.T)

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)


def _fit(X: np.ndarray, k: int):
    Xh = np.asarray(X, dtype=np.float64)
    n = Xh.shape[0]
    mean = Xh.mean(axis=0)
    u, s, vt = np.linalg.svd(Xh - mean, full_matrices=False)
    # sklearn svd_flip (v-based, as used by PCA._fit_full since sklearn 1.5):
    # flip each component so its max-|.| coefficient is positive
    idx = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), idx])
    signs[signs == 0] = 1.0
    vt = vt * signs[:, None]
    var = (s ** 2) / (n - 1)
    total = var.sum()
    return (mean.astype(np.float32), vt[:k].astype(np.float32),
            var[:k].astype(np.float32), (var[:k] / total).astype(np.float32))
