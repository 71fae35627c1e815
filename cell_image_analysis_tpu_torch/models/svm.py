"""One-class RBF SVM: the kernel matrix on the device, SMO on the host.

Counterpart of `cell_image_analysis_tpu/models/svm.py`, in place of
`sklearn.svm.OneClassSVM(kernel='rbf', gamma='scale', nu=...)`:

- `fit`: gamma='scale' is 1 / (n_features * X.var()) in float64 on the
  host, as JAX computes it; the (N, N) kernel matrix
  `exp(-gamma * max(|x|^2 + |y|^2 - 2 x.y, 0))` is one float32 matmul on
  the input's device (TF32 off); it goes to the host in float64 for the SMO
  solver (`models.smo.smo_one_class`, C++); the support vectors are the
  rows with alpha > 1e-10.
- `decision_function`: the kernel block against the support vectors, a
  matvec with the dual coefficients, minus rho; positive = inlier.
  `predict` maps it to +1 / -1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cell_image_analysis_tpu_torch.models.smo import smo_one_class

_SV_TAU = 1e-10


class SVMParams(NamedTuple):
    support_vectors: torch.Tensor  # (K, D)
    dual_coef: torch.Tensor        # (K,)
    rho: torch.Tensor              # ()
    gamma: torch.Tensor            # ()


def rbf_kernel(X: torch.Tensor, Y: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    X, Y = X.float(), Y.float()
    xx = torch.sum(X * X, dim=1, keepdim=True)
    yy = torch.sum(Y * Y, dim=1, keepdim=True)
    d2 = xx + yy.T - 2.0 * torch.matmul(X, Y.T)
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def decision_function(params: SVMParams, X: torch.Tensor) -> torch.Tensor:
    K = rbf_kernel(X, params.support_vectors, params.gamma)
    return torch.matmul(K, params.dual_coef) - params.rho


@dataclass
class OneClassSVM:
    """sklearn's `OneClassSVM` with an RBF kernel: `fit`, `decision_function`
    and `predict` on tensors or numpy arrays, on their device."""

    nu: float = 0.5
    gamma: str | float = "scale"
    tol: float = 1e-3
    gamma_: float | None = None
    support_vectors_: np.ndarray | None = None
    dual_coef_: np.ndarray | None = None
    intercept_: float | None = None  # = -rho (sklearn convention)
    n_iter_: int | None = None

    @property
    def params(self) -> SVMParams:
        """The decision function's operands, on the CPU."""
        return SVMParams(
            support_vectors=torch.tensor(np.asarray(self.support_vectors_, np.float32)),
            dual_coef=torch.tensor(np.asarray(self.dual_coef_, np.float32)),
            rho=torch.tensor(np.float32(-self.intercept_)),
            gamma=torch.tensor(np.float32(self.gamma_)),
        )

    def _resolve_gamma(self, X: np.ndarray) -> float:
        if self.gamma == "scale":
            v = float(np.asarray(X, dtype=np.float64).var())
            return 1.0 / (X.shape[1] * v) if v > 0 else 1.0
        if self.gamma == "auto":
            return 1.0 / X.shape[1]
        return float(self.gamma)

    def fit(self, X) -> "OneClassSVM":
        Xd = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
        Xd = Xd.float()
        Xh = Xd.cpu().numpy()
        self.gamma_ = self._resolve_gamma(Xh)
        gamma = torch.tensor(np.float32(self.gamma_), device=Xd.device)
        K = rbf_kernel(Xd, Xd, gamma).cpu().numpy().astype(np.float64)
        alpha, rho, n_iter = smo_one_class(K, self.nu, tol=self.tol)
        sv = alpha > _SV_TAU
        self.support_vectors_ = Xh[sv]
        self.dual_coef_ = alpha[sv].astype(np.float32)
        self.intercept_ = -float(rho)
        self.n_iter_ = n_iter
        return self

    def decision_function(self, X) -> np.ndarray:
        Xd = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
        params = SVMParams(*(t.to(Xd.device) for t in self.params))
        return decision_function(params, Xd.float()).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        d = self.decision_function(X)
        return np.where(d > 0, 1, -1).astype(np.int32)
