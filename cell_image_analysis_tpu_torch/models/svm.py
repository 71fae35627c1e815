"""One-class RBF SVM: decision function and fitted state (inference only).

Counterpart of `cell_image_analysis_tpu/models/svm.py`: the kernel block
`exp(-gamma * max(|x|^2 + |y|^2 - 2 x.y, 0))` against the support vectors,
then a matvec with the dual coefficients, minus rho; positive = inlier.
Matmuls run in float32 (TF32 off).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


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
    """The fitted state of the JAX package's `OneClassSVM`."""

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
