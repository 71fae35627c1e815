"""One-class RBF SVM decision function (inference only).

Counterpart of `cell_image_analysis_tpu/models/svm.py`: the kernel block
`exp(-gamma * max(|x|^2 + |y|^2 - 2 x.y, 0))` against the support vectors,
then a matvec with the dual coefficients, minus rho; positive = inlier.
Matmuls run in float32 (TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

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
