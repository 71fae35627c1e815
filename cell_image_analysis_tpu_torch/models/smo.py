"""Host SMO solver of the one-class SVM dual problem.

Counterpart of `cell_image_analysis_tpu/models/smo.py`.  The dual of the
one-class SVM (libsvm's form),

    min_alpha  1/2 alpha^T Q alpha
    s.t.       0 <= alpha_i <= 1,   sum_i alpha_i = nu * l,

with Q_ij = k(x_i, x_j), is solved on the host by SMO with libsvm's
second-order working-set selection; rho comes from the free support
vectors' gradients.  `smo_one_class_np` is the executable specification;
`smo_one_class` runs its loop in C++ (`native/svm_smo.cpp`; the starting
gradient and rho stay numpy, so the two agree bit for bit), which it
compiles with `g++ -O3 -fPIC` at first use into
`build/host_native/libcia_smo_<hash>.so` at the repository root, through
the CUDA kernels' hash-keyed build (`ops.cuda._build.cached_build`: an
edit rebuilds, an unchanged tree reuses the library).  There is no numpy
fallback: if the library cannot be built, `smo_one_class` raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from cell_image_analysis_tpu_torch.ops.cuda._build import (
    HOST_BUILD_DIR,
    HOST_CXX_FLAGS,
    cached_build,
    host_cxx,
    load,
)

_TAU = 1e-12
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "svm_smo.cpp")
BUILD_DIR = HOST_BUILD_DIR
CXX_FLAGS = HOST_CXX_FLAGS


def _start(K: np.ndarray, nu: float, max_iter: int | None):
    """(K float64, alpha, G = K @ alpha, max_iter) of the starting point."""
    K = np.ascontiguousarray(K, dtype=np.float64)
    l = K.shape[0]
    n = nu * l
    alpha = np.zeros(l, dtype=np.float64)
    nf = int(n)
    alpha[:nf] = 1.0
    if nf < l:
        alpha[nf] = n - nf
    if max_iter is None:
        max_iter = max(10_000_000 // max(l, 1), 100 * l, 10_000)
    return K, alpha, K @ alpha, max_iter


def _rho(alpha: np.ndarray, G: np.ndarray) -> float:
    """rho: the mean gradient over the free SVs; the midpoint of the active
    bounds if there are none."""
    free = (alpha > _TAU) & (alpha < 1.0 - _TAU)
    if free.any():
        return float(G[free].mean())
    ub = float(np.min(np.where(alpha < 1.0 - _TAU, G, np.inf)))
    lb = float(np.max(np.where(alpha > _TAU, G, -np.inf)))
    return (ub + lb) / 2.0


def smo_one_class_np(
    K: np.ndarray, nu: float, tol: float = 1e-3, max_iter: int | None = None
) -> tuple[np.ndarray, float, int]:
    """Solve the one-class dual on a precomputed kernel matrix.

    Returns (alpha, rho, n_iter).
    """
    K, alpha, G, max_iter = _start(K, nu, max_iter)

    it = 0
    for it in range(max_iter):
        up = alpha < 1.0 - _TAU
        low = alpha > _TAU
        # libsvm optimality: m(a) = max_{I_up} -G, M(a) = min_{I_low} -G,
        # stop when m - M < tol  <=>  max_low G - min_up G < tol
        Gup = np.where(up, G, np.inf)
        i = int(np.argmin(Gup))
        m = -G[i]
        Glow = np.where(low, G, -np.inf)
        M = -np.max(Glow)
        if m - M < tol:
            break

        # WSS2: among I_low with -G_t < m, maximize (m + G_t)^2 / quad
        diff = m + G
        quad = K[i, i] + np.diag(K) - 2.0 * K[i]
        quad = np.where(quad <= 0, _TAU, quad)
        gain = np.where(low & (diff > 0), (diff * diff) / quad, -np.inf)
        j = int(np.argmax(gain))
        if not np.isfinite(gain[j]):
            break

        delta = (G[j] - G[i]) / max(quad[j], _TAU)
        s = alpha[i] + alpha[j]
        ai = alpha[i] + delta
        ai = min(max(ai, max(0.0, s - 1.0)), min(1.0, s))
        aj = s - ai
        dai, daj = ai - alpha[i], aj - alpha[j]
        if abs(dai) < _TAU and abs(daj) < _TAU:
            break
        alpha[i], alpha[j] = ai, aj
        G += K[i] * dai + K[j] * daj
    return alpha, _rho(alpha, G), it + 1


_LIB = None


def build() -> str:
    """Compile `native/svm_smo.cpp` unless the library for its hash exists;
    raises RuntimeError when there is no g++ or the compile fails."""
    return cached_build([SOURCE], host_cxx, CXX_FLAGS, BUILD_DIR, "libcia_smo")[0]


def library() -> ctypes.CDLL:
    """The loaded solver library (built on first use)."""
    global _LIB
    if _LIB is None:
        dbl = ctypes.POINTER(ctypes.c_double)
        # K (l*l), l, tol, max_iter, alpha (l) and G (l), both in and out
        _LIB = load(build(), {"smo_one_class_iterate": [
            dbl, ctypes.c_int, ctypes.c_double, ctypes.c_long, dbl, dbl]},
            restype=ctypes.c_long)
    return _LIB


def smo_one_class(
    K: np.ndarray, nu: float, tol: float = 1e-3, max_iter: int | None = None
) -> tuple[np.ndarray, float, int]:
    """`smo_one_class_np` in C++: (alpha, rho, n_iter)."""
    lib = library()
    K, alpha, G, max_iter = _start(K, nu, max_iter)
    dbl = ctypes.POINTER(ctypes.c_double)
    iters = lib.smo_one_class_iterate(K.ctypes.data_as(dbl), ctypes.c_int(K.shape[0]),
                                      ctypes.c_double(tol), ctypes.c_long(max_iter),
                                      alpha.ctypes.data_as(dbl), G.ctypes.data_as(dbl))
    return alpha, _rho(alpha, G), int(iters)
