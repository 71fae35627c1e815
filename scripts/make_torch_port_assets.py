#!/usr/bin/env python
"""Write assets/scoring_synthetic.npz: the bench's scoring parameters as
plain named numpy arrays, for the PyTorch port (which runs without JAX).

The arrays are `utils/bench._fit_params(seed=0)` — the CAE variables,
RobustScaler, PCA, the three one-class SVMs, the FFT scaler and the
ensemble threshold — fitted here with the JAX package on the CPU.  The
port loads them with
`cell_image_analysis_tpu_torch.io.artifacts.load_scoring_params`, and its
tests feed the same file to both packages.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_assets.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

OUT = os.path.join(_REPO, "assets", "scoring_synthetic.npz")


def scoring_arrays(params) -> dict:
    """Flatten a JAX ScoringParams into `name -> np.ndarray` entries.

    CAE leaves are keyed `cae/<collection>/<layer>/<leaf>`; SVMs are keyed
    `svm_<name>/<field>`."""
    out = {}
    for coll, layers in params.cae_variables.items():
        for layer, leaves in layers.items():
            for leaf, v in leaves.items():
                out[f"cae/{coll}/{layer}/{leaf}"] = np.asarray(v, np.float32)
    for name in ("scaler_center", "scaler_scale", "pca_mean", "pca_components",
                 "ensemble_mse_threshold", "fft_scaler_center",
                 "fft_scaler_scale"):
        out[name] = np.asarray(getattr(params, name), np.float32)
    for name in ("conservative", "moderate", "fft"):
        svm = getattr(params, f"svm_{name}")
        for field in svm._fields:
            out[f"svm_{name}/{field}"] = np.asarray(getattr(svm, field), np.float32)
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cell_image_analysis_tpu.utils.bench import _fit_params

    _, params, _ = _fit_params(seed=0)
    arrays = scoring_arrays(params)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
