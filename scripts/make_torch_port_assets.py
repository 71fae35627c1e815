#!/usr/bin/env python
"""Write the PyTorch port's assets with the JAX package (the port runs
without JAX): assets/scoring_synthetic.npz, the bench's scoring parameters
as plain named numpy arrays, and assets/screening_store_synthetic/, a model
directory as training writes it.

The arrays are `utils/bench._fit_params(seed=0)` — the CAE variables,
RobustScaler, PCA, the three one-class SVMs, the FFT scaler and the
ensemble threshold — fitted here with the JAX package on the CPU.  The
port loads them with
`cell_image_analysis_tpu_torch.io.artifacts.load_scoring_params`, and its
tests feed the same file to both packages.

The store is written by the JAX package's own `save_training_artifacts`
from `_fit_params(seed=0, X=cells)`, where `cells` are what the JAX
screener's `extract_quality_cells` (threshold backend) takes from
`make_dataset(n_frames=8, size=1024, n_cells=80, seed=11)`: fitted on
pipeline-extracted cells, so screened frames do not all score as
anomalies.  The port reads it with
`cell_image_analysis_tpu_torch.io.artifacts.load_screening_artifacts`.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_assets.py [--only store|npz]
"""

from __future__ import annotations

import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

OUT = os.path.join(_REPO, "assets", "scoring_synthetic.npz")
STORE = os.path.join(_REPO, "assets", "screening_store_synthetic")


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


def extracted_cells() -> np.ndarray:
    """(N, 64, 64, 1) cells of 8 synthetic 1024^2 frames through the JAX
    screener's `extract_quality_cells`, threshold backend."""
    import dataclasses
    import tempfile

    from cell_image_analysis_tpu.config import PipelineConfig, SegConfig
    from cell_image_analysis_tpu.io.ingest import split_channels
    from cell_image_analysis_tpu.io.tiff import imread
    from cell_image_analysis_tpu.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu.utils.synthetic import make_dataset

    screener = ProductionMutantScreening.__new__(ProductionMutantScreening)  # no store to load yet
    screener.config = dataclasses.replace(PipelineConfig(), seg=SegConfig(backend="threshold"))
    screener.unet_variables = None
    cells = []
    with tempfile.TemporaryDirectory() as tmp:
        for path in make_dataset(tmp, n_frames=8, size=1024, n_cells=80, seed=11):
            c, _ = screener.extract_quality_cells(*split_channels(imread(path)))
            cells.append(c)
    return np.concatenate(cells)[..., None].astype(np.float32)


def write_store() -> None:
    from cell_image_analysis_tpu.io.artifacts import save_training_artifacts
    from cell_image_analysis_tpu.utils.bench import _fit_params

    X = extracted_cells()
    _, _, host = _fit_params(seed=0, X=X)
    save_training_artifacts(
        STORE, host["model"], host["variables"], host["variables"], host["scaler"],
        host["pca"], {"Conservative": host["cons"], "Moderate": host["mod"]}, host["ens"],
        fft_scaler=host["fft_scaler"], fft_detector=host["fft_det"])
    files = sorted(os.listdir(STORE))
    size = sum(os.path.getsize(os.path.join(STORE, f)) for f in files)
    print(f"wrote {STORE}: fitted on {len(X)} cells, {len(files)} files, {size} bytes")


def main() -> None:
    import argparse

    import jax

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["store", "npz"], default=None)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    from cell_image_analysis_tpu.utils.bench import _fit_params

    if args.only != "store":
        _, params, _ = _fit_params(seed=0)
        arrays = scoring_arrays(params)
        np.savez_compressed(OUT, **arrays)
        print(f"wrote {OUT}: {len(arrays)} arrays, {os.path.getsize(OUT)} bytes")
    if args.only != "npz":
        write_store()


if __name__ == "__main__":
    main()
