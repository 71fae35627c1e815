"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages read the same committed assets: the U-Net weights
(assets/unet_synthetic.pkl) and the scoring parameters
(assets/scoring_synthetic.npz).  Inputs are made with numpy from a seed and
handed to both sides as arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from cell_image_analysis_tpu.config import SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import SCORING_PARAMS_PATH

# the screening bench's StarDist settings (utils/bench.py _batch_pipeline)
BENCH_SEG = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
BENCH_STAGE_A = dict(label_capacity=128, cell_capacity=128, rcap=32)


def scoring_arrays() -> dict:
    with np.load(SCORING_PARAMS_PATH) as z:
        return {k: z[k] for k in z.files}


def jax_scoring():
    """(flax CAE, JAX ScoringParams) built from the committed npz."""
    import jax.numpy as jnp

    from cell_image_analysis_tpu.models.cae import CAE
    from cell_image_analysis_tpu.models.svm import SVMParams
    from cell_image_analysis_tpu.pipeline.scoring import ScoringParams

    a = scoring_arrays()
    cae: dict = {}
    for key, v in a.items():
        if key.startswith("cae/"):
            _, coll, layer, leaf = key.split("/")
            cae.setdefault(coll, {}).setdefault(layer, {})[leaf] = jnp.asarray(v)

    def svm(name):
        return SVMParams(*(jnp.asarray(a[f"svm_{name}/{f}"]) for f in SVMParams._fields))

    params = ScoringParams(
        cae_variables=cae,
        scaler_center=jnp.asarray(a["scaler_center"]),
        scaler_scale=jnp.asarray(a["scaler_scale"]),
        pca_mean=jnp.asarray(a["pca_mean"]),
        pca_components=jnp.asarray(a["pca_components"]),
        svm_conservative=svm("conservative"),
        svm_moderate=svm("moderate"),
        ensemble_mse_threshold=jnp.asarray(a["ensemble_mse_threshold"]),
        fft_scaler_center=jnp.asarray(a["fft_scaler_center"]),
        fft_scaler_scale=jnp.asarray(a["fft_scaler_scale"]),
        svm_fft=svm("fft"),
    )
    return CAE(), params


def padded_crops(rng, sizes, cap, scale=3000.0, garbage=1e9):
    """(C, cap, cap) integer-valued crops of the given (h, w) sizes, with
    garbage in the padding (it must not affect any result)."""
    crops = np.full((len(sizes), cap, cap), garbage, np.float32)
    for i, (h, w) in enumerate(sizes):
        crops[i, :h, :w] = np.round(rng.uniform(size=(h, w)) * scale)
    hs = np.array([s[0] for s in sizes], np.int32)
    ws = np.array([s[1] for s in sizes], np.int32)
    return crops, hs, ws


def torch_threads() -> None:
    """The suite runs under several xdist workers: one thread each."""
    torch.set_num_threads(1)
