"""PyTorch port: `score_cells` with the committed scoring parameters against
JAX — identical predictions, scores within the tolerances of
tests/test_scoring.py (mse 1e-6, decision values 1e-4), FFT features
within 1e-5 — and the anti-aliased resize feeding it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_scoring, padded_crops, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
from cell_image_analysis_tpu_torch.ops.fft_features import fft_features
from cell_image_analysis_tpu_torch.ops.resize import resize_cells
from cell_image_analysis_tpu_torch.pipeline.scoring import score_cells

torch_threads()


def _cells(n=96):
    from cell_image_analysis_tpu.utils.synthetic import make_cells

    rng = np.random.default_rng(11)
    normal = make_cells(rng, n // 2)
    mutant = make_cells(rng, n - n // 2, mutant=True)
    return np.concatenate([normal, mutant])[..., None].astype(np.float32)


def test_score_cells_matches_jax():
    from cell_image_analysis_tpu.pipeline.scoring import score_cells as jax_score

    X = _cells()
    model_j, params_j = jax_scoring()
    sj = jax_score(model_j, params_j, jnp.asarray(X))
    model_t, params_t = load_scoring_params(device="cpu")
    st = score_cells(model_t, params_t, torch.from_numpy(X))
    for f in ("conservative_predictions", "moderate_predictions", "ensemble_predictions",
              "fft_predictions"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), f)
    # both classes occur, so the comparison is not vacuous
    assert set(np.unique(np.asarray(sj.moderate_predictions))) == {-1, 1}
    np.testing.assert_allclose(st.reconstruction_mse.numpy(), np.asarray(sj.reconstruction_mse),
                               atol=1e-6)
    np.testing.assert_allclose(st.reconstruction_mae.numpy(), np.asarray(sj.reconstruction_mae),
                               atol=1e-6)
    for f in ("conservative_scores", "moderate_scores", "fft_scores"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(st.fft.numpy(), np.asarray(sj.fft), rtol=1e-5, atol=1e-5)


def test_fft_features_match_jax():
    from cell_image_analysis_tpu.ops.fft_features import fft_features as jax_fft

    x = np.random.default_rng(2).uniform(size=(6, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(fft_features(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_fft(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [64, 96, 192])
def test_resize_cells_matches_jax(cap):
    from cell_image_analysis_tpu.ops.resize import resize_cells as jax_resize

    rng = np.random.default_rng(cap)
    sizes = [(cap, cap), (17, 40), (cap // 2 + 3, 13)]
    crops, hs, ws = padded_crops(rng, sizes, cap, scale=1.0, garbage=0.0)
    ref = np.asarray(jax_resize(jnp.asarray(crops), jnp.asarray(hs), jnp.asarray(ws)))
    got = resize_cells(torch.from_numpy(crops), torch.from_numpy(hs),
                       torch.from_numpy(ws)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
