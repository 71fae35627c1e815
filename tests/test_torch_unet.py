"""PyTorch port: a narrow StarDist U-Net (base 4, head 16), randomly
initialized in JAX and carried over, against the JAX forward that the
screening path runs (`unet_apply_late`: prob + head features)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import unet_state_from_jax
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet

torch_threads()


def _models():
    from cell_image_analysis_tpu.models.unet import init_unet

    model_j, variables = init_unet(jax.random.PRNGKey(1), size=64, base_filters=4,
                                   head_filters=16)
    model_t = StarDistUNet(base_filters=4, head_filters=16)
    model_t.load_state_dict(unet_state_from_jax(variables))
    return model_j, variables, model_t


def test_unet_forward_matches_jax():
    from cell_image_analysis_tpu.models.unet import unet_apply_late

    model_j, variables, model_t = _models()
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 1)).astype(np.float32)
    prob_j, feat_j = unet_apply_late(model_j, variables, jnp.asarray(x))
    with torch.no_grad():
        prob_t, feat_t = model_t(torch.from_numpy(x))
    assert prob_t.shape == (2, 32, 32) and feat_t.shape == (2, 32, 32, 16)
    np.testing.assert_allclose(prob_t.numpy(), np.asarray(prob_j), rtol=0, atol=1e-5)
    scale = float(np.abs(np.asarray(feat_j)).max())
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), rtol=0, atol=1e-5 * scale)


def test_dist_head_rows_matches_jax():
    from cell_image_analysis_tpu.models.unet import dist_head_rows

    _, variables, model_t = _models()
    rows = np.random.default_rng(1).uniform(size=(40, 16)).astype(np.float32)
    ref = np.asarray(dist_head_rows(variables, jnp.asarray(rows)))
    with torch.no_grad():
        got = model_t.dist_head_rows(torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
