"""PyTorch port: weights and scoring state carried over from the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_scoring, scoring_arrays, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import (
    cae_state_from_jax,
    load_scoring_params,
    load_unet_variables,
    unet_state_from_jax,
)
from cell_image_analysis_tpu_torch.models.cae import CAE
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet

torch_threads()


def test_unet_weights_round_trip():
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    ref = load_synthetic_unet_variables()["params"]
    variables = load_unet_variables()
    model = StarDistUNet()
    model.load_state_dict(unet_state_from_jax(variables))  # strict: every Conv_i
    state = model.state_dict()
    assert set(ref) == {k.split(".")[1] for k in state}
    for name, layer in ref.items():
        back = state[f"convs.{name}.weight"].numpy().transpose(2, 3, 1, 0)   # OIHW -> HWIO
        np.testing.assert_array_equal(back, np.asarray(layer["kernel"]))
        np.testing.assert_array_equal(state[f"convs.{name}.bias"].numpy(),
                                      np.asarray(layer["bias"]))


def test_unet_weights_reject_foreign_pickle(tmp_path):
    import pickle

    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps({"magic": "something-else", "params": {}}))
    with pytest.raises(ValueError):
        load_unet_variables(str(path))


def test_cae_carry_over_matches_flax():
    from cell_image_analysis_tpu.models.cae import init_cae

    model_j, variables = init_cae(jax.random.PRNGKey(3))
    # non-trivial BatchNorm statistics so that the carried stats matter
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
                         variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    model_t = CAE().eval()   # inference: BatchNorm on the carried running statistics
    model_t.load_state_dict(cae_state_from_jax(variables))
    x = rng.uniform(size=(4, 64, 64, 1)).astype(np.float32)
    dec_j, enc_j = model_j.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        dec_t, enc_t = model_t(torch.from_numpy(x))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), atol=1e-5)
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j),
                               atol=1e-5 * float(np.abs(np.asarray(enc_j)).max()))


def test_scoring_asset_loads_into_both_packages():
    arrays = scoring_arrays()
    model_t, params_t = load_scoring_params(device="cpu")
    _, params_j = jax_scoring()
    for name in ("scaler_center", "scaler_scale", "pca_mean", "pca_components",
                 "ensemble_mse_threshold", "fft_scaler_center", "fft_scaler_scale"):
        np.testing.assert_array_equal(getattr(params_t, name).numpy(), arrays[name])
        np.testing.assert_array_equal(np.asarray(getattr(params_j, name)), arrays[name])
    for svm in ("conservative", "moderate", "fft"):
        t = getattr(params_t, f"svm_{svm}")
        for f in t._fields:
            np.testing.assert_array_equal(getattr(t, f).numpy(), arrays[f"svm_{svm}/{f}"])
    state = model_t.state_dict()
    np.testing.assert_array_equal(
        state["convs.0.weight"].numpy().transpose(2, 3, 1, 0),
        arrays["cae/params/Conv_0/kernel"])
    np.testing.assert_array_equal(state["bns.5.running_var"].numpy(),
                                  arrays["cae/batch_stats/BatchNorm_5/var"])


def test_scoring_asset_is_the_bench_fit():
    """The committed npz is what scripts/make_torch_port_assets.py writes."""
    import importlib.util
    import os

    from cell_image_analysis_tpu.utils.bench import _fit_params

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                        "make_torch_port_assets.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_assets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, params, _ = _fit_params(seed=0)
    fresh = mod.scoring_arrays(params)
    committed = scoring_arrays()
    assert set(fresh) == set(committed)
    assert os.path.getsize(mod.OUT) < 1 << 20
    for k in fresh:
        np.testing.assert_allclose(fresh[k], committed[k], rtol=1e-6, atol=1e-7, err_msg=k)
