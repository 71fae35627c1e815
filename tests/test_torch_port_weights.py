"""PyTorch port: Keras `.h5` weights onto the port's U-Net
(`utils/port_weights.py`, `scripts/port_stardist_h5_torch.py`).

Mirrors the JAX package's `tests/test_port_weights.py`: a Keras-style
`.h5` written from one U-Net and ported onto a fresh one restores its
outputs (atol 1e-6: the same float32 weights); a file short of the head
layers raises with the report.  Beyond it: the port reads the JAX
package's `.h5` writer (the same arrays), a genuine Keras whole-model
`.h5` (both heads within 1e-5 of `keras.predict`), and the script turns
an `.h5` into a payload that the port's and the JAX package's loaders read
with the same arrays.  8 rays, base 4, head 16, 64^2 unless stated.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("h5py")

from torch_port_helpers import torch_threads  # noqa: E402

from cell_image_analysis_tpu_torch.io.artifacts import (  # noqa: E402
    load_unet_variables,
    unet_params_to_jax,
    unet_state_from_jax,
)
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet, init_unet  # noqa: E402
from cell_image_analysis_tpu_torch.utils.port_weights import (  # noqa: E402
    load_keras_h5_weights,
    port_conv_weights,
    save_keras_style_h5,
)

torch_threads()

ARCH = dict(n_rays=8, base_filters=4, head_filters=16)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _heads(model, x):
    with torch.no_grad():
        return tuple(t.numpy() for t in model.forward_train(torch.tensor(x)))


def test_h5_roundtrip_restores_unet_outputs(tmp_path, rng):
    model = init_unet(3, device="cpu", **ARCH)
    path = str(tmp_path / "w.h5")
    save_keras_style_h5(path, model.state_dict())
    fresh = init_unet(99, device="cpu", **ARCH)
    x = rng.uniform(size=(1, 64, 64, 1)).astype(np.float32)
    prob_ref, dist_ref = _heads(model, x)
    assert np.abs(_heads(fresh, x)[0] - prob_ref).max() > 1e-4
    fresh.load_state_dict(port_conv_weights(fresh.state_dict(), load_keras_h5_weights(path)))
    prob, dist = _heads(fresh, x)
    np.testing.assert_allclose(prob, prob_ref, atol=1e-6)
    np.testing.assert_allclose(dist, dist_ref, atol=1e-6)


def test_port_reports_shape_mismatch(tmp_path):
    model = init_unet(3, device="cpu", **ARCH)
    path = str(tmp_path / "w.h5")
    save_keras_style_h5(path, model.state_dict())
    layers = load_keras_h5_weights(path)
    with pytest.raises(ValueError, match="conv layers"):
        port_conv_weights(model.state_dict(), layers[:-2])   # the two heads dropped
    wrong = [(n, [np.zeros(a[0].shape[:3] + (a[0].shape[3] + 1,), np.float32), a[1]])
             if n == "Conv_5" else (n, a) for n, a in layers]
    # Conv_5 takes Conv_9's twin, so Conv_9 finds none: the report lists the pairs
    with pytest.raises(ValueError, match=r"for Conv_9; assignments so far: \[\('Conv_0', "
                                         r"'Conv_0'\).*\('Conv_5', 'Conv_9'\)"):
        port_conv_weights(model.state_dict(), wrong)


def test_reads_the_jax_packages_h5(tmp_path):
    import jax

    from cell_image_analysis_tpu.models.unet import init_unet as jax_init
    from cell_image_analysis_tpu.utils.port_weights import save_keras_style_h5 as jax_save

    _, variables = jax_init(jax.random.PRNGKey(2), size=64, **ARCH)
    path = str(tmp_path / "jax.h5")
    jax_save(path, variables["params"])
    model = StarDistUNet(**ARCH)
    state = port_conv_weights(model.state_dict(), load_keras_h5_weights(path))
    ref = unet_state_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert state.keys() == ref.keys()
    assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_genuine_keras_h5_ports_onto_the_unet(tmp_path, rng):
    pytest.importorskip("keras")
    from cell_image_analysis_tpu_torch.io.keras_interop import build_keras_stardist_unet

    km = build_keras_stardist_unet(input_size=64, **ARCH)
    path = str(tmp_path / "stardist.h5")
    km.save(path)   # the legacy whole-model HDF5 format (a model_weights group)
    model = StarDistUNet(**ARCH)
    model.load_state_dict(port_conv_weights(model.state_dict(), load_keras_h5_weights(path)))
    x = rng.uniform(size=(1, 64, 64, 1)).astype(np.float32)
    k_prob, k_dist = (np.asarray(a) for a in km.predict(x, verbose=0))
    prob, dist = _heads(model, x)
    np.testing.assert_allclose(prob, k_prob[..., 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dist, k_dist, rtol=0, atol=1e-5 * max(1.0, np.abs(k_dist).max()))


def test_port_script_writes_a_payload_both_packages_read(tmp_path):
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    v = load_unet_variables()
    model = StarDistUNet()
    model.load_state_dict(unet_state_from_jax(v["params"]))
    h5 = str(tmp_path / "weights_best.h5")
    save_keras_style_h5(h5, model.state_dict())
    out = str(tmp_path / "ported.pkl")
    r = subprocess.run([sys.executable, os.path.join(_REPO, "scripts", "port_stardist_h5_torch.py"),
                        h5, "--out", out, "--device", "cpu"], capture_output=True, text=True,
                       cwd=_REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "prob range [" in r.stdout
    got = load_unet_variables(out)["params"]
    jax_got = load_synthetic_unet_variables(out)["params"]
    for name, layer in v["params"].items():
        for leaf, a in layer.items():
            np.testing.assert_array_equal(got[name][leaf], a)
            np.testing.assert_array_equal(np.asarray(jax_got[name][leaf]), a)
    assert unet_params_to_jax(model.state_dict()).keys() == got.keys()

    # `cli screen --unet-weights` takes the converted payload
    from cell_image_analysis_tpu_torch import cli

    p = argparse.ArgumentParser()
    cli.add_screen_arguments(p)
    unet = cli.load_unet(p.parse_args(["--models", "m", "--sample", "a=b", "--unet-weights",
                                       out]))
    assert all(np.array_equal(unet["params"][n]["kernel"], v["params"][n]["kernel"])
               for n in v["params"])


def test_missing_h5py_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        load_keras_h5_weights(str(tmp_path / "any.h5"))
    with pytest.raises(ImportError, match="h5py"):
        save_keras_style_h5(str(tmp_path / "any.h5"), {})
