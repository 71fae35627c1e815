"""PyTorch port: the reference's own model files (`io/keras_interop.py`).

Genuine Keras models and sklearn estimators, built here with the keras
and sklearn of the test environment, are converted to the port's classes:

- the Keras CAE twin with random weights and BatchNorm statistics: the
  port's CAE forward within 1e-5 of `keras.predict` and of the JAX
  package's conversion, also through a saved `.keras` file and
  `io.artifacts.load_cae`; the port's CAE exported and read back by Keras;
- the Keras U-Net twin (8 rays, base 4, head 16, 64^2): both heads within
  1e-5 of `keras.predict` and of JAX's conversion; a port state exported
  to the twin and back;
- the sklearn scaler, PCA and one-class SVM against sklearn's `transform`
  and `decision_function` (1e-4, 1e-4, 2e-4: float32 against float64);
- a model directory in the reference's format (three `.keras` files and
  four sklearn pickles) screened by the port's `ProductionMutantScreening`
  on the CPU and by the JAX screener: the same cells, scores within 1e-4,
  the same predictions away from a threshold.
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
pytest.importorskip("sklearn")

from torch_port_helpers import torch_threads  # noqa: E402

from cell_image_analysis_tpu_torch.io import keras_interop as ki  # noqa: E402
from cell_image_analysis_tpu_torch.io.artifacts import load_cae  # noqa: E402
from cell_image_analysis_tpu_torch.models.cae import CAE, init_cae  # noqa: E402
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet, init_unet  # noqa: E402

torch_threads()

TOL = 1e-5
ARCH = dict(n_rays=8, base_filters=4, head_filters=16)


def _randomize_bn(model, rng) -> None:
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            g, b, m, v = layer.get_weights()
            layer.set_weights([rng.uniform(0.5, 1.5, g.shape).astype(np.float32),
                               rng.normal(0, 0.2, b.shape).astype(np.float32),
                               rng.normal(0, 0.2, m.shape).astype(np.float32),
                               rng.uniform(0.5, 1.5, v.shape).astype(np.float32)])


def _port_cae(model: CAE, x: np.ndarray):
    with torch.no_grad():
        dec, enc = model.eval()(torch.tensor(x))
    return dec.numpy(), enc.numpy()


def test_keras_cae_converts_to_the_port(rng, tmp_path):
    import jax.numpy as jnp

    from cell_image_analysis_tpu.io.keras_interop import cae_variables_from_keras
    from cell_image_analysis_tpu.models.cae import CAE as JaxCAE
    from cell_image_analysis_tpu.models.cae import forward as jax_forward

    autoencoder, encoder = ki.build_keras_cae()
    _randomize_bn(autoencoder, rng)
    x = rng.uniform(size=(4, 64, 64, 1)).astype(np.float32)
    k_dec = np.asarray(autoencoder.predict(x, verbose=0))
    k_enc = np.asarray(encoder.predict(x, verbose=0))
    model = CAE()
    model.load_state_dict(ki.cae_state_from_keras(autoencoder))
    dec, enc = _port_cae(model, x)
    np.testing.assert_allclose(dec, k_dec, rtol=0, atol=TOL)
    np.testing.assert_allclose(enc, k_enc, rtol=0, atol=TOL)
    j_dec, j_enc = jax_forward(JaxCAE(), cae_variables_from_keras(autoencoder), jnp.asarray(x))
    np.testing.assert_allclose(dec, np.asarray(j_dec), rtol=0, atol=TOL)
    np.testing.assert_allclose(enc, np.asarray(j_enc), rtol=0, atol=TOL)

    path = str(tmp_path / "best_autoencoder.keras")
    autoencoder.save(path)
    loaded, variables = load_cae(path)
    assert loaded.encoder_filters == (32, 64, 32) and not loaded.training
    assert variables["params"]["Conv_0"]["kernel"].shape == (3, 3, 1, 32)
    np.testing.assert_allclose(_port_cae(loaded, x)[0], k_dec, rtol=0, atol=TOL)


def test_port_cae_exports_a_keras_file(rng, tmp_path):
    model = init_cae(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for bn in model.bns:
            bn.running_mean.normal_(0, 0.2, generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "export.keras")
    ki.export_keras_cae(model, path)
    km = keras.models.load_model(path, compile=False)
    x = rng.uniform(size=(3, 64, 64, 1)).astype(np.float32)
    np.testing.assert_allclose(_port_cae(model, x)[0], np.asarray(km.predict(x, verbose=0)),
                               rtol=0, atol=TOL)


def test_keras_unet_converts_to_the_port(rng):
    import jax.numpy as jnp

    from cell_image_analysis_tpu.io.keras_interop import unet_variables_from_keras
    from cell_image_analysis_tpu.models.unet import StarDistUNet as JaxUNet

    km = ki.build_keras_stardist_unet(input_size=64, **ARCH)
    x = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    k_prob, k_dist = (np.asarray(a) for a in km.predict(x, verbose=0))
    model = StarDistUNet(**ARCH)
    model.load_state_dict(ki.unet_state_from_keras(km))
    with torch.no_grad():
        prob, dist = (t.numpy() for t in model.forward_train(torch.tensor(x)))
    np.testing.assert_allclose(prob, k_prob[..., 0], rtol=0, atol=TOL)
    np.testing.assert_allclose(dist, k_dist, rtol=0, atol=TOL * max(1.0, np.abs(k_dist).max()))
    j_prob, j_dist = JaxUNet(**ARCH).apply(unet_variables_from_keras(km), jnp.asarray(x))
    np.testing.assert_allclose(prob, np.asarray(j_prob), rtol=0, atol=TOL)
    np.testing.assert_allclose(dist, np.asarray(j_dist), rtol=0,
                               atol=TOL * max(1.0, np.abs(k_dist).max()))


def test_port_unet_state_goes_to_the_keras_twin_and_back(rng):
    model = init_unet(5, device="cpu", **ARCH)
    km = ki.keras_unet_from_state(model.state_dict(), input_size=64, **ARCH)
    x = rng.uniform(size=(1, 64, 64, 1)).astype(np.float32)
    k_prob, _ = km.predict(x, verbose=0)
    with torch.no_grad():
        prob, _ = model.forward_train(torch.tensor(x))
    np.testing.assert_allclose(prob.numpy(), np.asarray(k_prob)[..., 0], rtol=0, atol=TOL)
    back = ki.unet_state_from_keras(km)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="layer count"):
        ki.keras_unet_from_state(model.state_dict(), input_size=64, n_rays=8, base_filters=4,
                                 head_filters=16, depth=2)


def _sk_data(rng):
    return rng.normal(size=(128, 24)).astype(np.float64)


@pytest.mark.parametrize("kind", ["scaler", "pca", "ocsvm"])
def test_sklearn_estimators_convert_to_the_ports(rng, kind):
    from sklearn.decomposition import PCA as SkPCA
    from sklearn.preprocessing import RobustScaler as SkRobustScaler
    from sklearn.svm import OneClassSVM as SkOneClassSVM

    from cell_image_analysis_tpu_torch.models.pca import PCA
    from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
    from cell_image_analysis_tpu_torch.models.svm import OneClassSVM

    X = _sk_data(rng)
    if kind == "scaler":
        sk = SkRobustScaler().fit(X)
        ours = ki.convert_estimator(sk)
        assert type(ours) is RobustScaler
        np.testing.assert_allclose(ours.transform(X).numpy(), sk.transform(X), atol=1e-4)
    elif kind == "pca":
        sk = SkPCA(n_components=8).fit(X)
        ours = ki.convert_estimator(sk)
        assert type(ours) is PCA and ours.n_components == 8
        np.testing.assert_allclose(ours.transform(X).numpy(), sk.transform(X), atol=1e-4)
    else:
        sk = SkOneClassSVM(kernel="rbf", gamma="scale", nu=0.1).fit(X)
        ours = ki.convert_estimator(sk)
        assert type(ours) is OneClassSVM and ours.nu == 0.1
        np.testing.assert_allclose(ours.decision_function(X), sk.decision_function(X),
                                   atol=2e-4)
        np.testing.assert_array_equal(ours.predict(X)[np.abs(sk.decision_function(X)) > 2e-4],
                                      sk.predict(X)[np.abs(sk.decision_function(X)) > 2e-4])
        with pytest.raises(ValueError, match="rbf"):
            ki.convert_estimator(SkOneClassSVM(kernel="linear").fit(X))
    assert ki.convert_estimator(ours) is ours


def _reference_model_dir(root, rng) -> str:
    """What the reference's training leaves: genuine Keras saves of the CAE
    and sklearn pickles fitted on its encoder's features."""
    from sklearn.decomposition import PCA as SkPCA
    from sklearn.preprocessing import RobustScaler as SkRobustScaler
    from sklearn.svm import OneClassSVM as SkOneClassSVM

    d = os.path.join(root, "ref_model")
    os.makedirs(d)
    autoencoder, encoder = ki.build_keras_cae()
    _randomize_bn(autoencoder, rng)
    for name in ("best_autoencoder.keras", "final_autoencoder.keras"):
        autoencoder.save(os.path.join(d, name))
    encoder.save(os.path.join(d, "encoder.keras"))
    X = rng.uniform(size=(96, 64, 64, 1)).astype(np.float32)
    feats = np.asarray(encoder.predict(X, verbose=0)).reshape(len(X), -1)
    scaler = SkRobustScaler().fit(feats)
    pca = SkPCA(n_components=16).fit(scaler.transform(feats))
    reduced = pca.transform(scaler.transform(feats))
    for name, est in (("scaler.pkl", scaler), ("pca.pkl", pca),
                      ("detector_conservative.pkl",
                       SkOneClassSVM(kernel="rbf", gamma="scale", nu=0.05).fit(reduced)),
                      ("detector_moderate.pkl",
                       SkOneClassSVM(kernel="rbf", gamma="scale", nu=0.10).fit(reduced))):
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(est, f)
    return d


def test_reference_model_directory_screens_like_jax(rng, tmp_path):
    from cell_image_analysis_tpu.config import PipelineConfig as JaxPipelineConfig
    from cell_image_analysis_tpu.config import SegConfig as JaxSegConfig
    from cell_image_analysis_tpu.pipeline.screening import (
        ProductionMutantScreening as JaxScreening,
    )
    from cell_image_analysis_tpu_torch.config import PipelineConfig, SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_screening_artifacts
    from cell_image_analysis_tpu_torch.models.pca import PCA
    from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
    from cell_image_analysis_tpu_torch.models.svm import OneClassSVM
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    model_dir = _reference_model_dir(str(tmp_path), rng)
    _, _, scaler, pca, detectors, ensemble = load_screening_artifacts(model_dir)
    assert type(scaler) is RobustScaler and type(pca) is PCA and ensemble is None
    assert {type(d) for d in detectors.values()} == {OneClassSVM}

    folder = str(tmp_path / "wt")
    make_dataset(folder, n_frames=2, size=256, n_cells=14, seed=5)
    runs = {}
    for side, make in (
            ("port", lambda: ProductionMutantScreening(
                model_dir, PipelineConfig(seg=SegConfig(backend="threshold")), None,
                device="cpu")),
            ("jax", lambda: JaxScreening(
                model_dir, JaxPipelineConfig(seg=JaxSegConfig(backend="threshold")), None))):
        with contextlib.redirect_stdout(io.StringIO()):
            runs[side] = make().screen_mutant_samples({"wildtype": folder},
                                                      str(tmp_path / f"out_{side}"))
    (res, det), (res_j, det_j) = runs["port"], runs["jax"]
    assert res["wildtype"]["total_cells"] == res_j["wildtype"]["total_cells"] >= 10
    assert len(det) == len(det_j)
    for a, b in zip(det, det_j):
        assert a["cell_id"] == b["cell_id"]
        for k in ("mse", "mae", "conservative_score", "moderate_score"):
            assert abs(a[k] - b[k]) <= 1e-4, (a["cell_id"], k)
        for flag, score in (("conservative_anomaly", "conservative_score"),
                            ("moderate_anomaly", "moderate_score")):
            assert a[flag] == b[flag] or abs(b[score]) <= 1e-4, (a["cell_id"], flag)
