"""PyTorch port: reading the store that the JAX package's training writes.

A store is written here by `save_training_artifacts` from
`utils/bench._fit_params`' `host` dict and read by the port without the JAX
package: the `ScoringParams` equal JAX `build_scoring_params`' leaf for
leaf, with and without the FFT files and `ensemble.json`; the CAE carries
the same weights (same reconstruction, atol 1e-5); the refusals refuse.
The committed `assets/screening_store_synthetic` reads the same way.
"""

import io
import os
import pickle
import shutil
import zipfile

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads, write_jax_store

from cell_image_analysis_tpu_torch import config as C
from cell_image_analysis_tpu_torch.io import artifacts

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMMITTED = os.path.join(_REPO, "assets", "screening_store_synthetic")
_LEAVES = ("scaler_center", "scaler_scale", "pca_mean", "pca_components",
           "ensemble_mse_threshold", "fft_scaler_center", "fft_scaler_scale")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("store"))
    write_jax_store(path)
    return path


def _variant(store, tmp_path, fft: bool, ensemble: bool) -> str:
    path = str(tmp_path / "variant")
    shutil.copytree(store, path)
    if not fft:
        os.remove(os.path.join(path, "detector_fft.pkl"))
        os.remove(os.path.join(path, "fft_scaler.pkl"))
    if not ensemble:
        os.remove(os.path.join(path, "ensemble.json"))
    return path


def _jax_params(path):
    from cell_image_analysis_tpu.io import artifacts as jax_artifacts

    loaded = jax_artifacts.load_screening_artifacts(path)
    return loaded, jax_artifacts.build_scoring_params(*loaded)


def _assert_params_equal(got, ref):
    for name in _LEAVES:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for svm in ("svm_conservative", "svm_moderate", "svm_fft"):
        for field in ("support_vectors", "dual_coef", "rho", "gamma"):
            a = getattr(getattr(got, svm), field).numpy()
            b = np.asarray(getattr(getattr(ref, svm), field))
            assert a.dtype == np.float32 and a.shape == b.shape, (svm, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{svm}.{field}")


@pytest.mark.parametrize("fft,ensemble", [(True, True), (False, True), (True, False),
                                          (False, False)])
def test_scoring_params_equal_jax_leaf_for_leaf(store, tmp_path, fft, ensemble):
    path = _variant(store, tmp_path, fft, ensemble)
    _, ref = _jax_params(path)
    loaded = artifacts.load_screening_artifacts(path)
    model, got = artifacts.build_scoring_params(*loaded, device="cpu")
    _assert_params_equal(got, ref)
    assert ("FFT" in loaded[4]) == fft and (loaded[5] is not None) == ensemble
    if not ensemble:
        assert float(got.ensemble_mse_threshold) == np.inf
    if not fft:
        assert got.svm_fft.support_vectors.shape == (1, 27)
        np.testing.assert_array_equal(got.fft_scaler_center.numpy(), np.zeros(27, np.float32))
        np.testing.assert_array_equal(got.fft_scaler_scale.numpy(), np.ones(27, np.float32))
    assert next(model.parameters()).device.type == "cpu" and not model.training


def test_loaded_classes_are_the_ports(store):
    from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector
    from cell_image_analysis_tpu_torch.models.pca import PCA
    from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
    from cell_image_analysis_tpu_torch.models.svm import OneClassSVM

    model, variables, scaler, pca, detectors, ensemble = artifacts.load_screening_artifacts(store)
    assert type(scaler) is RobustScaler and type(pca) is PCA
    assert type(ensemble) is EnsembleDetector and ensemble.min_votes == 2
    assert {k: type(v) for k, v in detectors.items()} == {
        "Conservative": OneClassSVM, "Moderate": OneClassSVM, "FFT": OneClassSVM,
        "FFT_scaler": RobustScaler}
    assert detectors["Conservative"].nu == 0.05 and detectors["Moderate"].nu == 0.10
    assert pca.components_.shape == (pca.n_components, 2048)
    assert set(variables) == {"params", "batch_stats"}


def test_cae_carries_the_same_weights(store):
    import jax.numpy as jnp

    (model_j, variables_j, *_), _ = _jax_params(store)
    model, _ = artifacts.load_cae(os.path.join(store, C.ARTIFACT_BEST_AUTOENCODER))
    X = np.random.default_rng(0).uniform(size=(5, 64, 64, 1)).astype(np.float32)
    ref, _ = model_j.apply(variables_j, jnp.asarray(X), train=False)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_build_scoring_params_defaults_to_the_card(store):
    loaded = artifacts.load_screening_artifacts(store)
    if torch.cuda.is_available():
        _, params = artifacts.build_scoring_params(*loaded)
        assert params.pca_mean.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            artifacts.build_scoring_params(*loaded)


def test_committed_store_reads_and_equals_jax():
    _, ref = _jax_params(_COMMITTED)
    _, got = artifacts.build_scoring_params(*artifacts.load_screening_artifacts(_COMMITTED),
                                            device="cpu")
    _assert_params_equal(got, ref)
    assert sorted(os.listdir(_COMMITTED)) == sorted([
        C.ARTIFACT_BEST_AUTOENCODER, C.ARTIFACT_FINAL_AUTOENCODER, C.ARTIFACT_ENCODER,
        C.ARTIFACT_SCALER, C.ARTIFACT_PCA, C.ARTIFACT_DETECTOR_CONSERVATIVE,
        C.ARTIFACT_DETECTOR_MODERATE, "detector_fft.pkl", "fft_scaler.pkl", "ensemble.json"])


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_refuses_a_pickle_that_names_os_system(store, tmp_path):
    path = _variant(store, tmp_path, True, True)
    with open(os.path.join(path, C.ARTIFACT_SCALER), "wb") as f:
        pickle.dump(_Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match=r"(posix|os|nt)\.system"):
        artifacts.load_screening_artifacts(path)


@pytest.mark.parametrize("protocol", [0, 2, 4, pickle.HIGHEST_PROTOCOL])
def test_reads_every_pickle_protocol(store, tmp_path, protocol):
    from cell_image_analysis_tpu.io.artifacts import _load_pickle

    path = _variant(store, tmp_path, True, True)
    for name in (C.ARTIFACT_SCALER, C.ARTIFACT_PCA, C.ARTIFACT_DETECTOR_MODERATE):
        with open(os.path.join(path, name), "wb") as f:
            pickle.dump(_load_pickle(os.path.join(store, name)), f, protocol=protocol)
    _, ref = _jax_params(store)
    _, got = artifacts.build_scoring_params(*artifacts.load_screening_artifacts(path),
                                            device="cpu")
    _assert_params_equal(got, ref)


@pytest.mark.parametrize("core", ["numpy.core.multiarray", "numpy._core.multiarray"])
@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_both_spellings_of_numpys_core_are_let_through(core):
    """A pickle that names `_reconstruct` under either spelling of numpy's
    core package loads."""
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    data = pickle.dumps(arr, protocol=2)
    written = next(c for c in (b"numpy._core.multiarray", b"numpy.core.multiarray")
                   if c in data)
    data = data.replace(written, core.encode())
    assert core.encode() in data
    got = artifacts._StoreUnpickler(io.BytesIO(data)).load()
    np.testing.assert_array_equal(got, arr)


def test_keras_and_sklearn_files_name_keras_interop(store, tmp_path):
    path = _variant(store, tmp_path, True, True)
    with zipfile.ZipFile(os.path.join(path, C.ARTIFACT_BEST_AUTOENCODER), "w") as z:
        z.writestr("config.json", "{}")
    with pytest.raises(NotImplementedError, match="io/keras_interop"):
        artifacts.load_screening_artifacts(path)
    with open(os.path.join(path, C.ARTIFACT_BEST_AUTOENCODER), "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + b"\0" * 32)
    with pytest.raises(NotImplementedError, match="io/keras_interop"):
        artifacts.load_screening_artifacts(path)

    path2 = _variant(store, tmp_path / "b", True, True)
    # the opcodes of a pickled sklearn estimator: GLOBAL, EMPTY_TUPLE, NEWOBJ
    with open(os.path.join(path2, C.ARTIFACT_SCALER), "wb") as f:
        f.write(b"\x80\x02csklearn.preprocessing._data\nRobustScaler\n)\x81.")
    with pytest.raises(NotImplementedError, match="io/keras_interop"):
        artifacts.load_screening_artifacts(path2)


def test_wrong_magic_and_missing_files(store, tmp_path):
    path = _variant(store, tmp_path, True, True)
    with open(os.path.join(path, C.ARTIFACT_BEST_AUTOENCODER), "wb") as f:
        pickle.dump({"magic": "something else", "variables": {}}, f)
    with pytest.raises(ValueError, match="cae-v1"):
        artifacts.load_screening_artifacts(path)
    with pytest.raises(FileNotFoundError):
        artifacts.load_screening_artifacts(str(tmp_path / "nowhere"))
