"""PyTorch port: the detector fits of training against the JAX package.

- RobustScaler: fit (median, IQR, zero IQR -> 1) bit for bit, the same
  sort and float32 rank arithmetic; transform within 1e-6 relative.
- PCA: fit bit for bit (the same float64 numpy code on the host);
  transform within atol 1e-4 (float32 matmuls of two libraries).
- The RBF kernel matrix within atol 1e-6.
- SMO: the port's `smo_one_class_np` equals JAX's bit for bit; the port's
  C++ solver equals its numpy specification bit for bit; without a
  compiler `smo_one_class` raises instead of falling back.
- OneClassSVM on the same features: the same gamma and support vectors;
  alpha, rho and the decisions within SVM_TOL = 2e-3, and the same
  predictions but for decisions within SVM_TOL of 0 (the free support
  vectors sit on the boundary).  The float32 kernel matrices differ by up
  to ~1e-7; SMO stops at a KKT gap of 1e-3, and a different working-set
  step on the way can leave it at another point of that size (measured:
  alpha 7.2e-7 apart at nu 0.05, 7.6e-4 at nu 0.1).  The ensemble fit is
  equal.
- At 520 cells (`make_cells`, a fifth of them mutant), each package
  trains its own CAE with its own `fit_cae` from JAX's init (one epoch,
  augmentation off, numpy's permutation in both).  Three stores: the
  port's (its CAE, its detectors), JAX's detectors on the port's CAE
  carried across, and JAX's (its CAE, its detectors); the port's scoring
  reads each and scores the 520 cells.
  - The detector fits, on one CAE: every conservative, moderate, FFT and
    ensemble prediction of the port's store agrees with JAX's on the
    port's CAE, except cells whose decision lies within BAND of its
    threshold in either store (the ensemble: a vote within BAND, or an
    MSE within 1e-6 of the ensemble threshold), which are listed and
    counted; the free support vectors sit on the boundary, so about nu * n
    cells lie in the band.
  - Training end to end, each package's own CAE: the two CAEs drift apart
    (see CAE_GAP below), so the SVMs see different features and only the
    FFT detector, which does not read the CAE, agrees cell by cell.  The
    CAE leaf gap, the per-cell MSE and the ensemble threshold, the share
    of cells whose conservative / moderate / ensemble predictions differ
    and the anomaly counts are held to the measured values' gates.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.models import smo
from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector
from cell_image_analysis_tpu_torch.models.pca import PCA
from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
from cell_image_analysis_tpu_torch.models.svm import OneClassSVM, rbf_kernel

torch_threads()

BAND = 1e-3       # decision values this close to 0 may flip between the packages
SVM_TOL = 2e-3
N_CELLS = 520
# each package's CAE trained by its own fit_cae (one epoch, 13 steps from
# one init): the CAEs drift apart (Adam's per-weight normalisation turns
# gradient differences of 1e-4 on near-zero gradients into whole steps),
# so the SVMs are fitted on different features.  Measured: leaf gap
# 6.4e-2 (CAE_GAP), per-cell MSE 6.1e-3 and the ensemble threshold
# 4.9e-4 apart (MSE_RTOL), 31 / 44 / 28 of 520 conservative / moderate /
# ensemble predictions apart (DISAGREE_FRACTION), anomaly counts within 4
# (RATE_GAP)
CAE_GAP = 0.2
MSE_RTOL = 3e-2
DISAGREE_FRACTION = 0.15
RATE_GAP = 0.02


def _features(seed, n=300, d=48):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.1, 3.0, size=d)).astype(np.float32)
    X[:, 3] = 1.5                          # zero IQR -> scale 1
    X[: n // 2, 7] = 0.0
    return X


def _kernel(seed, n, gamma=0.05):
    X = np.random.default_rng(seed).normal(size=(n, 6))
    d2 = ((X[:, None] - X[None]) ** 2).sum(-1)
    return np.exp(-gamma * d2)


@pytest.mark.parametrize("seed", [0, 1])
def test_scaler_fit_equals_jax_bit_for_bit(seed):
    from cell_image_analysis_tpu.models.scaler import RobustScaler as JaxScaler

    X = _features(seed)
    got, ref = RobustScaler().fit(torch.tensor(X)), JaxScaler().fit(X)
    assert got.center_.dtype == ref.center_.dtype == np.float32
    np.testing.assert_array_equal(got.center_, ref.center_)
    np.testing.assert_array_equal(got.scale_, ref.scale_)
    assert got.scale_[3] == 1.0
    np.testing.assert_allclose(got.transform(X).numpy(), np.asarray(ref.transform(X)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,d,k", [(300, 48, 20), (40, 64, 100)])
def test_pca_fit_equals_jax_bit_for_bit(n, d, k):
    from cell_image_analysis_tpu.models.pca import PCA as JaxPCA

    X = _features(2, n, d)
    got, ref = PCA(n_components=k).fit(torch.tensor(X)), JaxPCA(n_components=k).fit(X)
    for name in ("mean_", "components_", "explained_variance_", "explained_variance_ratio_"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert got.components_.shape == (min(k, d, n - 1), d)
    np.testing.assert_allclose(got.transform(torch.tensor(X)).numpy(),
                               np.asarray(ref.transform(X)), rtol=0, atol=1e-4)


def test_rbf_matrix_within_1e6_of_jax():
    import jax.numpy as jnp

    from cell_image_analysis_tpu.models.svm import rbf_kernel as jax_rbf

    X = _features(3, 200, 30)
    gamma = np.float32(1.0 / (30 * X.astype(np.float64).var()))
    got = rbf_kernel(torch.tensor(X), torch.tensor(X), torch.tensor(gamma)).numpy()
    ref = np.asarray(jax_rbf(jnp.asarray(X), jnp.asarray(X), jnp.float32(gamma)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,nu", [(64, 0.5), (257, 0.05), (300, 0.1), (120, 0.3)])
def test_smo_numpy_equals_jax_bit_for_bit(n, nu):
    from cell_image_analysis_tpu.models.smo import smo_one_class_np as jax_smo

    K = _kernel(n, n)
    (a, rho, it), (ra, rrho, rit) = smo.smo_one_class_np(K, nu), jax_smo(K, nu)
    assert it == rit and rho == rrho
    np.testing.assert_array_equal(a, ra)


@pytest.mark.parametrize("n,nu", [(64, 0.5), (257, 0.05), (300, 0.1), (500, 0.1), (3, 0.9)])
def test_smo_cpp_equals_numpy_bit_for_bit(n, nu):
    K = _kernel(n + 1, n)
    (a, rho, it), (ra, rrho, rit) = smo.smo_one_class(K, nu), smo.smo_one_class_np(K, nu)
    assert it == rit and rho == rrho
    np.testing.assert_array_equal(a, ra)


def test_smo_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    monkeypatch.setattr(smo, "_LIB", None)
    monkeypatch.setattr(smo, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="compiler"):
        smo.smo_one_class(_kernel(0, 8), 0.5)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(smo, "SOURCE", str(bad))
    monkeypatch.delenv("CXX")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        smo.smo_one_class(_kernel(0, 8), 0.5)


def test_smo_library_is_built_once_into_the_build_dir():
    path = smo.build()
    assert os.path.exists(path) and smo.build() == path
    assert os.sep + os.path.join("build", "host_native") + os.sep in path
    assert smo.library() is smo.library()


@pytest.mark.parametrize("nu", [0.05, 0.1])
def test_svm_fit_equals_jax(nu):
    from cell_image_analysis_tpu.models.svm import OneClassSVM as JaxSVM

    X = _features(4, 260, 20)
    got, ref = OneClassSVM(nu=nu).fit(torch.tensor(X)), JaxSVM(nu=nu).fit(X)
    assert got.gamma_ == ref.gamma_
    np.testing.assert_array_equal(got.support_vectors_, ref.support_vectors_)
    np.testing.assert_allclose(got.dual_coef_, ref.dual_coef_, rtol=0, atol=SVM_TOL)
    assert abs(got.intercept_ - ref.intercept_) < SVM_TOL
    d_ref = np.asarray(ref.decision_function(X))
    np.testing.assert_allclose(got.decision_function(X), d_ref, rtol=0, atol=SVM_TOL)
    clear = np.abs(d_ref) > SVM_TOL
    assert (~clear).sum() <= len(ref.support_vectors_)
    np.testing.assert_array_equal(got.predict(X)[clear], ref.predict(X)[clear])


def test_ensemble_fit_equals_jax():
    from cell_image_analysis_tpu.config import EnsembleConfig as JaxEnsembleConfig
    from cell_image_analysis_tpu.models.ensemble import EnsembleDetector as JaxEnsemble

    mse = np.random.default_rng(5).gamma(2.0, 0.01, size=333).astype(np.float32)
    got, ref = EnsembleDetector.fit(mse), JaxEnsemble.fit(mse, JaxEnsembleConfig())
    assert got == EnsembleDetector(ref.mse_threshold, ref.min_votes)
    rng = np.random.default_rng(6)
    cons, mod = rng.choice([-1, 1], 333), rng.choice([-1, 1], 333)
    np.testing.assert_array_equal(got.predict(mse, cons, mod), ref.predict(mse, cons, mod))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(cells, store dirs, CAE gap).  Each package trains its own CAE with
    its own `fit_cae` from JAX's init (augmentation off, numpy's
    permutation in both).  Three stores: "port" (the port's CAE and
    detectors), "jax_on_port_cae" (JAX's detectors on the port's CAE,
    carried across) and "jax" (JAX's CAE and detectors).  `gap`: the
    largest |w_port - w_jax| / |w_jax - w_init| over the CAE's leaves."""
    import jax
    import jax.numpy as jnp

    from cell_image_analysis_tpu import config as J
    from cell_image_analysis_tpu.models.cae import init_cae as jax_init
    from cell_image_analysis_tpu.pipeline.training import (
        ImprovedAnomalyDetectionTraining as JaxTraining,
    )
    from cell_image_analysis_tpu.train.trainer import fit_cae as jax_fit
    from cell_image_analysis_tpu.utils.synthetic import make_cells
    from cell_image_analysis_tpu_torch.config import AugmentConfig, PipelineConfig, TrainConfig
    from cell_image_analysis_tpu_torch.io.artifacts import cae_state_from_jax, cae_state_to_jax
    from cell_image_analysis_tpu_torch.models.cae import CAE
    from cell_image_analysis_tpu_torch.pipeline.training import ImprovedAnomalyDetectionTraining
    from cell_image_analysis_tpu_torch.train import trainer

    rng = np.random.default_rng(11)
    cells = np.concatenate([make_cells(rng, N_CELLS - N_CELLS // 5),
                            make_cells(rng, N_CELLS // 5, mutant=True)])
    seed = TrainConfig().seed
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))   # fit_cae's own init key
    _, jv0 = jax_init(init_key)
    start = cae_state_from_jax(jax.tree.map(np.asarray, jv0))

    def init(generator, **kw):
        m = CAE()
        m.load_state_dict(start)
        return m.to(generator.device)

    off = dict(rotation_range=0, width_shift_range=0, height_shift_range=0, zoom_range=0,
               horizontal_flip=False, vertical_flip=False)
    real = trainer.init_cae
    trainer.init_cae = init
    try:
        model, state, _ = trainer.fit_cae(torch.tensor(cells), train_cfg=TrainConfig(epochs=1),
                                          aug_cfg=AugmentConfig(**off), verbose=False)
    finally:
        trainer.init_cae = real
    jmodel, jv, _ = jax_fit(cells, train_cfg=J.TrainConfig(epochs=1),
                            aug_cfg=J.AugmentConfig(**off), verbose=False)
    jstate = cae_state_from_jax(jax.tree.map(np.asarray, jv))
    gap = max(float((state[k] - jstate[k]).norm() / (jstate[k] - start[k]).norm())
              for k in jstate if "running" not in k)

    root = tmp_path_factory.mktemp("detector_fit")
    dirs = {k: str(root / k) for k in ("port", "jax_on_port_cae", "jax")}
    carried = jax.tree.map(jnp.asarray, cae_state_to_jax(state))
    with contextlib.redirect_stdout(io.StringIO()):
        port = ImprovedAnomalyDetectionTraining(dirs["port"], PipelineConfig(), device="cpu")
        port._final_state = state
        port.create_anomaly_detector(model, state, cells)
        for key, variables in (("jax_on_port_cae", carried), ("jax", jv)):
            ref = JaxTraining(dirs[key], J.PipelineConfig())
            ref._final_variables = variables
            ref.create_anomaly_detector(jmodel, variables, cells)
    return cells, dirs, gap


def _scores(model_dir, cells):
    from cell_image_analysis_tpu_torch.io.artifacts import (
        build_scoring_params,
        load_screening_artifacts,
    )
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_cells

    loaded = load_screening_artifacts(model_dir)
    model, params = build_scoring_params(*loaded, device="cpu")
    s = score_cells(model, params, torch.tensor(cells[..., None]))
    return {k: getattr(s, k).numpy() for k in s._fields}, params


def test_predictions_of_both_stores_agree_cell_by_cell(stores):
    cells, dirs, _ = stores
    (got, gp), (ref, rp) = _scores(dirs["port"], cells), _scores(dirs["jax_on_port_cae"], cells)
    n = len(cells)
    assert n >= 500
    near = {}
    for name, score in (("conservative", "conservative_scores"), ("moderate", "moderate_scores"),
                        ("fft", "fft_scores")):
        band = (np.abs(got[score]) < BAND) | (np.abs(ref[score]) < BAND)
        near[name] = np.flatnonzero(band).tolist()
        pred = f"{name}_predictions"
        diff = np.flatnonzero((got[pred] != ref[pred]) & ~band)
        assert not len(diff), f"{name}: cells {diff.tolist()} disagree outside the band"
    thr = float(gp.ensemble_mse_threshold)
    assert abs(thr - float(rp.ensemble_mse_threshold)) < 1e-6
    vote_band = (np.abs(got["reconstruction_mse"] - thr) < 1e-6)
    for name in ("conservative", "moderate"):
        vote_band[near[name]] = True
    near["ensemble"] = np.flatnonzero(vote_band).tolist()
    diff = np.flatnonzero((got["ensemble_predictions"] != ref["ensemble_predictions"])
                          & ~vote_band)
    assert not len(diff), f"ensemble: cells {diff.tolist()} disagree outside the band"
    counts = {k: len(v) for k, v in near.items()}
    print(f"cells within the band, excluded: {counts}: {near}")
    assert max(counts.values()) <= n // 10, counts
    for name in ("conservative", "moderate", "fft", "ensemble"):
        assert 0 < int((got[f"{name}_predictions"] == -1).sum()) < n


def test_each_package_trained_end_to_end_agrees_on_most_cells(stores):
    cells, dirs, gap = stores
    (got, gp), (ref, rp) = _scores(dirs["port"], cells), _scores(dirs["jax"], cells)
    n = len(cells)
    assert gap < CAE_GAP, gap
    mse_rel = float(np.max(np.abs(got["reconstruction_mse"] - ref["reconstruction_mse"])
                           / ref["reconstruction_mse"]))
    thr_rel = abs(float(gp.ensemble_mse_threshold) / float(rp.ensemble_mse_threshold) - 1)
    assert mse_rel < MSE_RTOL and thr_rel < MSE_RTOL, (mse_rel, thr_rel)
    # the FFT detector does not read the CAE: cell by cell outside the band
    band = (np.abs(got["fft_scores"]) < BAND) | (np.abs(ref["fft_scores"]) < BAND)
    assert not np.any((got["fft_predictions"] != ref["fft_predictions"]) & ~band)
    apart = {}
    for name in ("conservative", "moderate", "ensemble"):
        g, r = got[f"{name}_predictions"], ref[f"{name}_predictions"]
        apart[name] = (int((g != r).sum()), int((g == -1).sum()), int((r == -1).sum()))
    print(f"CAE gap {gap:.3e}, MSE {mse_rel:.2e}, threshold {thr_rel:.2e}; "
          f"(cells that disagree, anomalies port / JAX): {apart}")
    for name, (disagree, a_port, a_jax) in apart.items():
        assert disagree <= DISAGREE_FRACTION * n, (name, disagree)
        assert abs(a_port - a_jax) <= RATE_GAP * n, (name, a_port, a_jax)
        assert a_port > 0


def test_port_store_holds_the_ports_classes_and_the_jax_file_names(stores):
    import pickle

    from cell_image_analysis_tpu_torch import config as C

    _, dirs, _ = stores
    port_dir, jax_dir = dirs["port"], dirs["jax"]
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in (C.ARTIFACT_SCALER, C.ARTIFACT_PCA, C.ARTIFACT_DETECTOR_CONSERVATIVE,
                 C.ARTIFACT_DETECTOR_MODERATE, "fft_scaler.pkl", "detector_fft.pkl"):
        with open(os.path.join(port_dir, name), "rb") as f:
            raw = f.read()
        assert b"cell_image_analysis_tpu_torch.models" in raw
        assert b"cell_image_analysis_tpu.models" not in raw
    with open(os.path.join(port_dir, C.ARTIFACT_BEST_AUTOENCODER), "rb") as f:
        payload = pickle.load(f)
    with open(os.path.join(jax_dir, C.ARTIFACT_BEST_AUTOENCODER), "rb") as f:
        ref = pickle.load(f)
    assert payload["magic"] == ref["magic"] and payload["arch"] == ref["arch"]
    for coll in ("params", "batch_stats"):
        for layer, leaves in ref["variables"][coll].items():
            for leaf, v in leaves.items():
                got = payload["variables"][coll][layer][leaf]
                assert got.shape == np.asarray(v).shape and got.dtype == np.float32
