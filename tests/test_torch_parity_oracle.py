"""PyTorch port: the parity harness (`utils/parity.py`) and its numpy oracles.

- The port's copies of the numpy oracles equal the JAX package's bit for
  bit on seeded inputs: `clahe_np` (integer- and float-valued crops),
  `stardist_np` (NMS keep sets and label maps), `regionprops_np` (every
  property of every region).
- `oracle_extract_cells` (threshold), `fft_features_np` and
  `_svm_decision_np` equal JAX's bit for bit.
- `oracle_score` (the CAE in float64 on the CPU) against JAX's
  `oracle_score(use_keras=False)` (flax, float32) on the same cells with
  JAX's fitted estimators carried across: the same predictions and rates,
  MSE within 1e-6.
- The StarDist oracle segmentation (the port's U-Net in float64, plain
  `F.conv2d`, then `predict_instances_np`) against JAX's Keras one on one
  256^2 frame: the same number of instances and of extracted cells.
- `measure_parity` on the CPU: threshold at 2 x 256^2, against JAX's
  `measure_parity(use_keras=False)` on the same workload (the same cell
  counts and rates on both sides), and StarDist at 1 x 256^2 with the
  committed U-Net; each gives `cell_count_match` and a max deviation
  below 1e-3, and the device side runs where it is told.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.utils import parity

torch_threads()

MSE_ATOL = 1e-6


@pytest.mark.parametrize("shape,integer,seed", [((37, 53), True, 0), ((64, 64), True, 1),
                                                ((150, 91), False, 2), ((9, 200), True, 3)])
def test_clahe_oracle_equals_jax(shape, integer, seed):
    from cell_image_analysis_tpu.ops.oracle import clahe_np as ref
    from cell_image_analysis_tpu_torch.ops.oracle import clahe_np

    rng = np.random.default_rng(seed)
    img = rng.gamma(2.0, 300.0, size=shape)
    img = np.round(img) if integer else img
    a, b = clahe_np.equalize_adapthist_np(img), ref.equalize_adapthist_np(img)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    hist = rng.integers(0, 400, size=256)
    assert np.array_equal(clahe_np.clip_histogram(hist, 97), ref.clip_histogram(hist, 97))


def _prob_dist(seed: int, hp: int = 48, wp: int = 48, rays: int = 32):
    """A smooth probability map with a few peaks and positive ray lengths."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hp, 0:wp].astype(np.float64)
    prob = np.zeros((hp, wp))
    for cy, cx in rng.uniform(4, hp - 4, size=(9, 2)):
        prob = np.maximum(prob, np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0))
    prob = np.clip(prob + rng.normal(0, 0.02, prob.shape), 0, 1).astype(np.float32)
    dist = rng.uniform(3.0, 11.0, size=(hp, wp, rays)).astype(np.float32)
    return prob, dist


@pytest.mark.parametrize("seed,max_candidates", [(0, None), (1, 40), (2, 256)])
def test_stardist_oracle_equals_jax(seed, max_candidates):
    from cell_image_analysis_tpu.ops.oracle import stardist_np as ref
    from cell_image_analysis_tpu_torch.ops.oracle import stardist_np

    prob, dist = _prob_dist(seed)
    la, (ca, da, pa, ka) = stardist_np.predict_instances_np(prob, dist,
                                                            max_candidates=max_candidates)
    lb, (cb, db, pb, kb) = ref.predict_instances_np(prob, dist, max_candidates=max_candidates)
    assert la.dtype == lb.dtype and np.array_equal(la, lb) and int(la.max()) > 0
    for x, y in ((ca, cb), (da, db), (pa, pb), (ka, kb)):
        assert np.array_equal(x, y)


def test_regionprops_oracle_equals_jax():
    from scipy import ndimage as ndi

    from cell_image_analysis_tpu.ops.oracle.regionprops_np import regionprops_np as ref
    from cell_image_analysis_tpu_torch.ops.oracle.regionprops_np import regionprops_np

    rng = np.random.default_rng(4)
    labels, n = ndi.label(ndi.binary_opening(ndi.gaussian_filter(rng.normal(size=(96, 128)), 2)
                                             > 0.3))
    intensity = rng.uniform(0, 500, size=labels.shape)
    got, want = regionprops_np(labels, intensity), ref(labels, intensity)
    assert len(got) == len(want) == n > 3
    assert got == want


@pytest.fixture(scope="module")
def frame():
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    return make_frame(np.random.default_rng(11), size=256, n_cells=10)


def test_oracle_extract_cells_equals_jax(frame):
    from cell_image_analysis_tpu.utils.parity import oracle_extract_cells as ref

    got, want = parity.oracle_extract_cells(frame), ref(frame)
    assert got.dtype == want.dtype == np.float32 and got.shape[1:] == (64, 64)
    assert len(got) > 3 and np.array_equal(got, want)


def test_fft_features_and_svm_decision_equal_jax():
    from types import SimpleNamespace

    from cell_image_analysis_tpu.utils import parity as ref
    from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

    cells = make_cells(np.random.default_rng(6), 12)
    assert np.array_equal(parity.fft_features_np(cells), ref.fft_features_np(cells))
    rng = np.random.default_rng(7)
    svm = SimpleNamespace(support_vectors_=rng.normal(size=(20, 9)).astype(np.float32),
                          dual_coef_=rng.uniform(0, 0.1, size=20).astype(np.float32),
                          gamma_=0.13, intercept_=-0.4)
    X = rng.normal(size=(15, 9))
    assert np.array_equal(parity._svm_decision_np(svm, X), ref._svm_decision_np(svm, X))


@pytest.fixture(scope="module")
def jax_fit():
    """JAX's `_fit_params(seed=0)` (what assets/scoring_synthetic.npz holds),
    and the port's host dict with its estimators carried across and its
    CAE holding the same variables."""
    import jax

    from cell_image_analysis_tpu.utils.bench import _fit_params
    from cell_image_analysis_tpu_torch.io.artifacts import cae_state_from_jax
    from cell_image_analysis_tpu_torch.models.cae import CAE

    _, _, jhost = _fit_params(seed=0)
    model = CAE()
    model.load_state_dict(cae_state_from_jax(jax.tree.map(np.asarray, jhost["variables"])))
    return jhost, dict(jhost, model=model.eval())


def test_oracle_score_equals_jax_without_keras(jax_fit):
    from cell_image_analysis_tpu.utils.parity import oracle_score as ref
    from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

    jhost, host = jax_fit
    rng = np.random.default_rng(8)
    cells = np.concatenate([make_cells(rng, 40), make_cells(rng, 20, mutant=True)])
    got, want = parity.oracle_score(cells, host), ref(cells, jhost, use_keras=False)
    assert got["n_cells"] == want["n_cells"] == 60
    np.testing.assert_allclose(got["mse"], want["mse"], atol=MSE_ATOL)
    for d in ("conservative", "moderate", "ensemble", "fft"):
        assert np.array_equal(got[f"{d}_predictions"], want[f"{d}_predictions"]), d
        assert got[f"{d}_anomaly_rate"] == want[f"{d}_anomaly_rate"], d
    rates = [got[f"{d}_anomaly_rate"] for d in ("conservative", "moderate", "ensemble", "fft")]
    assert any(0.0 < r < 1.0 for r in rates), rates


def test_stardist_oracle_segmentation_counts_equal_jax_keras(frame):
    pytest.importorskip("keras")
    from cell_image_analysis_tpu.utils.bench import _keras_unet_segment_cpu
    from cell_image_analysis_tpu.utils.parity import oracle_extract_cells as ref_extract

    seg = frame[..., 2].astype(np.float64)
    lo, hi = np.percentile(seg, 3), np.percentile(seg, 99.8)
    norm = (seg - lo) / (hi - lo + 1e-20)
    ours, keras_seg = parity.oracle_stardist_segment(), _keras_unet_segment_cpu(256)
    got, want = ours(norm), keras_seg(norm)
    assert got.shape == want.shape == (256, 256)
    assert int(got.max()) == int(want.max()) > 3
    assert len(parity.oracle_extract_cells(frame, segment=ours)) == len(
        ref_extract(frame, segment=keras_seg))


def _check(res: dict) -> None:
    assert res["cell_count_match"], res
    assert res["max_deviation"] < 1e-3, res
    assert set(res["deviations"]) == {"conservative", "moderate", "ensemble", "fft"}


def test_measure_parity_threshold_on_the_cpu_equals_jax():
    from cell_image_analysis_tpu.utils.parity import measure_parity as ref

    kw = dict(n_frames=2, size=256, n_cells=10, seed=11)
    got, want = parity.measure_parity(device="cpu", **kw), ref(use_keras=False, **kw)
    _check(got)
    _check(want)
    assert got["device"]["n_cells"] > 5
    assert got["device"] == want["device"] and got["reference"] == want["reference"]


def test_measure_parity_stardist_on_the_cpu():
    res = parity.measure_parity(n_frames=1, size=256, n_cells=10, seed=13, backend="stardist",
                                device="cpu")
    _check(res)
    assert res["device"]["n_cells"] > 3


def test_measure_parity_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity.measure_parity(n_frames=1, size=256, n_cells=10)
