"""PyTorch port: the pipelined halves of `score_frames_fused`, and the two
host-facing functions of the screener's slow path.

- `score_frames_fused(...)` and `wait(start(...))` return equal arrays, bit
  for bit, for both backends; with two handles open at once (start a,
  start b, wait a, wait b) each returns its own batch's result; the
  overflow fallback and the no-fallback warning work through the handle;
- `compute_anomaly_scores` against JAX: scores within 1e-4, predictions
  equal except within 1e-4 of a threshold, and independent of how the cells
  are cut into calls;
- `extract_cells_chunked` against JAX on a frame's label map: the same
  cells in the same order with equal label ids and areas, the cells within
  the resize's own tolerance (1e-5; the CLAHE before it is exact), and the
  port's cells bit-equal whatever size buckets they go through.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_SEG, BENCH_STAGE_A, jax_scoring, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend, ThresholdBackend
from cell_image_analysis_tpu_torch.ops.extract import extract_cells_chunked
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    compute_anomaly_scores,
    score_frames_fused,
    score_frames_fused_start,
    score_frames_fused_wait,
)

torch_threads()

THRESH_STAGE_A = dict(label_capacity=4096, cell_capacity=128, fg_fraction=0.12)
TOL = 1e-4


def _frames(seed, n=2, size=256, n_cells=14):
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    rng = np.random.default_rng(seed)
    frames = np.stack([make_frame(rng, size=size, n_cells=n_cells) for _ in range(n)])
    return (torch.from_numpy(frames[..., 2].astype(np.float32)),
            torch.from_numpy(frames[..., 1].astype(np.float32)))


@pytest.fixture(scope="module")
def scoring():
    return load_scoring_params(device="cpu")


def _assert_identical(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k


def _threshold_args(rcap=32, fallback=True):
    backend = ThresholdBackend()
    return backend, dict(chunk=32, caps=(64, 96), rcap=rcap,
                         fallback_segment_fn=backend.exact_twin() if fallback else None,
                         **THRESH_STAGE_A)


def _stardist_args():
    import dataclasses

    cfg = dataclasses.replace(BENCH_SEG, nms_max_pairs=BENCH_SEG.max_candidates ** 2)
    backend = StarDistBackend(load_unet_variables(), cfg, device="cpu")
    return backend, dict(chunk=32, caps=(64, 96), **BENCH_STAGE_A)


@pytest.mark.parametrize("route", ["threshold", "stardist"])
def test_one_call_equals_wait_of_start(scoring, route):
    fn, kw = _threshold_args() if route == "threshold" else _stardist_args()
    segs, greens = _frames(5)
    one = score_frames_fused(*scoring, segs, greens, fn, **kw)
    pend = score_frames_fused_start(*scoring, segs, greens, fn, **kw)
    assert pend["event"] is None          # a CPU batch has nothing to wait for
    two = score_frames_fused_wait(pend)
    _assert_identical(one, two)
    assert len(one[1]["area"]) >= 10 and one[0]["reconstruction_mse"].dtype == np.float32


def test_two_handles_open_at_once_keep_their_batches(scoring):
    fn, kw = _threshold_args()
    batch_a, batch_b = _frames(5), _frames(6, n=3)
    ref_a = score_frames_fused(*scoring, *batch_a, fn, **kw)
    ref_b = score_frames_fused(*scoring, *batch_b, fn, **kw)
    assert len(ref_a[1]["area"]) != len(ref_b[1]["area"])
    pend_a = score_frames_fused_start(*scoring, *batch_a, fn, **kw)
    pend_b = score_frames_fused_start(*scoring, *batch_b, fn, **kw)
    got_a = score_frames_fused_wait(pend_a)
    got_b = score_frames_fused_wait(pend_b)
    _assert_identical(ref_a, got_a)
    _assert_identical(ref_b, got_b)
    assert set(got_b[1]["frame_index"]) == {0, 1, 2}
    # waiting in the other order changes nothing either
    pend_a = score_frames_fused_start(*scoring, *batch_a, fn, **kw)
    pend_b = score_frames_fused_start(*scoring, *batch_b, fn, **kw)
    _assert_identical(ref_b, score_frames_fused_wait(pend_b))
    _assert_identical(ref_a, score_frames_fused_wait(pend_a))


def test_overflow_decision_is_taken_in_wait(scoring):
    segs, greens = _frames(5)
    fn, kw = _threshold_args()
    exact = score_frames_fused(*scoring, segs, greens, fn.exact_twin(),
                               **{**kw, "fallback_segment_fn": None})
    fn2, tight = _threshold_args(rcap=2)
    calls = []

    class Twin:
        returns_mask = False

        def __call__(self, s):
            calls.append(s.shape)
            return tight["fallback_segment_fn"](s)

    pend = score_frames_fused_start(*scoring, segs, greens, fn2,
                                    **{**tight, "fallback_segment_fn": Twin()})
    assert calls == []                    # start never runs the fallback
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = score_frames_fused_wait(pend)
    assert calls == [segs.shape]
    _assert_identical(exact, got)

    fn3, no_fb = _threshold_args(rcap=2, fallback=False)
    pend = score_frames_fused_start(*scoring, segs, greens, fn3, **no_fb)
    with pytest.warns(RuntimeWarning, match="no fallback_segment_fn"):
        score_frames_fused_wait(pend)


def test_empty_batch_result(scoring):
    fn, kw = _threshold_args()
    flat = torch.full((1, 128, 128), 80.0)
    scores, stats = score_frames_fused_wait(
        score_frames_fused_start(*scoring, flat, flat, fn, **kw))
    assert scores == {} and len(stats["area"]) == 0 and stats["area"].dtype == np.int32


def _cells(n, seed=11):
    from cell_image_analysis_tpu.utils.synthetic import make_cells

    rng = np.random.default_rng(seed)
    return np.concatenate([make_cells(rng, n // 2), make_cells(rng, n - n // 2, mutant=True)])


def test_compute_anomaly_scores_matches_jax(scoring):
    from cell_image_analysis_tpu.pipeline.scoring import compute_anomaly_scores as jax_scores

    X = _cells(80)
    valid = np.ones(80, bool)
    valid[-7:] = False
    ref = jax_scores(*jax_scoring(), X[..., None], valid=valid)
    got = compute_anomaly_scores(*scoring, X, valid=valid)
    assert got.keys() == ref.keys()
    thr = float(scoring[1].ensemble_mse_threshold)
    near = {"conservative": np.abs(ref["conservative_scores"]) <= TOL,
            "moderate": np.abs(ref["moderate_scores"]) <= TOL,
            "fft": np.abs(ref["fft_scores"]) <= TOL}
    near["ensemble"] = (near["conservative"] | near["moderate"]
                        | (np.abs(ref["reconstruction_mse"] - thr) <= TOL))
    for k in ("reconstruction_mse", "reconstruction_mae", "conservative_scores",
              "moderate_scores", "fft_scores"):
        assert got[k].shape == (73,)
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(got["fft_features"], np.asarray(ref["fft_features"]),
                               rtol=1e-5, atol=1e-5)
    for name, band in near.items():
        a, b = got[f"{name}_predictions"], np.asarray(ref[f"{name}_predictions"])
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a[~band], b[~band], err_msg=name)
        if not band.any():
            assert got[f"{name}_anomaly_rate"] == ref[f"{name}_anomaly_rate"]
    assert set(np.unique(got["moderate_predictions"])) == {-1, 1}
    assert compute_anomaly_scores(*scoring, np.zeros((0, 64, 64), np.float32)) == {}


def test_compute_anomaly_scores_does_not_depend_on_the_chunks(scoring):
    X = _cells(60, seed=3)
    whole = compute_anomaly_scores(*scoring, X)
    parts = [compute_anomaly_scores(*scoring, X[a:b]) for a, b in ((0, 32), (32, 59), (59, 60))]
    for k in ("reconstruction_mse", "conservative_scores", "moderate_scores", "fft_scores"):
        np.testing.assert_allclose(np.concatenate([p[k] for p in parts]), whole[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ("conservative", "moderate", "ensemble", "fft"):
        np.testing.assert_array_equal(
            np.concatenate([p[f"{k}_predictions"] for p in parts]), whole[f"{k}_predictions"])


_QC = dict(label_capacity=256, cell_capacity=64, crop_capacity=192)


@pytest.mark.parametrize("seed,size,n_cells", [(3, 384, 22), (8, 256, 14)])
def test_extract_cells_chunked_matches_jax(seed, size, n_cells):
    from cell_image_analysis_tpu.ops.extract import extract_cells_chunked as jax_extract
    from cell_image_analysis_tpu.utils.synthetic import make_frame_instances

    frame, labels = make_frame_instances(np.random.default_rng(seed), size=size,
                                         n_cells=n_cells)
    green = frame[..., 1].astype(np.float32)
    ref_cells, ref_stats = jax_extract(jnp.asarray(labels), jnp.asarray(green), **_QC)
    cells, stats = extract_cells_chunked(torch.from_numpy(labels), torch.from_numpy(green),
                                         **_QC)
    assert cells.dtype == np.float32 and cells.shape == ref_cells.shape
    assert len(cells) >= n_cells // 2
    for k in ("label_ids", "area"):
        np.testing.assert_array_equal(stats[k], np.asarray(ref_stats[k]), err_msg=k)
    np.testing.assert_allclose(stats["eccentricity"], ref_stats["eccentricity"], atol=1e-4)
    for k in ("mean_intensity", "std_intensity"):
        np.testing.assert_allclose(stats[k], ref_stats[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(cells, ref_cells, rtol=0, atol=1e-5)
    # the size buckets only pad the layout: one full-capacity bucket, the
    # JAX package's two (96 and full) and the default three give equal cells
    for caps in ((), (96,), (64,)):
        other, _ = extract_cells_chunked(torch.from_numpy(labels), torch.from_numpy(green),
                                         caps=caps, chunk=5, **_QC)
        np.testing.assert_array_equal(other, cells)


def test_extract_cells_chunked_empty_frame():
    labels = torch.zeros((64, 64), dtype=torch.int32)
    cells, stats = extract_cells_chunked(labels, torch.zeros((64, 64)), **_QC)
    assert cells.shape == (0, 64, 64) and cells.dtype == np.float32
    assert all(len(v) == 0 for v in stats.values())
