"""PyTorch port: the bench (`utils/bench.py`, `cli bench`, `bench_torch.py`).

- `_make_frames` is byte-equal to the JAX package's, on both of its
  generators (`make_frame`, and `make_frame_instances` from 2048^2 up);
  `make_cells` is byte-equal to JAX's, normal and mutant.
- `_fit_params(X)` from JAX's CAE init (carried across) against JAX's
  `_fit_params(X=X)` on the same cells, at tests/test_torch_detector_fit.py's
  tolerances: the same support-vector counts and ensemble threshold (rtol
  1e-6), gamma within rtol 1e-4 (the features are two libraries' float32
  convolutions), rho and every decision on the fit cells within SVM_TOL,
  and the same predictions but for decisions within BAND of 0 (the free
  support vectors sit on the boundary); on held-out cells every
  prediction equal.  Without X it is the committed npz, which is JAX's
  `_fit_params(seed=0)` (tests/test_torch_weights.py holds that).
- `run_bench` and `run_train_bench` on the CPU at a tiny size print one
  JSON line with JAX's keys and metric names; the screening bench's cells
  are a direct `score_frames_fused` call's at the bench's settings, and no
  batch falls back; the train bench counts the steps of
  `TrainConfig.val_split`'s split.
- `cli bench --device cpu` exits 0 with one JSON line; without a GPU and
  without `--device cpu`, `cli bench` and `bench_torch.py` exit 2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch import cli
from cell_image_analysis_tpu_torch.config import TrainConfig
from cell_image_analysis_tpu_torch.utils import bench

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 1e-3       # tests/test_torch_detector_fit.py: decisions this close to 0 may flip
SVM_TOL = 2e-3
_KEYS = {"metric", "value", "unit", "vs_baseline"}   # JAX utils/bench.py:510-515, 542-548


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")


@pytest.mark.parametrize("n,size,cells", [(2, 256, 12), (1, 2048, 8)])
def test_make_frames_byte_equal_to_jax(n, size, cells):
    from cell_image_analysis_tpu.utils.bench import _make_frames as jax_make

    got, ref = bench._make_frames(n, size, cells), jax_make(n, size, cells)
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.uint16 and a.shape == (size, size, 3)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mutant", [False, True])
def test_make_cells_byte_equal_to_jax(mutant):
    from cell_image_analysis_tpu.utils.synthetic import make_cells as jax_make
    from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

    a = make_cells(np.random.default_rng(5), 24, mutant=mutant)
    b = jax_make(np.random.default_rng(5), 24, mutant=mutant)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def fits():
    """JAX's `_fit_params(X=X)` and the port's from the same CAE init, on
    JAX's default fit cells; held-out cells, a third of them mutant."""
    import jax

    from cell_image_analysis_tpu.models.cae import init_cae
    from cell_image_analysis_tpu.utils.bench import _fit_params as jax_fit
    from cell_image_analysis_tpu.utils.synthetic import make_cells
    from cell_image_analysis_tpu_torch.io.artifacts import cae_state_from_jax

    rng = np.random.default_rng(0)
    X = make_cells(rng, 256)[..., None]
    Y = np.concatenate([make_cells(rng, 40), make_cells(rng, 24, mutant=True)])[..., None]
    ref = jax_fit(seed=0, X=X)
    _, variables = init_cae(jax.random.PRNGKey(0))   # what JAX's _fit_params draws
    state = cae_state_from_jax(jax.tree.map(np.asarray, variables))
    got = bench._fit_params(seed=0, X=X, device="cpu", cae_state=state)
    return X, Y, got, ref


def test_fit_params_estimators_equal_jax(fits):
    _, _, (_, _, host), (_, _, jhost) = fits
    np.testing.assert_allclose(host["ens"].mse_threshold, jhost["ens"].mse_threshold, rtol=1e-6)
    np.testing.assert_allclose(host["scaler"].center_, jhost["scaler"].center_, atol=1e-6)
    np.testing.assert_allclose(host["scaler"].scale_, jhost["scaler"].scale_, atol=1e-6)
    np.testing.assert_allclose(host["fft_scaler"].center_, jhost["fft_scaler"].center_,
                               rtol=1e-5)
    for key in ("cons", "mod", "fft_det"):
        a, b = host[key], jhost[key]
        assert a.support_vectors_.shape == np.asarray(b.support_vectors_).shape, key
        np.testing.assert_allclose(a.gamma_, b.gamma_, rtol=1e-4, err_msg=key)
        assert abs(a.intercept_ - float(b.intercept_)) < SVM_TOL, key


@pytest.mark.parametrize("cells", ["fit", "held_out"])
def test_fit_params_decisions_equal_jax(fits, cells):
    import jax.numpy as jnp

    from cell_image_analysis_tpu.pipeline.scoring import score_cells as jax_score
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_cells

    X, Y, (model, params, _), (jmodel, jparams, _) = fits
    Z = X if cells == "fit" else Y
    got = score_cells(model, params, torch.tensor(Z))
    ref = jax_score(jmodel, jparams, jnp.asarray(Z))
    near = {}
    for k in ("conservative", "moderate", "fft"):
        a, b = getattr(got, f"{k}_scores").numpy(), np.asarray(getattr(ref, f"{k}_scores"))
        assert np.abs(a - b).max() < SVM_TOL, k
        near[k] = np.abs(b) < BAND
        differ = getattr(got, f"{k}_predictions").numpy() != np.asarray(
            getattr(ref, f"{k}_predictions"))
        assert not np.any(differ & ~near[k]), k
        if cells == "held_out":
            assert not differ.any(), k
    np.testing.assert_allclose(got.reconstruction_mse.numpy(),
                               np.asarray(ref.reconstruction_mse), atol=1e-6)
    differ = got.ensemble_predictions.numpy() != np.asarray(ref.ensemble_predictions)
    assert not np.any(differ & ~(near["conservative"] | near["moderate"]))


def test_fit_params_without_x_is_the_committed_fit():
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params

    model, params, host = bench._fit_params(device="cpu")
    _, ref = load_scoring_params(device="cpu")
    for a, b in zip(params, ref):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    np.testing.assert_array_equal(host["pca"].components_, ref.pca_components.numpy())
    assert host["cons"].support_vectors_.shape[0] == ref.svm_conservative.dual_coef.shape[0]
    assert host["model"] is model
    with pytest.raises(ValueError, match="seed 0"):
        bench._fit_params(seed=3, device="cpu")


@pytest.mark.parametrize("backend,metric", [
    ("threshold", "screening_cells_per_sec_per_chip"),
    ("stardist", "screening_cells_per_sec_per_chip_stardist")])
def test_run_bench_prints_jax_keys_on_the_cpu(backend, metric):
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    report = {}
    line = bench.run_bench(n_frames=2, size=256, n_cells=10, backend=backend, device="cpu",
                           report=report)
    assert "\n" not in line
    out = json.loads(line)
    assert set(out) == _KEYS and out["metric"] == metric and out["unit"] == "cells/s/chip"
    assert out["value"] == round(report["cells_per_sec"], 2) > 0
    base = bench.load_cpu_baseline(backend)
    assert out["vs_baseline"] == round(report["cells_per_sec"] / base, 2)
    assert report["device"] == "cpu" and report["peak_gib"] is None
    assert report["fallback_batches"] == 0 and report["batches_run"] == 4

    model, params, _ = bench._fit_params(device="cpu")
    frames = np.stack(bench._make_frames(2, 256, 10))
    run, _, _ = bench._batch_pipeline(model, params, backend, "cpu")
    segs = torch.tensor(frames[..., 2].astype(np.float32))
    greens = torch.tensor(frames[..., 1].astype(np.float32))
    n, (scores, stats) = run(segs, greens)
    assert report["cells"] == n > 0
    if backend == "threshold":
        from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend

        direct = score_frames_fused(model, params, segs, greens, ThresholdBackend(),
                                    chunk=32, caps=(64, 96), label_capacity=4096,
                                    cell_capacity=128, fg_fraction=0.12)
        np.testing.assert_array_equal(direct[1]["area"], stats["area"])
        np.testing.assert_array_equal(direct[0]["reconstruction_mse"],
                                      scores["reconstruction_mse"])


@pytest.mark.parametrize("val_split,steps", [(0.2, 4), (0.5, 3)])
def test_run_train_bench_follows_the_train_config(val_split, steps):
    """96 cells at batch 16: 76 train cells at the default split (sklearn
    rounds the test count up: 20), 48 at 0.5."""
    report = {}
    cfg = TrainConfig(batch_size=16, val_split=val_split)
    out = json.loads(bench.run_train_bench(n_cells=96, epochs=2, device="cpu", train_cfg=cfg,
                                           report=report))
    assert set(out) == _KEYS and out["metric"] == "cae_train_cells_per_sec_per_chip"
    assert report["steps"] == steps and report["epochs"] == 2
    assert report["cells"] == steps * 16 * 2
    assert out["value"] == round(report["cells_per_sec"], 2) > 0


def test_cli_bench_defaults_are_jax_cli_bench_defaults():
    """JAX's `cli bench` (cell_image_analysis_tpu/cli.py:102-110): 8 frames
    of 1024^2, 80 cells a frame, the StarDist backend."""
    import argparse

    p = argparse.ArgumentParser()
    cli.add_bench_arguments(p)
    args = p.parse_args([])
    assert (args.frames, args.size, args.cells_per_frame, args.backend, args.device) == (
        8, 1024, 80, "stardist", None)


def test_cli_bench_on_the_cpu_prints_one_json_line(capsys):
    assert cli.main(["bench", "--frames", "1", "--size", "256", "--cells-per-frame", "10",
                     "--backend", "threshold", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "screening_cells_per_sec_per_chip"
    assert "another machine" in captured.err


def test_cli_bench_needs_a_gpu_or_the_device_flag(no_gpu, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--frames", "1", "--size", "256"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err


def test_bench_torch_needs_a_gpu_or_the_device_flag(no_gpu):
    done = subprocess.run([sys.executable, os.path.join(_REPO, "bench_torch.py"), "--mode",
                           "train"], capture_output=True, text=True, timeout=120, cwd=_REPO)
    assert done.returncode == 2 and done.stdout == ""
    assert "no CUDA device" in done.stderr and "--device cpu" in done.stderr
