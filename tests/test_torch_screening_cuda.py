"""PyTorch port on the GPU: the pipelined halves of `score_frames_fused`
against the one-call form, and the screener on the card against the same
screener on the CPU on a small folder.  These skip without a GPU; on a GPU
machine run

    python -m pytest tests/test_torch_screening_cuda.py -q
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_SEG, BENCH_STAGE_A, torch_threads

from cell_image_analysis_tpu_torch.config import ExtractConfig, PipelineConfig, SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend, ThresholdBackend
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    score_frames_fused,
    score_frames_fused_start,
    score_frames_fused_wait,
)
from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset, make_frame

pytestmark = pytest.mark.cuda
torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(_REPO, "assets", "screening_store_synthetic")
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _frames(seed, n, dev, size=256, n_cells=14):
    rng = np.random.default_rng(seed)
    frames = np.stack([make_frame(rng, size=size, n_cells=n_cells) for _ in range(n)])
    return (torch.tensor(frames[..., 2].astype(np.float32), device=dev),
            torch.tensor(frames[..., 1].astype(np.float32), device=dev))


def _assert_identical(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("route", ["threshold", "stardist"])
def test_wait_of_start_equals_the_one_call_on_the_card(dev, route):
    model, params = load_scoring_params(device=dev)
    if route == "threshold":
        fn = ThresholdBackend()
        kw = dict(chunk=32, caps=(64, 96), rcap=32, fallback_segment_fn=fn.exact_twin(),
                  label_capacity=4096, cell_capacity=128, fg_fraction=0.12)
    else:
        fn = StarDistBackend(load_unet_variables(), BENCH_SEG, device=dev)
        kw = dict(chunk=32, caps=(64, 96), fallback_segment_fn=fn.exact_twin(), **BENCH_STAGE_A)
    batch_a, batch_b = _frames(5, 2, dev), _frames(6, 3, dev)
    ref_a = score_frames_fused(model, params, *batch_a, fn, **kw)
    ref_b = score_frames_fused(model, params, *batch_b, fn, **kw)
    assert len(ref_a[1]["area"]) >= 10
    pend_a = score_frames_fused_start(model, params, *batch_a, fn, **kw)
    assert pend_a["event"] is not None and pend_a["ints"].is_pinned()
    pend_b = score_frames_fused_start(model, params, *batch_b, fn, **kw)
    _assert_identical(ref_a, score_frames_fused_wait(pend_a))
    _assert_identical(ref_b, score_frames_fused_wait(pend_b))


@pytest.mark.parametrize("backend", ["threshold", "stardist"])
def test_screener_on_the_card_matches_the_cpu(dev, backend, tmp_path, capsys):
    wt, odd = str(tmp_path / "wt"), str(tmp_path / "odd")
    make_dataset(wt, n_frames=3, size=256, n_cells=14, seed=5)
    make_dataset(odd, n_frames=2, size=256, n_cells=14, mutant_fraction=0.7, seed=6)
    cfg = PipelineConfig(seg=SegConfig(backend=backend, max_candidates=256),
                         extract=ExtractConfig(cell_capacity=64))
    unet = load_unet_variables() if backend == "stardist" else None
    figures = importlib.util.find_spec("matplotlib") is not None   # the card's machine may lack it
    runs = []
    for d in (dev, "cpu"):
        screener = ProductionMutantScreening(STORE, cfg, unet, device=d)
        runs.append(screener.screen_mutant_samples({"wildtype": wt, "mutantA": odd},
                                                   str(tmp_path / f"out_{d}"),
                                                   figures=figures))
    (res, det), (res_c, det_c) = runs
    assert list(res) == list(res_c) == ["wildtype", "mutantA"]
    flips = 0
    for name in res:
        assert res[name]["total_cells"] == res_c[name]["total_cells"] >= 5
    for a, b in zip(det, det_c):
        for k in ("mse", "mae", "conservative_score", "moderate_score"):
            assert abs(a[k] - b[k]) <= TOL, (a["sample_name"], a["cell_id"], k)
        for flag, score in (("conservative_anomaly", "conservative_score"),
                            ("moderate_anomaly", "moderate_score")):
            if a[flag] != b[flag]:
                assert abs(b[score]) <= TOL
                flips += 1
    assert flips <= 2
    out = capsys.readouterr().out
    assert "Throughput:" in out and "score_frames" in out
