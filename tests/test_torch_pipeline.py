"""PyTorch port: `score_frames_fused` end to end against JAX on two
synthetic 256^2 frames with the committed U-Net and scoring assets: the
same cell set (frame, label id), the same areas, identical predictions and
scores within 1e-4, with the exceptions `utils.parity` allows and reports —
knife-edge pixels (within 1e-3 px of a polygon boundary, where the two
packages' float32 U-Net sums may land on either side) and decisions within
1e-4 of their threshold.

The frames are small and dense, so the bench's sparse NMS pair budget
(8192) overflows on them: the first test gives both sides the exact K^2
pair set, and the overflow tests hold the fallback to the exact twin
(scatter rasterizer, K^2 pairs, pixel regionprops) against JAX's.

The threshold backend runs at the bench's threshold settings against
JAX's mask route: the port's CC labels through the run-length
regionprops, with the exact twin (pixel regionprops) as its fallback,
forced to fire at rcap 2 on both sides."""

import warnings

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    BENCH_SEG,
    BENCH_STAGE_A,
    JAX_BENCH_SEG,
    jax_scoring,
    torch_threads,
)

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend, ThresholdBackend
from cell_image_analysis_tpu_torch.models.stardist import predict_instances
from cell_image_analysis_tpu_torch.ops.runs import run_table
from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
from cell_image_analysis_tpu_torch.utils.parity import boundary_flips, compare_screens

torch_threads()

_SEG = dataclasses.replace(BENCH_SEG, nms_max_pairs=BENCH_SEG.max_candidates ** 2)
_TWIN_SEG = dataclasses.replace(_SEG, raster_mode="scatter")
_JAX_SEG = dataclasses.replace(JAX_BENCH_SEG, nms_max_pairs=BENCH_SEG.max_candidates ** 2)
_JAX_TWIN_SEG = dataclasses.replace(_JAX_SEG, raster_mode="scatter")
# utils/bench.py:250-253, the threshold backend's stage A
THRESH_STAGE_A = dict(label_capacity=4096, cell_capacity=128, fg_fraction=0.12)


def _frames():
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    rng = np.random.default_rng(5)
    frames = np.stack([make_frame(rng, size=256, n_cells=14) for _ in range(2)])
    return frames[..., 2].astype(np.float32), frames[..., 1].astype(np.float32)


def _port(segs, greens, seg_cfg, fallback=False):
    backend = StarDistBackend(load_unet_variables(), seg_cfg, device="cpu")
    model, params = load_scoring_params(device="cpu")
    out = score_frames_fused(model, params, torch.from_numpy(segs), torch.from_numpy(greens),
                             backend, chunk=32, caps=(64, 96),
                             fallback_segment_fn=backend.exact_twin() if fallback else None,
                             **BENCH_STAGE_A)
    with torch.no_grad():
        labels, _ = predict_instances(torch.from_numpy(segs), backend.model,
                                      _TWIN_SEG if fallback else seg_cfg)
    return out, labels, params


def _jax_flips(segs, unet_j, seg_cfg, labels_t):
    from cell_image_analysis_tpu.models.stardist import predict_instances as jax_predict

    flips = {}
    for b in range(len(segs)):
        labels_j, d = jax_predict(jnp.asarray(segs[b]), unet_j, seg_cfg)
        for lab, n in boundary_flips(np.array(labels_j), labels_t[b], np.array(d.points),
                                     np.array(d.dists), np.array(d.keep)).items():
            flips[(b, lab)] = n
    return flips


def _assert_rates_close(ref, got, report):
    excluded = set(report["knife_edge_cells"])
    for cells in report["near_threshold"].values():
        excluded |= set(cells)
    for k in ("conservative", "moderate", "ensemble", "fft"):
        d = abs(got[0][f"{k}_anomaly_rate"] - ref[0][f"{k}_anomaly_rate"])
        assert d <= len(excluded) / report["n_cells"], k
        if not excluded:
            assert d == 0.0, k


def test_score_frames_fused_matches_jax():
    from cell_image_analysis_tpu.models.segmentation import StarDistBackend as JaxBackend
    from cell_image_analysis_tpu.models.stardist import predict_instances as jax_predict
    from cell_image_analysis_tpu.pipeline.scoring import score_frames_fused as jax_fused
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    segs, greens = _frames()
    unet_j = load_synthetic_unet_variables()
    model_j, params_j = jax_scoring()
    ref = jax_fused(model_j, params_j, jnp.asarray(segs), jnp.asarray(greens),
                    JaxBackend(unet_j, _JAX_SEG, runs_props=True),
                    chunk=32, caps=(64, 96), **BENCH_STAGE_A)
    got, labels_t, params_t = _port(segs, greens, _SEG)
    report = compare_screens(ref, got, _jax_flips(segs, unet_j, _JAX_SEG, labels_t),
                             float(params_t.ensemble_mse_threshold))
    print(report, {k: v for k, v in got[0].items() if k.endswith("rate")})
    assert report["n_cells"] >= 20
    _assert_rates_close(ref, got, report)


def test_overflow_without_fallback_warns():
    """Without a fallback the port warns, as JAX does, and returns what the
    overflowing route gave; the 8192-pair budget overflows on these
    frames."""
    segs, greens = _frames()
    with pytest.warns(RuntimeWarning, match="no fallback_segment_fn"):
        (scores, stats), _, _ = _port(segs, greens, BENCH_SEG)
    assert len(stats["area"]) > 0


def test_overflow_falls_back_to_exact_twin():
    from cell_image_analysis_tpu.models.segmentation import StarDistBackend as JaxBackend
    from cell_image_analysis_tpu.pipeline.scoring import score_frames_fused as jax_fused
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    segs, greens = _frames()
    unet_j = load_synthetic_unet_variables()
    model_j, params_j = jax_scoring()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # the twin must not overflow
        ref = jax_fused(model_j, params_j, jnp.asarray(segs), jnp.asarray(greens),
                        JaxBackend(unet_j, JAX_BENCH_SEG, runs_props=True), chunk=32,
                        caps=(64, 96),
                        fallback_segment_fn=JaxBackend(unet_j, _JAX_TWIN_SEG, runs_props=False),
                        **BENCH_STAGE_A)
        got, labels_t, params_t = _port(segs, greens, BENCH_SEG, fallback=True)
    report = compare_screens(ref, got, _jax_flips(segs, unet_j, _JAX_TWIN_SEG, labels_t),
                             float(params_t.ensemble_mse_threshold))
    print(report)
    assert report["n_cells"] >= 20
    _assert_rates_close(ref, got, report)


class _Recording:
    """A segment_fn wrapper that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0
        for flag in ("returns_overflow", "runs_props"):
            if hasattr(fn, flag):
                setattr(self, flag, getattr(fn, flag))

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


@pytest.mark.parametrize("rcap", [32, 2])
def test_threshold_score_frames_fused_matches_jax(rcap):
    from cell_image_analysis_tpu.models.segmentation import threshold_segment as jax_segment
    from cell_image_analysis_tpu.pipeline.scoring import score_frames_fused as jax_fused
    from cell_image_analysis_tpu.utils.bench import _threshold_mask_fn

    segs, greens = _frames()
    model_j, params_j = jax_scoring()
    model, params = load_scoring_params(device="cpu")
    kw = dict(chunk=32, caps=(64, 96), rcap=rcap, **THRESH_STAGE_A)
    ref = jax_fused(model_j, params_j, jnp.asarray(segs), jnp.asarray(greens),
                    _threshold_mask_fn, fallback_segment_fn=jax_segment, **kw)
    backend = ThresholdBackend()
    twin = _Recording(backend.exact_twin())
    segs_t, greens_t = torch.from_numpy(segs), torch.from_numpy(greens)
    got = score_frames_fused(model, params, segs_t, greens_t, backend,
                             fallback_segment_fn=twin, **kw)
    forced = bool(run_table(backend(segs_t), rcap=rcap).overflow.any())
    assert forced == (rcap == 2) and twin.calls == int(forced)
    report = compare_screens(ref, got, {}, float(params.ensemble_mse_threshold))
    print(report)
    assert report["n_cells"] >= 8
    _assert_rates_close(ref, got, report)

    # the exact twin alone gives the same screening, and after a forced
    # fallback the very same result
    label = score_frames_fused(model, params, segs_t, greens_t, backend.exact_twin(), **kw)
    compare_screens(label, got, {}, float(params.ensemble_mse_threshold))
    if forced:
        for a, b in zip(label, got):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
