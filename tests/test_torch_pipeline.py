"""PyTorch port: `score_frames_fused` end to end against JAX on two
synthetic 256^2 frames with the committed U-Net and scoring assets: the
same cell set (frame, label id), the same areas, identical predictions and
scores within 1e-4, with the exceptions `utils.parity` allows and reports —
knife-edge pixels (within 1e-3 px of a polygon boundary, where the two
packages' float32 U-Net sums may land on either side) and decisions within
1e-4 of their threshold.

The frames are small and dense, so the bench's sparse NMS pair budget
(8192) overflows on them and JAX would re-run through its exact twin;
both sides therefore use the exact K^2 pair set the twin uses."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_SEG, BENCH_STAGE_A, jax_scoring, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
from cell_image_analysis_tpu_torch.models.stardist import predict_instances
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    CapacityOverflowError,
    score_frames_fused,
)
from cell_image_analysis_tpu_torch.utils.parity import boundary_flips, compare_screens

torch_threads()

_SEG = dataclasses.replace(BENCH_SEG, nms_max_pairs=BENCH_SEG.max_candidates ** 2)


def _frames():
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    rng = np.random.default_rng(5)
    frames = np.stack([make_frame(rng, size=256, n_cells=14) for _ in range(2)])
    return frames[..., 2].astype(np.float32), frames[..., 1].astype(np.float32)


def _port(segs, greens, seg_cfg):
    backend = StarDistBackend(load_unet_variables(), seg_cfg)
    model, params = load_scoring_params()
    out = score_frames_fused(model, params, torch.from_numpy(segs), torch.from_numpy(greens),
                             backend, chunk=32, caps=(64, 96), **BENCH_STAGE_A)
    with torch.no_grad():
        labels, _ = predict_instances(torch.from_numpy(segs), backend.model, seg_cfg)
    return out, labels, params


def test_score_frames_fused_matches_jax():
    from cell_image_analysis_tpu.models.segmentation import StarDistBackend as JaxBackend
    from cell_image_analysis_tpu.models.stardist import predict_instances as jax_predict
    from cell_image_analysis_tpu.pipeline.scoring import score_frames_fused as jax_fused
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    segs, greens = _frames()
    unet_j = load_synthetic_unet_variables()
    model_j, params_j = jax_scoring()
    ref = jax_fused(model_j, params_j, jnp.asarray(segs), jnp.asarray(greens),
                    JaxBackend(unet_j, _SEG, runs_props=True),
                    chunk=32, caps=(64, 96), **BENCH_STAGE_A)
    got, labels_t, params_t = _port(segs, greens, _SEG)

    flips = {}
    for b in range(len(segs)):
        labels_j, d = jax_predict(jnp.asarray(segs[b]), unet_j, _SEG)
        for lab, n in boundary_flips(np.array(labels_j), labels_t[b], np.array(d.points),
                                     np.array(d.dists), np.array(d.keep)).items():
            flips[(b, lab)] = n
    report = compare_screens(ref, got, flips, float(params_t.ensemble_mse_threshold))
    print(report, {k: v for k, v in got[0].items() if k.endswith("rate")})
    assert report["n_cells"] >= 20
    excluded = set(report["knife_edge_cells"])
    for cells in report["near_threshold"].values():
        excluded |= set(cells)
    for k in ("conservative", "moderate", "ensemble", "fft"):
        d = abs(got[0][f"{k}_anomaly_rate"] - ref[0][f"{k}_anomaly_rate"])
        assert d <= len(excluded) / report["n_cells"], k
        if not excluded:
            assert d == 0.0, k


def test_overflow_raises_instead_of_falling_back():
    # the bench's 8192-pair NMS budget overflows on these dense frames
    segs, greens = _frames()
    with pytest.raises(CapacityOverflowError, match="not ported"):
        _port(segs, greens, BENCH_SEG)
