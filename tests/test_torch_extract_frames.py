"""PyTorch port: batched extraction for training (`ops/extract.py`
`extract_cells_frames`), the convex area of the report's solidity, and the
stage-B split that screening and training share.

- `extract_cells_frames` on a batch of frames equals the per-frame
  `extract_cells_chunked`, bit for bit, with frame-major `frame_index`;
  it equals JAX's `extract_cells_frames` on frames where no flag fires
  (the threshold backend's exact twin), atol 1e-5 as
  tests/test_extract_frames.py; its label maps come back as uint16.
- A batch whose NMS pair budget overflows (the budget cut to 64 pairs here
  so that a small frame overflows; at the default capacities 1024^2 frames
  of 80 cells do, the slow test of tests/test_torch_stardist.py) yields
  the exact twin's cells; without a fallback the port warns.
- `convex_area` equals JAX's on random regions.
- `score_frames_fused` and `ProductionMutantScreening` give, bit for bit,
  what they gave before the bucket loop moved into
  `ops.extract.preprocess_buckets` and the CAE's upsample stopped using
  `repeat_interleave`: the parent's loop and upsample are copied here as
  the reference, on the inputs of tests/test_torch_pipeline.py and
  tests/test_torch_screening.py, with each size bucket's last chunk padded
  to `chunk` rows as stage B scores it since its chunks became fixed-shape
  (the padding's own effect, against unpadded chunks, is held in
  tests/test_torch_stage_b_graph.py).
"""

import contextlib
import dataclasses
import io
import os
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import BENCH_SEG, BENCH_STAGE_A, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
from cell_image_analysis_tpu_torch.models import cae as cae_mod
from cell_image_analysis_tpu_torch.models.segmentation import (
    StarDistBackend,
    ThresholdBackend,
    threshold_segment,
)
from cell_image_analysis_tpu_torch.ops.extract import extract_cells_chunked, extract_cells_frames
from cell_image_analysis_tpu_torch.ops.oracle.regionprops_np import convex_area
from cell_image_analysis_tpu_torch.pipeline import scoring

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(_REPO, "assets", "screening_store_synthetic")
_KW = dict(chunk=8, cell_capacity=32, label_capacity=1024)


def _frames(n=3, size=256, n_cells=8, seed=0):
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    rng = np.random.default_rng(seed)
    f = np.stack([make_frame(rng, size=size, n_cells=n_cells) for _ in range(n)])
    return f[..., 2].astype(np.float32), f[..., 1].astype(np.float32)


def test_batch_equals_per_frame_bit_for_bit():
    segs, greens = _frames()
    twin = ThresholdBackend().exact_twin()        # the pixel regionprops
    cells, stats, labels16 = extract_cells_frames(torch.tensor(segs), torch.tensor(greens), twin,
                                                  return_labels=True, **_KW)
    per_cells, counts = [], []
    for s, g in zip(segs, greens):
        labels = threshold_segment(torch.tensor(s)[None])[0]
        c, st = extract_cells_chunked(labels, torch.tensor(g), **_KW)
        per_cells.append(c)
        counts.append(len(c))
    ref = np.concatenate(per_cells)
    assert len(ref) > 10 and cells.dtype == np.float32
    np.testing.assert_array_equal(cells, ref)
    np.testing.assert_array_equal(stats["frame_index"], np.repeat(np.arange(len(segs)), counts))
    assert labels16.dtype == np.uint16 and labels16.shape == segs.shape
    np.testing.assert_array_equal(labels16, threshold_segment(torch.tensor(segs)).numpy())


def test_batch_equals_jax_where_no_flag_fires():
    import jax.numpy as jnp

    from cell_image_analysis_tpu.models.segmentation import threshold_segment as jax_segment
    from cell_image_analysis_tpu.ops.extract import extract_cells_frames as jax_frames

    segs, greens = _frames(n=2, seed=1)
    cells, stats = extract_cells_frames(torch.tensor(segs), torch.tensor(greens),
                                        ThresholdBackend().exact_twin(), **_KW)
    ref_cells, ref_stats = jax_frames(jnp.asarray(segs), jnp.asarray(greens), jax_segment, **_KW)
    assert len(cells) == len(ref_cells) > 5
    np.testing.assert_allclose(cells, ref_cells, atol=1e-5)
    for k in ("label_ids", "area", "frame_index"):
        np.testing.assert_array_equal(stats[k], np.asarray(ref_stats[k]), err_msg=k)
    for k in ("eccentricity", "mean_intensity", "std_intensity"):
        np.testing.assert_allclose(stats[k], np.asarray(ref_stats[k]), rtol=1e-5, err_msg=k)


def test_overflowing_batch_yields_the_exact_twins_cells():
    segs, greens = _frames(n=2, size=256, n_cells=14, seed=5)
    tight = StarDistBackend(load_unet_variables(),
                            dataclasses.replace(BENCH_SEG, nms_max_pairs=64), device="cpu")
    twin = tight.exact_twin()
    kw = dict(BENCH_STAGE_A, chunk=32)
    args = (torch.tensor(segs), torch.tensor(greens))
    with torch.inference_mode():
        _, overflow = tight(args[0])
    assert bool(overflow.any())
    got = extract_cells_frames(*args, tight, fallback_segment_fn=twin, return_labels=True, **kw)
    ref = extract_cells_frames(*args, twin, return_labels=True, **kw)
    assert len(got[0]) == len(ref[0]) > 10
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)
    with pytest.warns(RuntimeWarning, match="no fallback_segment_fn"):
        extract_cells_frames(*args, tight, **kw)


def test_label_maps_need_a_label_route():
    """Every backend returns label maps: `return_labels` gives the
    threshold backend's, `threshold_segment`'s as uint16, beside the cells
    of its exact twin."""
    segs, greens = _frames(n=2)
    args = (torch.tensor(segs), torch.tensor(greens))
    cells, stats, labels16 = extract_cells_frames(*args, ThresholdBackend(), return_labels=True,
                                                  **_KW)
    assert labels16.dtype == np.uint16
    np.testing.assert_array_equal(labels16, threshold_segment(args[0]).numpy())
    ref_cells, ref_stats = extract_cells_frames(*args, ThresholdBackend().exact_twin(), **_KW)
    assert len(cells) == len(ref_cells) > 5
    np.testing.assert_array_equal(cells, ref_cells)
    for k in ref_stats:
        np.testing.assert_array_equal(stats[k], ref_stats[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convex_area_equals_jax(seed):
    from cell_image_analysis_tpu.ops.oracle.regionprops_np import convex_area as jax_area

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:60, :60]
    for k in range(40):
        kind = k % 5
        if kind == 0:
            a, b = rng.uniform(2, 25, 2)
            m = ((yy - 30) / a) ** 2 + ((xx - 30) / b) ** 2 < 1
        elif kind == 1:
            m = rng.uniform(size=(60, 60)) < rng.uniform(0.001, 0.2)
        elif kind == 2:
            m = np.zeros((60, 60), bool)
            m[rng.integers(0, 60), rng.integers(0, 60, size=rng.integers(1, 4))] = True
        elif kind == 3:
            m = np.zeros((60, 60), bool)
            m[rng.integers(0, 30):rng.integers(30, 60), rng.integers(0, 60)] = True
            m[rng.integers(0, 60), rng.integers(0, 30):rng.integers(30, 60)] = True
        else:
            m = (np.abs(yy - 30) + np.abs(xx - 30)) < rng.integers(1, 20)
        rr, cc = np.nonzero(m)
        if not len(rr):
            continue
        coords = np.stack([rr, cc], 1)[rng.permutation(len(rr))]
        assert convex_area(coords) == jax_area(coords)


# --- the parent's bucket loop and upsample, the reference of the split -----

def _parent_forward(self, x):
    h = x.permute(0, 3, 1, 2)
    for i in range(len(self.bns)):
        h = self.bns[i](torch.relu(self.convs[i](h)))
        if i < self.n_enc:
            h = F.max_pool2d(h, 2)
            if i == self.n_enc - 1:
                encoded = h.permute(0, 2, 3, 1)
        else:
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    decoded = torch.sigmoid(self.convs[-1](h))
    return decoded.permute(0, 2, 3, 1), encoded


@torch.inference_mode()
def _parent_wait(pend):
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, size_buckets
    from cell_image_analysis_tpu_torch.ops.resize import resize_cells

    B, ccap, full_cap = pend["shape"]
    N = B * ccap
    ints, floats = pend["ints"], pend["floats"]
    ovf = ints[:B]
    heights_h, widths_h, valid_h, label_ids, area = (ints[B + k * N:B + (k + 1) * N]
                                                     for k in range(5))
    valid_h = valid_h.bool()
    if bool(ovf.any()):
        return _parent(pend["model"], pend["params"], pend["segs0"], pend["greens0"],
                       pend["fallback_segment_fn"], chunk=pend["chunk"], caps=pend["caps"],
                       **pend["candidate_kwargs"])
    crops, heights, widths = pend["crops"], pend["heights"], pend["widths"]
    chunk = pend["chunk"]
    rows = torch.zeros((N, scoring._FUSED_D), dtype=torch.float32)
    for idx, cap_b, ns_cap in size_buckets(heights_h, widths_h, valid_h, pend["caps"], full_cap):
        if idx.numel() == 0:
            continue
        eq_all = clahe_bucket(crops, idx.int(), heights, widths, cap_b,
                              clip_limit=pend["clip_limit"], ns_cap=ns_cap)
        for start in range(0, idx.numel(), chunk):
            ids = idx[start:start + chunk]
            eq, h, w = eq_all[start:start + chunk], heights[ids], widths[ids]
            n = len(ids)
            if n < chunk:           # the last chunk padded: zero crops of the full side
                eq = torch.cat([eq, torch.zeros((chunk - n, cap_b, cap_b))])
                h, w = (torch.cat([s, torch.full((chunk - n,), cap_b, dtype=s.dtype)])
                        for s in (h, w))
            cells = resize_cells(eq, h, w, out_size=pend["out_size"])
            rows[ids] = scoring._score_rows(scoring.score_cells(
                pend["model"], pend["params"], cells[..., None],
                min_votes=pend["min_votes"]))[:n]
    pool = torch.nonzero(valid_h).flatten()
    return rows[pool].numpy(), label_ids[pool].numpy(), area[pool].numpy()


def _parent(model, params, segs, greens, seg_fn, **kw):
    return _parent_wait(scoring.score_frames_fused_start(model, params, segs, greens, seg_fn, **kw))


def _stardist_inputs():
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    rng = np.random.default_rng(5)
    f = np.stack([make_frame(rng, size=256, n_cells=14) for _ in range(2)])
    return torch.tensor(f[..., 2].astype(np.float32)), torch.tensor(f[..., 1].astype(np.float32))


@pytest.mark.parametrize("route", ["stardist", "threshold"])
def test_score_frames_fused_unchanged_bit_for_bit(route, monkeypatch):
    segs, greens = _stardist_inputs()
    model, params = load_scoring_params(device="cpu")
    if route == "stardist":
        seg_fn = StarDistBackend(load_unet_variables(), BENCH_SEG, device="cpu")
        kw = dict(BENCH_STAGE_A, chunk=32, caps=(64, 96))
    else:
        seg_fn = ThresholdBackend()
        kw = dict(label_capacity=4096, cell_capacity=128, fg_fraction=0.12, rcap=32, chunk=32,
                  caps=(64, 96))
    kw["fallback_segment_fn"] = seg_fn.exact_twin()
    out, stats = scoring.score_frames_fused(model, params, segs, greens, seg_fn, **kw)
    monkeypatch.setattr(cae_mod.CAE, "forward", _parent_forward)
    rows, label_ids, area = _parent(model, params, segs, greens, seg_fn, **kw)
    assert len(rows) > 10
    np.testing.assert_array_equal(stats["label_ids"], label_ids)
    np.testing.assert_array_equal(stats["area"], area)
    keys = ("reconstruction_mse", "reconstruction_mae", "conservative_predictions",
            "moderate_predictions", "conservative_scores", "moderate_scores",
            "ensemble_predictions", "fft_predictions", "fft_scores")
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(out[k], rows[:, i].astype(out[k].dtype), err_msg=k)
    np.testing.assert_array_equal(out["fft_features"], rows[:, 9:])


def test_screener_unchanged_bit_for_bit(tmp_path, monkeypatch):
    from cell_image_analysis_tpu_torch.config import PipelineConfig, SegConfig
    from cell_image_analysis_tpu_torch.pipeline import screening
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    folder = str(tmp_path / "wt")
    make_dataset(folder, n_frames=3, size=384, n_cells=22, seed=2)
    cfg = dataclasses.replace(PipelineConfig(), seg=SegConfig(backend="threshold"))

    def screen(tag):
        with contextlib.redirect_stdout(io.StringIO()):
            s = ProductionMutantScreening(STORE, cfg, device="cpu")
            return s.screen_mutant_samples({"wt": folder}, str(tmp_path / tag), figures=False)

    results, detailed = screen("now")

    def parent_wait(pend):
        rows, label_ids, area = _parent_wait(pend)
        keys = ("reconstruction_mse", "reconstruction_mae", "conservative_predictions",
                "moderate_predictions", "conservative_scores", "moderate_scores",
                "ensemble_predictions", "fft_predictions", "fft_scores")
        out = {k: rows[:, i] if "predictions" not in k else rows[:, i].astype(np.int32)
               for i, k in enumerate(keys)}
        out["fft_features"] = rows[:, 9:]
        for name in ("conservative", "moderate", "ensemble", "fft"):
            out[f"{name}_anomaly_rate"] = float(np.mean(out[f"{name}_predictions"] == -1))
        B, ccap, _ = pend["shape"]
        valid = pend["ints"][B + 2 * B * ccap:B + 3 * B * ccap].bool()
        pool = torch.nonzero(valid).flatten()
        floats = pend["floats"]
        stats = dict(label_ids=label_ids, area=area, frame_index=(pool // ccap).numpy(),
                     mean_intensity=floats[B * ccap:2 * B * ccap][pool].numpy())
        return out, stats

    monkeypatch.setattr(cae_mod.CAE, "forward", _parent_forward)
    monkeypatch.setattr(screening, "score_frames_fused_wait", parent_wait)
    ref_results, ref_detailed = screen("parent")
    assert results["wt"]["total_cells"] > 20
    assert results == ref_results and detailed == ref_detailed
    for name in ("screening_summary.csv", "detailed_cell_results.csv"):
        with open(tmp_path / "now" / name) as a, open(tmp_path / "parent" / name) as b:
            assert a.read() == b.read()
