"""PyTorch port: StarDist `predict_instances` with the committed U-Net
weights against JAX on synthetic 128^2 frames and on a 264^2 frame (not a
multiple of the 64-px raster tile, so both render with the scatter
rasterizer) — identical label maps, keep sets and overflow flags — and its
pieces (percentile normalization, star NMS, tiled and scatter
rasterization) on shared inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_SEG, JAX_BENCH_SEG, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
from cell_image_analysis_tpu_torch.models.stardist import predict_instances

torch_threads()


def _frame(seed, size, n_cells):
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    return make_frame(np.random.default_rng(seed), size=size, n_cells=n_cells)


@pytest.mark.parametrize("seed,size,n_cells", [(7, 128, 4), (8, 128, 6), (9, 264, 16)])
def test_predict_instances_matches_jax(seed, size, n_cells):
    from cell_image_analysis_tpu.models.stardist import predict_instances as jax_predict
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    seg = _frame(seed, size, n_cells)[..., 2].astype(np.float32)
    labels_j, d_j = jax_predict(jnp.asarray(seg), load_synthetic_unet_variables(), JAX_BENCH_SEG)
    backend = StarDistBackend(load_unet_variables(), BENCH_SEG, device="cpu")
    with torch.no_grad():
        labels_t, d_t = predict_instances(torch.from_numpy(seg)[None], backend.model, BENCH_SEG)
    assert labels_t.shape == (1, size, size)
    assert int(labels_t.max()) > 0
    np.testing.assert_array_equal(labels_t[0].numpy(), np.asarray(labels_j))
    np.testing.assert_array_equal(d_t.keep[0].numpy(), np.asarray(d_j.keep))
    np.testing.assert_array_equal(d_t.points[0].numpy(), np.asarray(d_j.points))
    for flag in ("raster_overflow", "nms_overflow", "cand_overflow"):
        assert bool(getattr(d_t, flag)[0]) == bool(getattr(d_j, flag)), flag
    np.testing.assert_allclose(d_t.probs[0].numpy(), np.asarray(d_j.probs), atol=1e-5)


@pytest.mark.slow
def test_default_budget_overflows_in_jax_too_on_a_1024_frame():
    """The screener's default `SegConfig` (1024 candidates, 8192 NMS pairs)
    on one synthetic 1024^2 frame of 80 cells, the first frame of the
    smoke's `wildtype` folder: the port's pair-budget flag fires, so the
    screener re-runs the batch through the exact twin; the JAX package at
    the same defaults raises the same flags on the same frame."""
    from cell_image_analysis_tpu.config import SegConfig as JaxSegConfig
    from cell_image_analysis_tpu.models.stardist import predict_instances as jax_predict
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables
    from cell_image_analysis_tpu_torch.config import SegConfig

    seg = _frame(21, 1024, 80)[..., 2].astype(np.float32)
    _, d_j = jax_predict(jnp.asarray(seg), load_synthetic_unet_variables(), JaxSegConfig())
    backend = StarDistBackend(load_unet_variables(), SegConfig(), device="cpu")
    with torch.no_grad():
        _, d_t = predict_instances(torch.from_numpy(seg)[None], backend.model, SegConfig())
    for flag in ("raster_overflow", "nms_overflow", "cand_overflow"):
        assert bool(getattr(d_t, flag)[0]) == bool(getattr(d_j, flag)), flag
    assert bool(d_t.nms_overflow[0])
    np.testing.assert_array_equal(d_t.keep[0].numpy(), np.asarray(d_j.keep))


def test_normalize_percentile_matches_jax():
    from cell_image_analysis_tpu.ops.percentile import normalize_percentile as jax_norm
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile

    x = _frame(3, 96, 5)[..., 2].astype(np.float32)
    ref = np.asarray(jax_norm(jnp.asarray(x)))
    got = normalize_percentile(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _polygons(seed, K=64, R=32, size=128):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10, size - 10, size=(K, 2)).astype(np.float32).round()
    dists = rng.uniform(4, 14, size=(K, R)).astype(np.float32)
    probs = rng.uniform(0.3, 1.0, size=K).astype(np.float32)
    return centers, dists, probs, probs > 0.45


@pytest.mark.parametrize("max_pairs", [64, 8192])
def test_star_nms_matches_jax(max_pairs):
    from cell_image_analysis_tpu.ops.nms import star_nms as jax_nms
    from cell_image_analysis_tpu_torch.ops.nms import star_nms

    c, d, p, v = _polygons(0)
    keep_j, ovf_j = jax_nms(jnp.asarray(c), jnp.asarray(d), jnp.asarray(p), jnp.asarray(v),
                            max_pairs=max_pairs, return_overflow=True)
    keep_t, ovf_t = star_nms(*(torch.from_numpy(a)[None] for a in (c, d, p, v)),
                             max_pairs=max_pairs)
    np.testing.assert_array_equal(keep_t[0].numpy(), np.asarray(keep_j))
    assert bool(ovf_t[0]) == bool(ovf_j)


def test_every_candidate_pair_equals_the_k_squared_budget():
    """`max_pairs=None` (the exact twin's) integrates the candidate pairs
    only; a budget of K^2 integrates every pair.  Same overlaps, bit for bit,
    same keep mask, no overflow flag, also where a frame has no candidate
    pair at all."""
    from cell_image_analysis_tpu_torch.ops.nms import overlap_matrix_sparse, star_nms

    c, d, p, v = (torch.from_numpy(np.stack(a)) for a in zip(_polygons(0), _polygons(1)))
    v[1] = False
    K = c.shape[1]
    O_all, ovf_all = overlap_matrix_sparse(c, d, v, max_pairs=K * K)
    O_cand, ovf_cand = overlap_matrix_sparse(c, d, v, max_pairs=None)
    assert torch.equal(O_all, O_cand) and int((O_cand[0] > 0).sum()) > 0
    assert not bool(ovf_all.any()) and not bool(ovf_cand.any())
    assert torch.equal(star_nms(c, d, p, v, max_pairs=None)[0],
                       star_nms(c, d, p, v, max_pairs=K * K)[0])


@pytest.mark.parametrize("m_cap", [2, 8])
def test_rasterize_tiled_matches_jax(m_cap):
    from cell_image_analysis_tpu.ops.rasterize import rasterize_polygons_tiled as jax_raster
    from cell_image_analysis_tpu_torch.ops.rasterize import rasterize_polygons_tiled

    c, d, p, v = _polygons(1)
    lab_j, ovf_j = jax_raster(jnp.asarray(c), jnp.asarray(d), jnp.asarray(p), jnp.asarray(v),
                              128, 128, tile=64, m_cap=m_cap, raster_cap=48)
    lab_t, ovf_t = rasterize_polygons_tiled(*(torch.from_numpy(a)[None] for a in (c, d, p, v)),
                                            128, 128, tile=64, m_cap=m_cap, raster_cap=48)
    np.testing.assert_array_equal(lab_t[0].numpy(), np.asarray(lab_j))
    assert bool(ovf_t[0]) == bool(ovf_j)


@pytest.mark.parametrize("patch,raster_cap", [(32, 48), (24, None)])
def test_rasterize_scatter_matches_jax(patch, raster_cap):
    from cell_image_analysis_tpu.ops.rasterize import rasterize_polygons as jax_raster
    from cell_image_analysis_tpu_torch.ops.rasterize import rasterize_polygons

    # a 100x120 frame (not tile-aligned), polygons up to 14 px in radius:
    # at patch 24 the widest ones are clipped, on both sides alike
    polys = [_polygons(s, size=100) for s in (2, 3)]
    got = rasterize_polygons(*(torch.from_numpy(np.stack(a)) for a in zip(*polys)),
                             100, 120, patch=patch, raster_cap=raster_cap)
    assert got.shape == (2, 100, 120)
    for b, (c, d, p, v) in enumerate(polys):
        ref = jax_raster(jnp.asarray(c), jnp.asarray(d), jnp.asarray(p), jnp.asarray(v),
                         100, 120, patch=patch, raster_cap=raster_cap)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
        assert int(got[b].max()) > 0


def test_exact_twin_config():
    backend = StarDistBackend(load_unet_variables(), BENCH_SEG, device="cpu")
    twin = backend.exact_twin()
    assert backend.runs_props and not twin.runs_props
    assert twin.model is backend.model
    # None: every candidate pair, the pair set of the JAX twin's K^2 budget
    assert twin.cfg == dataclasses.replace(BENCH_SEG, raster_mode="scatter", nms_max_pairs=None)


@pytest.mark.parametrize("seed,h,w,K", [(12, 132, 260, 1024), (12, 260, 132, 1024),
                                        (11, 100, 100, 256)])
def test_top_k_takes_no_candidate_from_the_reflect_padding(seed, h, w, K):
    """Sides that are not multiples of 8 are reflect-padded for the U-Net;
    the grid pixels of the padding lie outside the frame and take no
    candidate slot.  Held against a numpy statement of the selection: the
    in-frame grid pixels by descending prob, lower index first on ties.
    (The JAX package sorts the padding in; its parity tests above are on
    aligned frames, where there is none.)"""
    from cell_image_analysis_tpu_torch.models.stardist import _pad_to_multiple
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile

    cfg = dataclasses.replace(BENCH_SEG, max_candidates=K)
    seg = torch.from_numpy(_frame(seed, 264, 16)[:h, :w, 2].astype(np.float32))[None]
    model = StarDistBackend(load_unet_variables(), cfg, device="cpu").model
    with torch.no_grad():
        labels, d = predict_instances(seg, model, cfg)
        x = _pad_to_multiple(normalize_percentile(seg, pmin=cfg.norm_pmin, pmax=cfg.norm_pmax), 8)
        prob = model(x[..., None])[0][0].numpy()
    hp, wp = prob.shape
    assert (hp * 2, wp * 2) == (-(-h // 8) * 8, -(-w // 8) * 8) != (h, w)
    rows, cols = np.mgrid[:hp, :wp]
    inside = ((rows * 2 < h) & (cols * 2 < w)).ravel()
    order = np.argsort(-np.where(inside, prob.ravel(), -np.inf), kind="stable")[:K]
    np.testing.assert_array_equal(d.points[0].numpy(),
                                  np.stack([order // wp * 2, order % wp * 2], axis=1))
    np.testing.assert_array_equal(d.probs[0].numpy(), prob.ravel()[order])
    points, keep = d.points[0].numpy(), d.keep[0].numpy()
    assert keep.sum() >= 3
    assert (points[:, 0] < h).all() and (points[:, 1] < w).all()
    assert labels.shape == (1, h, w) and int(labels.max()) > 0
    # the repair matters on this frame: a sort of the whole padded grid puts
    # padding pixels among the first K
    old = np.argsort(-prob.ravel(), kind="stable")[:K]
    assert (~inside[old]).any()
