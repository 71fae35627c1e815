"""PyTorch port: StarDist `predict_instances` with the committed U-Net
weights against JAX on a synthetic 128^2 frame — identical label maps,
keep sets and overflow flags — and its pieces (percentile normalization,
star NMS, tiled rasterization) on shared inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_SEG, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
from cell_image_analysis_tpu_torch.models.stardist import predict_instances

torch_threads()


def _frame(seed, size, n_cells):
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    return make_frame(np.random.default_rng(seed), size=size, n_cells=n_cells)


@pytest.mark.parametrize("seed,n_cells", [(7, 4), (8, 6)])
def test_predict_instances_matches_jax(seed, n_cells):
    from cell_image_analysis_tpu.models.stardist import predict_instances as jax_predict
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    seg = _frame(seed, 128, n_cells)[..., 2].astype(np.float32)
    labels_j, d_j = jax_predict(jnp.asarray(seg), load_synthetic_unet_variables(), BENCH_SEG)
    backend = StarDistBackend(load_unet_variables(), BENCH_SEG)
    with torch.no_grad():
        labels_t, d_t = predict_instances(torch.from_numpy(seg)[None], backend.model, BENCH_SEG)
    assert int(labels_t.max()) > 0
    np.testing.assert_array_equal(labels_t[0].numpy(), np.asarray(labels_j))
    np.testing.assert_array_equal(d_t.keep[0].numpy(), np.asarray(d_j.keep))
    np.testing.assert_array_equal(d_t.points[0].numpy(), np.asarray(d_j.points))
    for flag in ("raster_overflow", "nms_overflow", "cand_overflow"):
        assert bool(getattr(d_t, flag)[0]) == bool(getattr(d_j, flag)), flag
    np.testing.assert_allclose(d_t.probs[0].numpy(), np.asarray(d_j.probs), atol=1e-5)


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
