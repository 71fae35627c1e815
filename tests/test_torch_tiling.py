"""PyTorch port: the plate tiler (`parallel.tiling`) against the JAX
package's on the same frames and the same number of tiles, JAX on its
virtual CPU mesh (tests/conftest.py) and the port on `virtual_mesh("cpu",
4)`: 256^2 frames, 4 tiles of 64 rows.

- `tiled_extract_cells` against JAX's: `valid`, `area`, `n_cells` and
  `cell_overflow` equal (one case truncates a tile, so the flag fires);
  eccentricity within 1e-4 (JAX sums the moments in float32, the port
  exactly: `tests/test_runs.py`'s tolerance), cells within 1e-5 (the JAX
  tiler's own test), mean and std within 1e-6 relative;
- `tiled_extract_cells_stardist` against JAX's with a narrow U-Net (depth
  2, 8 base filters, `torch_port_helpers.narrow_unet`) whose variables go
  to both packages: the same checks on the interior tiles' slots, and
  `raster_overflow` equal (one case caps the candidates, so it fires).
  The two edge tiles differ by design: JAX pads them with zero rows, which
  its U-Net reads as input, and the port ends them with the frame (a known
  divergence); the port's edge tiles are held to its fused path below;
- the halo tiles: cut at the frame's edges, no wraparound;
- the port's tiled run against its own fused single-device run on the same
  frame, as `tests/test_tiling_pipeline.py` holds JAX's (both backends):
  the same number of cells, sorted areas equal, sorted reconstruction MSE
  within 1e-6, the four rates equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import NARROW_UNET, narrow_unet, torch_threads

from cell_image_analysis_tpu_torch.config import SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend, ThresholdBackend
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.parallel.sharding import replicate
from cell_image_analysis_tpu_torch.parallel.tiling import (
    halo_tiles,
    tiled_extract_cells,
    tiled_extract_cells_stardist,
)
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    compute_anomaly_scores,
    score_frames_fused,
)

torch_threads()

N_TILES = 4
SIZE = 256
_SEG = dict(unet_depth=NARROW_UNET["depth"], base_filters=NARROW_UNET["base_filters"],
            head_filters=NARROW_UNET["head_filters"])


@functools.lru_cache(maxsize=None)
def _unet():
    return narrow_unet()


def _frame(seed, n_cells):
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    f = make_frame(np.random.default_rng(seed), size=SIZE, n_cells=n_cells)
    return f[..., 2].astype(np.float32), f[..., 1].astype(np.float32)


def _jax_mesh():
    from cell_image_analysis_tpu.parallel.mesh import make_mesh

    return make_mesh(N_TILES)


def _assert_tiles_equal(got, ref, min_cells, slots=slice(None)):
    """`slots`: the per-cell rows compared (all tiles by default)."""
    valid = np.asarray(ref.valid)[slots]
    assert int(got.valid[slots].sum()) == int(valid.sum()) >= min_cells
    np.testing.assert_array_equal(got.valid.numpy()[slots], valid)
    np.testing.assert_array_equal(got.area.numpy()[slots], np.asarray(ref.area)[slots])
    np.testing.assert_allclose(got.eccentricity.numpy()[slots],
                               np.asarray(ref.eccentricity)[slots], atol=1e-4)
    for k in ("mean_intensity", "std_intensity"):
        np.testing.assert_allclose(getattr(got, k).numpy()[slots],
                                   np.asarray(getattr(ref, k))[slots], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.cells.numpy()[slots], np.asarray(ref.cells)[slots],
                               atol=1e-5)


@pytest.mark.parametrize("seed,n_cells,halo,cell_capacity,overflow", [
    (3, 12, 48, 16, False),
    (5, 24, 32, 2, True),
])
def test_threshold_tiler_matches_jax(seed, n_cells, halo, cell_capacity, overflow):
    from cell_image_analysis_tpu.parallel.tiling import tiled_extract_cells as jax_tiled

    seg, green = _frame(seed, n_cells)
    kw = dict(halo=halo, cell_capacity=cell_capacity, label_capacity=128)
    ref = jax_tiled(jnp.asarray(seg), jnp.asarray(green), _jax_mesh(), **kw)
    got = tiled_extract_cells(seg, green, virtual_mesh("cpu", N_TILES), **kw)
    assert got.raster_overflow is None
    assert got.cell_overflow is bool(ref.cell_overflow) is overflow
    assert got.n_cells == int(ref.n_cells)
    _assert_tiles_equal(got, ref, min_cells=5)


@pytest.mark.parametrize("seed,n_cells,max_candidates,overflow", [
    (7, 12, 256, False),
    (8, 12, 8, True),
])
def test_stardist_tiler_matches_jax(seed, n_cells, max_candidates, overflow):
    from cell_image_analysis_tpu.config import SegConfig as JaxSegConfig
    from cell_image_analysis_tpu.parallel.tiling import tiled_extract_cells_stardist as jax_tiled

    model, variables = _unet()
    seg, green = _frame(seed, n_cells)
    cfg_kw = dict(_SEG, max_candidates=max_candidates, raster_cap=64)
    kw = dict(halo=32, cell_capacity=16)
    ref = jax_tiled(jnp.asarray(seg), jnp.asarray(green), _jax_mesh(), variables,
                    seg_cfg=JaxSegConfig(**cfg_kw), **kw)
    got = tiled_extract_cells_stardist(seg, green, virtual_mesh("cpu", N_TILES), model,
                                       seg_cfg=SegConfig(**cfg_kw), **kw)
    assert got.raster_overflow is bool(ref.raster_overflow) is overflow
    interior = slice(kw["cell_capacity"], (N_TILES - 1) * kw["cell_capacity"])
    _assert_tiles_equal(got, ref, min_cells=0 if overflow else 3, slots=interior)


def test_halo_tiles_end_at_the_frame_edges():
    frame = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3) + 1
    tiles = halo_tiles(frame, virtual_mesh("cpu", 4), halo=2)
    assert [tuple(t.shape) for t in tiles] == [(6, 3), (8, 3), (8, 3), (6, 3)]
    assert torch.equal(tiles[0], frame[:6])
    assert torch.equal(tiles[1], frame[2:10])
    assert torch.equal(tiles[2], frame[6:14])
    assert torch.equal(tiles[3], frame[10:])


@pytest.fixture(scope="module")
def scoring():
    return load_scoring_params(device="cpu")


def _assert_same_screen(tiled, fused, min_cells):
    (s_t, n_t), (s_f, n_f) = tiled, fused
    assert n_t == n_f >= min_cells
    np.testing.assert_allclose(np.sort(s_t["reconstruction_mse"]),
                               np.sort(s_f["reconstruction_mse"]), atol=1e-6)
    for det in ("conservative", "moderate", "ensemble", "fft"):
        assert s_t[f"{det}_anomaly_rate"] == s_f[f"{det}_anomaly_rate"], det


def test_threshold_tiled_equals_fused(scoring):
    model, params = scoring
    seg, green = _frame(11, 8)
    mesh = virtual_mesh("cpu", N_TILES)
    backend = ThresholdBackend()
    scores, stats = score_frames_fused(
        model, params, torch.from_numpy(seg)[None], torch.from_numpy(green)[None], backend,
        fallback_segment_fn=backend.exact_twin(), chunk=32, caps=(64, 96), cell_capacity=64,
        label_capacity=1024, fg_fraction=0.12)
    tiled = tiled_extract_cells(seg, green, mesh, halo=64, cell_capacity=32, label_capacity=512)
    assert not tiled.cell_overflow
    valid = tiled.valid.numpy()
    got = compute_anomaly_scores(*(replicate(mesh, x) for x in (model, params)),
                                 list(tiled.cells.chunk(N_TILES)), valid=valid)
    _assert_same_screen((got, tiled.n_cells), (scores, len(stats["area"])), min_cells=5)
    np.testing.assert_array_equal(np.sort(tiled.area.numpy()[valid]), np.sort(stats["area"]))


def test_stardist_tiled_equals_fused(scoring):
    """The fused side's top-K and NMS budget must not bind (the tiles' top-K
    covers more than the frame's), and both sides rasterize with the
    scatter rasterizer, as in `tests/test_tiling_pipeline.py`."""
    model, params = scoring
    unet, _ = _unet()
    seg, green = _frame(12, 10)
    cfg = SegConfig(**_SEG, max_candidates=512, raster_mode="scatter", nms_max_pairs=1 << 14,
                    raster_cap=128)
    backend = StarDistBackend(None, cfg, model=unet)
    scores, stats = score_frames_fused(
        model, params, torch.from_numpy(seg)[None], torch.from_numpy(green)[None], backend,
        fallback_segment_fn=backend.exact_twin(), chunk=32, caps=(64, 96), cell_capacity=128,
        label_capacity=128, rcap=32)
    tiled = tiled_extract_cells_stardist(seg, green, virtual_mesh("cpu", N_TILES), unet,
                                         seg_cfg=cfg, halo=64, cell_capacity=32)
    assert not tiled.raster_overflow and not tiled.cell_overflow
    valid = tiled.valid.numpy()
    got = compute_anomaly_scores(model, params, tiled.cells, valid=valid)
    _assert_same_screen((got, tiled.n_cells), (scores, len(stats["area"])), min_cells=4)
    np.testing.assert_array_equal(np.sort(tiled.area.numpy()[valid]), np.sort(stats["area"]))


def test_stardist_tiler_asserts_the_pooling_alignment():
    unet, _ = _unet()
    seg, green = _frame(3, 4)
    with pytest.raises(AssertionError, match="align"):
        tiled_extract_cells_stardist(seg, green, virtual_mesh("cpu", N_TILES), unet,
                                     seg_cfg=SegConfig(**_SEG), halo=30)
    with pytest.raises(AssertionError, match="halo must not exceed"):
        tiled_extract_cells_stardist(seg, green, virtual_mesh("cpu", N_TILES), unet,
                                     seg_cfg=SegConfig(**_SEG), halo=68)


@pytest.mark.parametrize("seed,size,n_cells,mutant_fraction", [(3, 384, 30, 0.3),
                                                                (4, 256, 12, 0.0)])
def test_make_plate_equals_make_frame(seed, size, n_cells, mutant_fraction):
    """The windowed plate maker that the card's plate checks use gives the
    JAX package's `make_frame` frames from the same rng."""
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    from cell_image_analysis_tpu_torch.utils.synthetic import make_plate

    ref = make_frame(np.random.default_rng(seed), size=size, n_cells=n_cells,
                     mutant_fraction=mutant_fraction)
    got = make_plate(np.random.default_rng(seed), size=size, n_cells=n_cells,
                     mutant_fraction=mutant_fraction)
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
