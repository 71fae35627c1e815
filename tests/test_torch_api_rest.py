"""PyTorch port: the JAX package's public functions that the screening
path does not call, each against the JAX function on the same seeded numpy
inputs, at the tolerance of the JAX test at that spot.

- `ops/percentile.masked_percentile` (tests/test_percentile.py: 1e-5);
- `ops/runs.labels_from_mask`: labels, count and overflow bit for bit at
  connectivity 1 and 2, the full-width rows of tests/test_runs.py:106-127
  at rcap 8, and a row of more runs than rcap (the overflow case);
- `ops/resize.resize_image` (tests/test_resize.py: 2e-5, identity 1e-6);
- `ops/extract.ExtractedCells` / `extract_cells`: validity, label ids,
  areas and candidate counts bit for bit, cells 5e-4, means rtol 1e-5,
  stds rtol 1e-4 (tests/test_extract.py), eccentricities 1e-5;
- `ops/nms.polygon_vertices` (float32 ulps) and the dense
  `overlap_matrix` against JAX's (the quadrature's float32 sums and
  libm's atan2 may move a sample point across a boundary: 0.02, the
  near-symmetry gate of tests/test_nms_rasterize.py), and equal to
  `overlap_matrix_sparse` on every pair the sparse form keeps;
- `models/ensemble.ensemble_predict`: bit for bit;
- `models/unet.unet_forward`: prob within 1e-5, dist within 1e-5 of its
  largest value (tests/test_torch_unet.py);
- `utils/profiler.trace`: writes a Chrome trace into the directory, does
  nothing on None or "", and lets the block's exception through.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from torch_port_helpers import torch_threads

torch_threads()


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("q", [95.0, 3.0, [5.0, 50.0, 99.0]])
def test_masked_percentile_matches_jax(q):
    from cell_image_analysis_tpu.ops.percentile import masked_percentile as jax_mp
    from cell_image_analysis_tpu_torch.ops.percentile import masked_percentile

    rng = _rng(0)
    x = rng.normal(size=(64,)).astype(np.float32)
    mask = rng.uniform(size=(64,)) > 0.4
    ref = np.asarray(jax_mp(jnp.asarray(x), jnp.asarray(mask), q))
    got = masked_percentile(torch.from_numpy(x), torch.from_numpy(mask), q).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.percentile(x[mask], q), atol=1e-5, rtol=0)


def _blobs(rng, h=96, w=96, n=12):
    mask = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 10)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return mask


def _full_width_rows(rng):
    mask = np.asarray(rng.random((64, 64)) < 0.45)
    mask[10, :] = mask[12, :] = True
    mask[11, :] = False
    return mask


def _many_runs(rng):
    mask = np.zeros((8, 64), bool)
    mask[3, ::2] = True       # 32 single-pixel runs in one row
    mask[4, 1::4] = True
    mask[5:7, 10:30] = True
    return mask


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("case,rcap", [("blobs", 64), ("noise", 64), ("full_rows", 8),
                                       ("full_rows_random", 64), ("overflow", 16)])
def test_labels_from_mask_matches_jax(case, rcap, conn):
    from cell_image_analysis_tpu.ops.runs import labels_from_mask as jax_lfm
    from cell_image_analysis_tpu_torch.ops.runs import labels_from_mask

    rng = _rng(1)
    if case == "blobs":
        mask = _blobs(rng)
    elif case == "noise":
        mask = np.asarray(rng.random((96, 96)) < 0.55)
    elif case == "full_rows":
        mask = np.zeros((5, 32), bool)
        mask[1, :] = mask[3, :] = True
    elif case == "full_rows_random":
        mask = _full_width_rows(rng)
    else:
        mask = _many_runs(rng)
    ref, ref_count, ref_ovf = jax_lfm(jnp.asarray(mask), rcap=rcap, connectivity=conn)
    got, count, ovf = labels_from_mask(torch.from_numpy(mask), rcap=rcap, connectivity=conn)
    assert got.dtype == torch.int32 and got.shape == mask.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(count) == int(ref_count)
    assert bool(ovf) == bool(ref_ovf) == (case == "overflow")
    if case != "overflow":
        lab, n = ndi.label(mask, structure=None if conn == 1 else np.ones((3, 3), bool))
        assert int(count) == n
        np.testing.assert_array_equal(got.numpy(), lab)


def test_labels_from_mask_batched_equals_single_frames():
    from cell_image_analysis_tpu_torch.ops.runs import labels_from_mask

    rng = _rng(2)
    masks = torch.from_numpy(np.stack([_blobs(rng), _blobs(rng), np.zeros((96, 96), bool)]))
    got, count, ovf = labels_from_mask(masks, rcap=64)
    for b in range(3):
        one = labels_from_mask(masks[b], rcap=64)
        assert torch.equal(got[b], one[0]) and int(count[b]) == int(one[1])
        assert bool(ovf[b]) == bool(one[2])
    assert int(count[2]) == 0


@pytest.mark.parametrize("shape,out", [((256, 256), 64), ((64, 64), 64), ((150, 97), 64),
                                       ((40, 52), 64)])
def test_resize_image_matches_jax(shape, out):
    from cell_image_analysis_tpu.ops.resize import resize_image as jax_resize
    from cell_image_analysis_tpu_torch.ops.resize import resize_image

    img = _rng(3).uniform(size=shape).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(img), out))
    got = resize_image(torch.from_numpy(img), out).numpy()
    assert got.shape == (out, out) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    if shape == (out, out):
        np.testing.assert_allclose(got, img, atol=1e-6, rtol=0)


def _extract_inputs(case):
    """(labels, green): the threshold labels of a synthetic 384^2 frame
    (tests/test_extract.py), a dark frame (every region fails the mean
    gate) or an empty one."""
    from cell_image_analysis_tpu.models.segmentation import threshold_segment
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    if case == "frame":
        frame = make_frame(_rng(4), size=384, n_cells=14)
        labels = np.asarray(threshold_segment(jnp.asarray(frame[..., 2].astype(np.float32))))
        return labels.astype(np.int32), frame[..., 1].astype(np.float32)
    labels = np.zeros((128, 128), np.int32)
    if case == "dark":
        yy, xx = np.mgrid[0:128, 0:128]
        labels[(yy - 64) ** 2 + (xx - 64) ** 2 <= 15 ** 2] = 1
        return labels, np.full((128, 128), 0.2, np.float32)
    return labels, np.zeros((128, 128), np.float32)


@pytest.mark.parametrize("case,capacity", [("frame", 64), ("frame", 4), ("dark", 16),
                                           ("empty", 16)])
def test_extract_cells_matches_jax(case, capacity):
    from cell_image_analysis_tpu.ops.extract import extract_cells as jax_extract
    from cell_image_analysis_tpu_torch.ops.extract import ExtractedCells, extract_cells

    labels, green = _extract_inputs(case)
    ref = jax_extract(jnp.asarray(labels), jnp.asarray(green), cell_capacity=capacity)
    got = extract_cells(torch.from_numpy(labels), torch.from_numpy(green),
                        cell_capacity=capacity)
    assert isinstance(got, ExtractedCells) and got._fields == ref._fields
    valid = np.asarray(ref.valid)
    for k in ("valid", "label_ids", "area", "n_candidates"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), k)
    np.testing.assert_allclose(got.cells.numpy(), np.asarray(ref.cells), atol=5e-4, rtol=0)
    np.testing.assert_allclose(got.mean_intensity.numpy(), np.asarray(ref.mean_intensity),
                               rtol=1e-5)
    np.testing.assert_allclose(got.std_intensity.numpy(), np.asarray(ref.std_intensity),
                               rtol=1e-4)
    np.testing.assert_allclose(got.eccentricity.numpy(), np.asarray(ref.eccentricity),
                               atol=1e-5)
    if case == "frame":
        assert valid.sum() >= min(capacity, 5)
    if case == "dark":
        assert int(got.n_candidates) == 1 and not valid.any()


def test_extract_cells_equals_the_repacked_candidates():
    """The port's stage A (`extract_candidates`, repacked) and stage B hold
    the same cells as `extract_cells`' valid slots, in the same order."""
    from cell_image_analysis_tpu_torch.ops.extract import extract_cells, extract_cells_chunked

    labels, green = (torch.from_numpy(a) for a in _extract_inputs("frame"))
    got = extract_cells(labels, green, cell_capacity=64)
    cells, stats = extract_cells_chunked(labels, green, cell_capacity=64)
    v = got.valid
    assert torch.equal(got.cells[v], torch.from_numpy(cells))
    np.testing.assert_array_equal(got.label_ids[v].numpy(), stats["label_ids"])
    np.testing.assert_array_equal(got.area[v].numpy(), stats["area"])


def _polygons(seed, K=40, R=32, size=96):
    rng = _rng(seed)
    centers = rng.uniform(10, size - 10, size=(K, 2)).astype(np.float32).round()
    dists = rng.uniform(4, 14, size=(K, R)).astype(np.float32)
    return centers, dists


@pytest.mark.parametrize("R", [32, 8])
def test_polygon_vertices_match_jax(R):
    from cell_image_analysis_tpu.ops.nms import polygon_vertices as jax_vertices
    from cell_image_analysis_tpu_torch.ops.nms import polygon_vertices

    c, d = _polygons(5, K=12, R=R)
    ref = np.asarray(jax_vertices(jnp.asarray(c), jnp.asarray(d)))
    got = polygon_vertices(torch.from_numpy(c), torch.from_numpy(d))
    assert got.shape == (12, R, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)
    both = polygon_vertices(torch.from_numpy(np.stack([c, c])), torch.from_numpy(np.stack([d, d])))
    assert torch.equal(both[1], got)


@pytest.mark.parametrize("metric", ["iou", "ios"])
def test_overlap_matrix_matches_jax(metric):
    from cell_image_analysis_tpu.ops.nms import overlap_matrix as jax_overlap
    from cell_image_analysis_tpu_torch.ops.nms import overlap_matrix

    c, d = _polygons(6)
    ref = np.asarray(jax_overlap(jnp.asarray(c), jnp.asarray(d), metric=metric))
    got = overlap_matrix(torch.from_numpy(c), torch.from_numpy(d), metric=metric).numpy()
    assert got.shape == ref.shape == (40, 40) and (got > 0.05).sum() > 10
    np.testing.assert_array_equal(np.diag(got), 0.0)
    np.testing.assert_allclose(got, ref, atol=0.02, rtol=0)
    assert np.mean(np.abs(got - ref) < 1e-5) > 0.99


@pytest.mark.parametrize("metric", ["iou", "ios"])
def test_overlap_matrix_equals_sparse_on_its_pairs(metric):
    """On each pair the sparse form keeps, its entry (integrated over the
    smaller polygon; the lower index on a tie) is the dense entry with
    that polygon as i, bit for bit; batched as one frame at a time."""
    from cell_image_analysis_tpu_torch.ops.nms import (
        overlap_matrix,
        overlap_matrix_sparse,
        polygon_areas,
    )

    c, d = (torch.from_numpy(np.stack(a)) for a in zip(_polygons(6), _polygons(7)))
    valid = torch.ones(c.shape[:2], dtype=torch.bool)
    dense = overlap_matrix(c, d, metric=metric)
    sparse, ovf = overlap_matrix_sparse(c, d, valid, metric=metric, max_pairs=None)
    assert not bool(ovf.any())
    areas = polygon_areas(d)
    n_pairs = 0
    for b in range(2):
        assert torch.equal(dense[b], overlap_matrix(c[b], d[b], metric=metric))
        ii, jj = torch.nonzero(torch.triu(sparse[b] > 0, diagonal=1), as_tuple=True)
        small_i = areas[b, ii] <= areas[b, jj]
        pi, pj = torch.where(small_i, ii, jj), torch.where(small_i, jj, ii)
        assert torch.equal(dense[b, pi, pj], sparse[b, pi, pj])
        n_pairs += ii.numel()
    assert n_pairs > 20


def test_ensemble_predict_matches_jax():
    from cell_image_analysis_tpu.models.ensemble import ensemble_predict as jax_predict
    from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector, ensemble_predict

    rng = _rng(8)
    mse = rng.uniform(0, 0.02, size=500).astype(np.float32)
    cons = rng.choice([-1, 1], size=500).astype(np.int32)
    mod = rng.choice([-1, 1], size=500).astype(np.int32)
    thr = np.float32(0.011)
    for min_votes in (1, 2, 3):
        ref = np.asarray(jax_predict(jnp.asarray(mse), jnp.asarray(cons), jnp.asarray(mod),
                                     jnp.float32(thr), min_votes))
        got = ensemble_predict(torch.from_numpy(mse), torch.from_numpy(cons),
                               torch.from_numpy(mod), torch.tensor(thr), min_votes)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            EnsembleDetector(float(thr), min_votes).predict(mse, cons, mod), ref)


def test_unet_forward_matches_jax():
    import jax

    from cell_image_analysis_tpu.models.unet import init_unet
    from cell_image_analysis_tpu.models.unet import unet_forward as jax_forward
    from cell_image_analysis_tpu_torch.io.artifacts import unet_state_from_jax
    from cell_image_analysis_tpu_torch.models.unet import StarDistUNet, unet_forward

    model_j, variables = init_unet(jax.random.PRNGKey(1), size=64, base_filters=4,
                                   head_filters=16)
    model_t = StarDistUNet(base_filters=4, head_filters=16)
    model_t.load_state_dict(unet_state_from_jax(variables))
    x = _rng(9).uniform(size=(2, 64, 64, 1)).astype(np.float32)
    prob_j, dist_j = (np.asarray(a) for a in jax_forward(model_j, variables, jnp.asarray(x)))
    prob_t, dist_t = unet_forward(model_t, torch.from_numpy(x))
    assert not prob_t.requires_grad and not dist_t.requires_grad
    assert prob_t.shape == (2, 32, 32) and dist_t.shape == (2, 32, 32, 32)
    np.testing.assert_allclose(prob_t.numpy(), prob_j, rtol=0, atol=1e-5)
    scale = float(np.abs(dist_j).max())
    np.testing.assert_allclose(dist_t.numpy(), dist_j, rtol=0, atol=1e-5 * scale)


def test_trace_writes_a_chrome_trace(tmp_path):
    from cell_image_analysis_tpu_torch.utils.profiler import trace

    out = tmp_path / "trace"
    with trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_does_nothing(log_dir, tmp_path, monkeypatch):
    from cell_image_analysis_tpu_torch.utils.profiler import trace

    monkeypatch.chdir(tmp_path)
    with trace(log_dir):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_lets_the_exception_through(tmp_path):
    from cell_image_analysis_tpu_torch.utils.profiler import trace

    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path)):
            1 / 0
    assert len(os.listdir(tmp_path)) == 1
