"""PyTorch port: the threshold backend's stage A against JAX's mask route
— the run table (top-k form), the hook CC over runs and its scipy
component numbering (`labels_from_mask`'s parts); the port's label route,
`regionprops_from_labels` of the CC labels, against JAX
`regionprops_from_mask` (area, bbox and `valid` equal; centroid and
eccentricity within atol 1e-4, the tolerance of JAX's own
`tests/test_runs.py`), its run-table overflow flag and capacity dump; and
`stage_a` of `ThresholdBackend()` against JAX
`extract_candidates_from_mask`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend, threshold_mask
from cell_image_analysis_tpu_torch.ops.cc import label_components
from cell_image_analysis_tpu_torch.ops.extract import stage_a
from cell_image_analysis_tpu_torch.ops.runs import (
    _component_numbers,
    cc_runs,
    regionprops_from_labels,
    run_table,
)

torch_threads()

THRESH_STAGE_A = dict(label_capacity=4096, cell_capacity=128, rcap=32)


def _blobs(rng, h=192, w=192, n=12, rmin=6, rmax=20):
    mask = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx = rng.integers(rmax, h - rmax), rng.integers(rmax, w - rmax)
        r = rng.integers(rmin, rmax)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return mask


def _masks(seed):
    rng = np.random.default_rng(seed)
    noise = rng.random((192, 192)) < 0.45
    noise[10, :] = noise[12, :] = True   # full-width rows across an empty one
    noise[11, :] = False
    return np.stack([_blobs(rng), noise])


def test_run_table_matches_jax():
    from cell_image_analysis_tpu.ops.runs import run_table as jax_table

    masks = _masks(0)
    t = run_table(torch.from_numpy(masks), rcap=64)
    for b in range(2):
        tj = jax_table(jnp.asarray(masks[b]), rcap=64, impl="topk")
        np.testing.assert_array_equal(t.start[b].numpy(), np.asarray(tj.start))
        np.testing.assert_array_equal(t.end[b].numpy(), np.asarray(tj.end))
        assert bool(t.overflow[b]) == bool(tj.overflow)


def test_run_table_overflow_flag():
    mask = np.zeros((2, 8, 64), bool)
    mask[0, 3, ::2] = True  # 32 single-pixel runs in one row
    t32 = run_table(torch.from_numpy(mask), rcap=32)
    t16 = run_table(torch.from_numpy(mask), rcap=16)
    assert t32.overflow.tolist() == [False, False]
    assert t16.overflow.tolist() == [True, False]


@pytest.mark.parametrize("conn", [1, 2])
def test_component_numbers_match_jax_and_scipy(conn):
    from cell_image_analysis_tpu.ops.runs import _component_numbers as jax_numbers
    from cell_image_analysis_tpu.ops.runs import cc_runs as jax_cc
    from cell_image_analysis_tpu.ops.runs import run_table as jax_table

    masks = _masks(1)
    t = run_table(torch.from_numpy(masks), rcap=64)
    parent = cc_runs(t, connectivity=conn)
    comp, count = _component_numbers(parent, t.end > 0)
    structure = np.ones((3, 3), bool) if conn == 2 else None
    for b in range(2):
        tj = jax_table(jnp.asarray(masks[b]), rcap=64)
        pj = jax_cc(tj, connectivity=conn)
        cj, nj = jax_numbers(pj, tj.end > 0)
        np.testing.assert_array_equal(parent[b].numpy(), np.asarray(pj))
        np.testing.assert_array_equal(comp[b].numpy(), np.asarray(cj))
        assert int(count[b]) == int(nj) == ndi.label(masks[b], structure=structure)[1]


def _label_props(masks, capacity, rcap, conn=1):
    labels, _ = label_components(torch.from_numpy(masks), connectivity=conn)
    return regionprops_from_labels(labels, capacity=capacity, rcap=rcap)


def _assert_props_equal(pt, pj, b):
    for f in ("area", "min_r", "min_c", "max_r", "max_c", "valid"):
        np.testing.assert_array_equal(getattr(pt, f)[b].numpy(), np.asarray(getattr(pj, f)), f)
    v = np.asarray(pj.valid)
    assert v.sum() >= 5
    for f in ("centroid_r", "centroid_c", "eccentricity"):
        np.testing.assert_allclose(getattr(pt, f)[b].numpy()[v], np.asarray(getattr(pj, f))[v],
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("conn", [1, 2])
def test_label_route_props_match_jax_mask_route(conn):
    from cell_image_analysis_tpu.ops.runs import regionprops_from_mask as jax_props

    masks = _masks(2)
    pt, ovf = _label_props(masks, capacity=600, rcap=64, conn=conn)
    for b in range(2):
        pj, ovf_j = jax_props(jnp.asarray(masks[b]), capacity=600, rcap=64,
                              connectivity=conn)
        assert bool(ovf[b]) == bool(ovf_j) is False
        _assert_props_equal(pt, pj, b)


def test_label_route_capacity_dump():
    # components beyond the capacity are dumped, as in JAX's mask route
    mask = np.zeros((1, 64, 64), bool)
    for c in range(0, 64, 8):
        mask[0, 10:20, c:c + 4] = True
    got, ovf = _label_props(mask, capacity=4, rcap=16)
    assert not bool(ovf[0])
    assert int(got.valid.sum()) == 4
    assert got.area[0].tolist() == [40] * 4


def test_label_route_overflow_matches_jax():
    # a frame's flag fires where JAX's mask route fires: a row of more than
    # rcap runs (its frame re-runs through the exact twin); the other
    # frame's props are JAX's
    from cell_image_analysis_tpu.ops.runs import regionprops_from_mask as jax_props

    masks = _masks(3)
    pt, ovf = _label_props(masks, capacity=600, rcap=8)
    assert ovf.tolist() == [False, True]
    for b in range(2):
        pj, ovf_j = jax_props(jnp.asarray(masks[b]), capacity=600, rcap=8)
        assert bool(ovf_j) == bool(ovf[b])
    _assert_props_equal(pt, jax_props(jnp.asarray(masks[0]), capacity=600, rcap=8)[0], 0)


@pytest.mark.parametrize("seed", [4, 5])
def test_threshold_stage_a_matches_jax_mask_route(seed):
    from cell_image_analysis_tpu.models.segmentation import threshold_mask as jax_mask
    from cell_image_analysis_tpu.ops.extract import (
        extract_candidates_from_mask as jax_extract,
    )
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    frame = make_frame(np.random.default_rng(seed), size=256, n_cells=14)
    seg, green = frame[..., 2].astype(np.float32), frame[..., 1].astype(np.float32)
    mask = np.array(jax_mask(jnp.asarray(seg)))
    np.testing.assert_array_equal(threshold_mask(torch.from_numpy(seg)[None])[0].numpy(), mask)
    cj, ovf_j = jax_extract(jnp.asarray(mask), jnp.asarray(green), **THRESH_STAGE_A)
    ct, ovf_t, labels = stage_a(ThresholdBackend(), torch.from_numpy(seg)[None],
                                torch.from_numpy(green)[None], THRESH_STAGE_A)
    assert labels is None
    assert bool(ovf_t[0]) == bool(ovf_j)
    assert int(ct.n_valid[0]) == int(cj.n_valid) > 0
    for f in ("valid", "label_ids", "area", "heights", "widths"):
        np.testing.assert_array_equal(getattr(ct, f)[0].numpy(), np.asarray(getattr(cj, f)), f)
    np.testing.assert_array_equal(ct.crops[0].numpy(), np.asarray(cj.crops))
    for f in ("eccentricity", "mean_intensity", "std_intensity"):
        np.testing.assert_allclose(getattr(ct, f)[0].numpy(), np.asarray(getattr(cj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
