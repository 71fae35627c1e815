"""PyTorch port: the pixel regionprops (`ops.regionprops.regionprops`) and
`extract_candidates` against JAX on instance label maps — area, bbox and
`valid` equal, centroid and eccentricity within atol 1e-4 (the port sums
the moments exactly in int64, JAX in float32; the tolerance of JAX's own
`tests/test_runs.py`) — including frames whose foreground exceeds the
`fg_fraction` capacity, where both truncate to the same raster-order
prefix of the foreground."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_STAGE_A, torch_threads

from cell_image_analysis_tpu_torch.ops.extract import extract_candidates
from cell_image_analysis_tpu_torch.ops.regionprops import regionprops
from cell_image_analysis_tpu_torch.ops.runs import regionprops_from_labels

torch_threads()


def _instances(seed, size=256, n_cells=14):
    from cell_image_analysis_tpu.utils.synthetic import make_frame_instances

    frames, labels = zip(*(make_frame_instances(np.random.default_rng(seed + i), size=size,
                                                n_cells=n_cells, clustering=0.3)
                           for i in range(2)))
    return (np.stack(labels).astype(np.int32),
            np.stack([f[..., 1] for f in frames]).astype(np.float32))


def _assert_props_match(pt, pj, b):
    for f in ("area", "min_r", "min_c", "max_r", "max_c", "valid"):
        np.testing.assert_array_equal(getattr(pt, f)[b].numpy(), np.asarray(getattr(pj, f)), f)
    v = np.asarray(pj.valid)
    for f in ("centroid_r", "centroid_c", "eccentricity"):
        np.testing.assert_allclose(getattr(pt, f)[b].numpy()[v], np.asarray(getattr(pj, f))[v],
                                   atol=1e-4, err_msg=f)


@pytest.mark.parametrize("capacity,fg_fraction", [(128, 0.25), (8, 0.25), (128, 0.02)])
def test_regionprops_matches_jax(capacity, fg_fraction):
    from cell_image_analysis_tpu.ops.regionprops import regionprops as jax_props

    labels, _ = _instances(0)
    pt = regionprops(torch.from_numpy(labels), capacity=capacity, fg_fraction=fg_fraction)
    for b in range(2):
        pj = jax_props(jnp.asarray(labels[b]), capacity=capacity, fg_fraction=fg_fraction)
        _assert_props_match(pt, pj, b)
    if fg_fraction == 0.02:
        # 1310 px of 65536: the frames' foreground is truncated, so the
        # last labels' stats are partial or missing, as in JAX
        full = regionprops(torch.from_numpy(labels), capacity=capacity)
        assert (labels > 0).sum(axis=(1, 2)).min() > 1310
        assert pt.area.sum(dim=1).tolist() == [1310, 1310]
        assert not torch.equal(pt.area, full.area)


def test_regionprops_agrees_with_run_path_exactly():
    # both sum the same integer moments in int64, so every property agrees
    labels, _ = _instances(2)
    pt = regionprops(torch.from_numpy(labels), capacity=64)
    pr, ovf = regionprops_from_labels(torch.from_numpy(labels), capacity=64, rcap=64)
    assert not ovf.any()
    for f in pt._fields:
        assert torch.equal(getattr(pt, f), getattr(pr, f)), f


@pytest.mark.parametrize("seed,fg_fraction", [(3, 0.25), (5, 0.02)])
def test_extract_candidates_matches_jax(seed, fg_fraction):
    from cell_image_analysis_tpu.ops.extract import extract_candidates as jax_extract

    labels, green = _instances(seed)
    kw = dict(label_capacity=BENCH_STAGE_A["label_capacity"],
              cell_capacity=BENCH_STAGE_A["cell_capacity"], fg_fraction=fg_fraction)
    ct = extract_candidates(torch.from_numpy(labels), torch.from_numpy(green), **kw)
    for b in range(2):
        cj = jax_extract(jnp.asarray(labels[b]), jnp.asarray(green[b]), **kw)
        assert int(ct.n_valid[b]) == int(cj.n_valid) > 0
        for f in ("valid", "label_ids", "area", "heights", "widths"):
            np.testing.assert_array_equal(getattr(ct, f)[b].numpy(), np.asarray(getattr(cj, f)), f)
        np.testing.assert_array_equal(ct.crops[b].numpy(), np.asarray(cj.crops))
        np.testing.assert_allclose(ct.eccentricity[b].numpy(), np.asarray(cj.eccentricity),
                                   atol=1e-4)
        for f in ("mean_intensity", "std_intensity"):
            np.testing.assert_allclose(getattr(ct, f)[b].numpy(), np.asarray(getattr(cj, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
