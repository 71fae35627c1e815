"""PyTorch port: stage A on label maps against JAX — run-length regionprops
(area and bbox exact, centroid and eccentricity within 1e-5), the QC-pass
set, and the repacked candidates (crops identical)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import BENCH_STAGE_A, torch_threads

from cell_image_analysis_tpu_torch.ops.extract import extract_candidates_from_labels_runs
from cell_image_analysis_tpu_torch.ops.regionprops import qc_mask
from cell_image_analysis_tpu_torch.ops.runs import regionprops_from_labels

torch_threads()


def _instances(seed, size=256, n_cells=14):
    from cell_image_analysis_tpu.utils.synthetic import make_frame_instances

    frame, labels = make_frame_instances(np.random.default_rng(seed), size=size,
                                         n_cells=n_cells, clustering=0.3)
    return labels.astype(np.int32), frame[..., 1].astype(np.float32)


@pytest.mark.parametrize("seed,capacity,rcap", [(0, 128, 32), (1, 8, 32), (2, 128, 2)])
def test_regionprops_from_labels_matches_jax(seed, capacity, rcap):
    from cell_image_analysis_tpu.ops.regionprops import qc_mask as jax_qc
    from cell_image_analysis_tpu.ops.runs import regionprops_from_labels as jax_props

    labels, _ = _instances(seed)
    pj, ovf_j = jax_props(jnp.asarray(labels), capacity=capacity, rcap=rcap)
    pt, ovf_t = regionprops_from_labels(torch.from_numpy(labels)[None], capacity=capacity,
                                        rcap=rcap)
    assert bool(ovf_t[0]) == bool(ovf_j)
    for f in ("area", "min_r", "min_c", "max_r", "max_c", "valid"):
        np.testing.assert_array_equal(getattr(pt, f)[0].numpy(), np.asarray(getattr(pj, f)), f)
    for f in ("centroid_r", "centroid_c", "eccentricity"):
        np.testing.assert_allclose(getattr(pt, f)[0].numpy(), np.asarray(getattr(pj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    h, w = labels.shape
    np.testing.assert_array_equal(qc_mask(pt, h, w)[0].numpy(),
                                  np.asarray(jax_qc(pj, jnp.int32(h), jnp.int32(w))))


@pytest.mark.parametrize("seed", [3, 4])
def test_candidates_from_label_runs_match_jax(seed):
    from cell_image_analysis_tpu.ops.extract import (
        extract_candidates_from_labels_runs as jax_extract,
    )

    labels, green = _instances(seed)
    cj, ovf_j = jax_extract(jnp.asarray(labels), jnp.asarray(green), **BENCH_STAGE_A)
    ct, ovf_t = extract_candidates_from_labels_runs(
        torch.from_numpy(labels)[None], torch.from_numpy(green)[None], **BENCH_STAGE_A)
    assert bool(ovf_t[0]) == bool(ovf_j)
    assert int(ct.n_valid[0]) == int(cj.n_valid) > 0
    for f in ("valid", "label_ids", "area", "heights", "widths"):
        np.testing.assert_array_equal(getattr(ct, f)[0].numpy(), np.asarray(getattr(cj, f)), f)
    np.testing.assert_array_equal(ct.crops[0].numpy(), np.asarray(cj.crops))
    for f in ("eccentricity", "mean_intensity", "std_intensity"):
        np.testing.assert_allclose(getattr(ct, f)[0].numpy(), np.asarray(getattr(cj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
