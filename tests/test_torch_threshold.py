"""PyTorch port: the threshold backend against JAX on synthetic frames —
`binary_opening`, `threshold_mask` and `threshold_segment`, bit-equal.

Both sides lerp order statistics in float32, and XLA may contract a lerp
into an FMA, so a mask pixel may flip where its normalized value lies
within 1 ulp of the threshold (CLAUDE.md).  If one ever does, the test
shows that it lies within 1 ulp, and that every other difference follows
from it; otherwise the masks and label maps must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.models.segmentation import (
    ThresholdBackend,
    binary_opening,
    segment_frame,
    threshold_mask,
    threshold_segment,
)

torch_threads()


def _segs(seed, size, n_cells, n_frames=2):
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    rng = np.random.default_rng(seed)
    return np.stack([make_frame(rng, size=size, n_cells=n_cells)[..., 2]
                     for _ in range(n_frames)]).astype(np.float32)


@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.8), (2, 0.95)])
def test_binary_opening_matches_jax(seed, p):
    from cell_image_analysis_tpu.models.segmentation import binary_opening as jax_open

    masks = np.random.default_rng(seed).random((2, 40, 56)) < p
    masks[1, :, 0] = masks[1, 0, :] = True     # foreground on the frame border
    got = binary_opening(torch.from_numpy(masks)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jax_open(jnp.asarray(masks[b]))))
        np.testing.assert_array_equal(got[b], ndi.binary_opening(masks[b]))


def _near_threshold(x, pct=(3.0, 99.8, 90.0)):
    """Normalized values and threshold of one frame, recomputed in numpy
    float32 from sorted order statistics."""
    from cell_image_analysis_tpu.ops.percentile import percentile_ranks

    xs = np.sort(x.ravel())
    rk = percentile_ranks(x.size, pct)
    f32 = np.float32

    def lerp(i):
        k0, k1, f = rk[i]
        return f32(xs[k0] * (f32(1) - f) + xs[k1] * f)

    lo, hi = lerp(0), lerp(1)
    scale = f32(hi - lo + f32(1e-20))
    k0, k1, f = rk[2]
    thresh = f32(((xs[k0] - lo) / scale) * (f32(1) - f) + ((xs[k1] - lo) / scale) * f)
    return (x - lo) / scale, thresh


def _flip_region(segs, raw_j, raw_t):
    """Pixels a 1-ulp threshold flip may reach after opening and
    labelling; asserts every raw flip is within 1 ulp of the threshold."""
    reach = np.zeros(raw_j.shape, bool)
    for b in range(len(segs)):
        diff = raw_j[b] != raw_t[b]
        if diff.any():
            norm, thresh = _near_threshold(segs[b])
            assert np.all(np.abs(norm[diff] - thresh) <= np.spacing(np.abs(thresh))), \
                "a mask pixel differs away from the threshold"
            reach[b] = ndi.binary_dilation(diff, iterations=2)
    return reach


@pytest.mark.parametrize("seed,size,n_cells", [(0, 128, 6), (1, 192, 10), (2, 256, 14)])
def test_threshold_mask_and_segment_match_jax(seed, size, n_cells):
    from cell_image_analysis_tpu.models.segmentation import threshold_mask as jax_mask
    from cell_image_analysis_tpu.models.segmentation import threshold_segment as jax_segment

    segs = _segs(seed, size, n_cells)
    x = torch.from_numpy(segs)
    raw_t = threshold_mask(x, opening=False).numpy()
    raw_j = np.stack([np.asarray(jax_mask(jnp.asarray(s), opening=False)) for s in segs])
    reach = _flip_region(segs, raw_j, raw_t)

    mask_t = threshold_mask(x).numpy()
    mask_j = np.stack([np.asarray(jax_mask(jnp.asarray(s))) for s in segs])
    assert mask_t.any()
    assert not np.any((mask_t != mask_j) & ~reach)

    lab_t = threshold_segment(x).numpy()
    lab_j = np.stack([np.asarray(jax_segment(jnp.asarray(s))) for s in segs])
    if not reach.any():
        np.testing.assert_array_equal(lab_t, lab_j)
        np.testing.assert_array_equal(
            segment_frame(x).numpy(), lab_j)   # no U-Net: the threshold backend
    for b in range(len(segs)):
        ref, _ = ndi.label(mask_t[b])
        np.testing.assert_array_equal(lab_t[b], ref)


def test_threshold_backend_flags_and_twin():
    segs = torch.from_numpy(_segs(3, 128, 6, n_frames=1))
    backend = ThresholdBackend()
    twin = backend.exact_twin()
    assert backend.runs_props and not twin.runs_props
    assert twin.cfg is backend.cfg
    labels = backend(segs)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), threshold_segment(segs).numpy())
    np.testing.assert_array_equal(twin(segs).numpy(), labels.numpy())
    np.testing.assert_array_equal((labels > 0).numpy(), threshold_mask(segs).numpy())
