"""PyTorch port: connected components (`ops.cc.label_components`, whose
plain version `label_components_plain` stands in for the CC kernel on the
CPU) against JAX
`label_components(impl="sweeps")` and `scipy.ndimage.label`: identical
labels and counts at connectivity 1 and 2, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.ops.cc import (
    cc_min_labels_plain,
    label_components,
    label_components_plain,
)

torch_threads()

_STRUCT = {1: None, 2: np.ones((3, 3), bool)}


def _blobs(seed, h=128, w=160, n=10, rmin=4, rmax=16):
    rng = np.random.default_rng(seed)
    mask = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx = rng.integers(rmax, h - rmax), rng.integers(rmax, w - rmax)
        r = rng.integers(rmin, rmax)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return mask


def _serpentine(size=96):
    mask = np.zeros((size, size), bool)
    for i, r in enumerate(range(4, size - 4, 8)):
        mask[r, 4:size - 4] = True
        col = size - 5 if i % 2 == 0 else 4
        mask[r:min(r + 9, size - 4), col] = True
    return mask


def _diagonal():
    mask = np.zeros((16, 16), bool)
    mask[2, 2] = mask[3, 3] = True
    mask[8, 12] = mask[9, 11] = True
    return mask


def _noise(seed):
    return np.random.default_rng(seed).random((64, 72)) < 0.5


MASKS = {"blobs": lambda: _blobs(0), "serpentine": _serpentine,
         "diagonal": _diagonal, "noise": lambda: _noise(1)}


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_label_components_matches_jax_and_scipy(name, conn):
    from cell_image_analysis_tpu.ops.cc import label_components as jax_label

    mask = MASKS[name]()
    ref, ref_count = ndi.label(mask, structure=_STRUCT[conn])
    lj, cj = jax_label(jnp.asarray(mask), connectivity=conn, impl="sweeps")
    lt, ct = label_components(torch.from_numpy(mask)[None], connectivity=conn)
    assert lt.dtype == torch.int32
    assert int(ct[0]) == int(cj) == ref_count
    np.testing.assert_array_equal(lt[0].numpy(), np.asarray(lj))
    np.testing.assert_array_equal(lt[0].numpy(), ref)


def test_diagonal_touch_splits_at_connectivity_1():
    mask = torch.from_numpy(_diagonal())[None]
    assert int(label_components(mask, connectivity=1)[1][0]) == 4
    assert int(label_components(mask, connectivity=2)[1][0]) == 2


def test_batched_frames_label_independently():
    # frames of one batch converge after different numbers of sweeps; each
    # must equal its own single-frame result
    masks = np.stack([_blobs(3, 96, 96), _serpentine(96), np.zeros((96, 96), bool)])
    got, count = label_components(torch.from_numpy(masks), connectivity=1)
    for b in range(len(masks)):
        ref, ref_count = ndi.label(masks[b])
        assert int(count[b]) == ref_count
        np.testing.assert_array_equal(got[b].numpy(), ref)


def test_raw_labels_are_component_minima():
    mask = _blobs(5, 64, 64, n=6)
    raw = cc_min_labels_plain(torch.from_numpy(mask)[None], connectivity=1)[0].numpy()
    ref, n = ndi.label(mask)
    flat = np.arange(mask.size).reshape(mask.shape)
    for k in range(1, n + 1):
        assert set(np.unique(raw[ref == k])) == {flat[ref == k].min() + 1}
    assert (raw[~mask] == 0).all()
    with pytest.raises(ValueError):
        cc_min_labels_plain(torch.from_numpy(mask)[None], connectivity=3)


def test_label_components_on_the_cpu_is_the_plain_version():
    mask = torch.from_numpy(np.stack([_blobs(7, 64, 72), _noise(2)]))
    for conn in (1, 2):
        got, want = label_components(mask, conn), label_components_plain(mask, conn)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        label_components(mask, connectivity=0)
