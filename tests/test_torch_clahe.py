"""PyTorch port: `clahe_cells` bit for bit against the JAX CLAHE, on its
"scatter" path and on its Pallas-kernel path (CPU interpret), at the
pipeline's bucket capacities (64/96 at ns_cap 12, 192 at ns_cap 16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import padded_crops, torch_threads

from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells

torch_threads()

# sides 13-15 need 13-15 tiles on that axis, so they only fit ns_cap 16
_CASES = [
    (64, 12, [(64, 64), (17, 23), (40, 12)]),
    (64, 16, [(13, 64), (64, 15), (14, 14)]),
    (96, 12, [(96, 96), (33, 47), (16, 80)]),
    (96, 16, [(96, 41), (15, 90), (50, 13)]),
    (192, 12, [(150, 97), (192, 192)]),
    (192, 16, [(97, 41), (13, 150), (11, 64)]),
]


def _jax(crops, hs, ws, impl, ns_cap):
    from cell_image_analysis_tpu.ops.clahe import clahe_cells as jax_clahe

    kw = {} if impl == "pallas" else {"ns_cap": ns_cap}
    return np.asarray(jax_clahe(jnp.asarray(crops), jnp.asarray(hs), jnp.asarray(ws),
                                impl=impl, **kw))


@pytest.mark.parametrize("impl", ["scatter", "pallas"])
@pytest.mark.parametrize("cap,ns_cap,sizes", _CASES)
def test_clahe_bit_equal_to_jax(cap, ns_cap, sizes, impl):
    rng = np.random.default_rng(cap + ns_cap)
    crops, hs, ws = padded_crops(rng, sizes, cap)
    ref = _jax(crops, hs, ws, impl, ns_cap)
    got = clahe_cells(torch.from_numpy(crops), torch.from_numpy(hs), torch.from_numpy(ws),
                      ns_cap=ns_cap).numpy()
    assert np.array_equal(got, ref)


def test_clahe_non_integer_crops_match_jax():
    # float-valued crops take the float32 quantization branch on both sides
    rng = np.random.default_rng(5)
    crops = rng.uniform(size=(2, 64, 64)).astype(np.float32) * 7.3
    hs = np.array([64, 40], np.int32)
    ws = np.array([50, 64], np.int32)
    ref = _jax(crops, hs, ws, "scatter", 16)
    got = clahe_cells(torch.from_numpy(crops), torch.from_numpy(hs), torch.from_numpy(ws)).numpy()
    assert np.array_equal(got, ref)


def test_clahe_flat_crop_is_zero():
    crops = np.full((1, 64, 64), 7.0, np.float32)
    one = torch.tensor([40], dtype=torch.int32)
    out = clahe_cells(torch.from_numpy(crops), one, one).numpy()
    assert np.all(out == 0.0)
