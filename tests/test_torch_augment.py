"""PyTorch port: training augmentation (`train/augment.py`) against JAX.

- The warp: parameters drawn by JAX's `train.augment._sample_params` and
  fed to the port's `warp_batch` give JAX's `augment_batch` under the same
  key within atol 1e-5 (float32 sin/cos of the two libraries differ in the
  last bits; measured up to 8.1e-6 at wide ranges).
- All ranges 0 and flips off: the warp is the identity, bit for bit.
- The port's own draws (a seeded `torch.Generator`) lie in their ranges,
  flip at about 0.5, and repeat for the same seed.
"""

import math

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.config import AugmentConfig
from cell_image_analysis_tpu_torch.train.augment import augment_batch, sample_params, warp_batch

torch_threads()

ATOL = 1e-5
_OFF = dict(rotation_range=0, width_shift_range=0, height_shift_range=0, zoom_range=0,
            horizontal_flip=False, vertical_flip=False)
_CONFIGS = {
    "reference": {},
    "wide": dict(rotation_range=30.0, width_shift_range=0.2, height_shift_range=0.1,
                 zoom_range=0.3),
    "no_flips": dict(horizontal_flip=False, vertical_flip=False, rotation_range=10.0),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_warp_equals_jax_on_jax_parameters(name, seed):
    import jax
    import jax.numpy as jnp

    from cell_image_analysis_tpu.config import AugmentConfig as JaxAugmentConfig
    from cell_image_analysis_tpu.train.augment import _sample_params, augment_batch as jax_aug

    cfg = JaxAugmentConfig(**_CONFIGS[name])
    x = np.random.default_rng(seed).uniform(size=(12, 64, 64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    params = [torch.tensor(np.asarray(p)) for p in _sample_params(key, 12, cfg)]
    ref = np.asarray(jax_aug(key, jnp.asarray(x), cfg))
    got = warp_batch(torch.tensor(x), params).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_warp_of_zero_ranges_is_the_identity():
    x = torch.tensor(np.random.default_rng(3).uniform(size=(6, 64, 64, 1)).astype(np.float32))
    out = augment_batch(torch.Generator().manual_seed(1), x, AugmentConfig(**_OFF))
    assert torch.equal(out, x)


def test_sampled_parameters_lie_in_range_and_repeat():
    cfg = AugmentConfig()
    n = 4000
    p = sample_params(torch.Generator().manual_seed(5), n, cfg)
    assert all(t.shape == (n,) for t in p)
    assert float(p.theta.abs().max()) <= cfg.rotation_range * math.pi / 180.0 + 1e-7
    assert float(p.ty.abs().max()) <= cfg.height_shift_range + 1e-7
    assert float(p.tx.abs().max()) <= cfg.width_shift_range + 1e-7
    for z in (p.zy, p.zx):
        assert 1 - cfg.zoom_range - 1e-7 <= float(z.min())
        assert float(z.max()) <= 1 + cfg.zoom_range + 1e-7
    for flip in (p.flip_h, p.flip_v):
        assert flip.dtype == torch.bool and 0.45 < float(flip.float().mean()) < 0.55
    # spread over the range, not stuck at a point
    assert float(p.theta.std()) > 0.5 * cfg.rotation_range * math.pi / 180.0 / math.sqrt(3)
    again = sample_params(torch.Generator().manual_seed(5), n, cfg)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    off = sample_params(torch.Generator().manual_seed(5), n, AugmentConfig(**_OFF))
    assert not bool(off.flip_h.any()) and not bool(off.flip_v.any())
    assert float(off.theta.abs().max()) == 0.0 and float((off.zy - 1).abs().max()) == 0.0


def test_augment_keeps_shape_and_range():
    x = torch.tensor(np.random.default_rng(4).uniform(size=(8, 64, 64, 1)).astype(np.float32))
    out = augment_batch(torch.Generator().manual_seed(2), x)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert float(out.min()) >= -1e-6 and float(out.max()) <= 1.0 + 1e-6
