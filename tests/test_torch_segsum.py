"""PyTorch port: exact int64 segment sums against the JAX segment-sum
kernel (Pallas, CPU interpret) on integer-valued data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.ops.segsum import segment_sums

torch_threads()


@pytest.mark.parametrize("P,F,n_seg", [(1000, 6, 129), (4096, 4, 17), (33, 1, 3)])
def test_segment_sums_match_jax_pallas(P, F, n_seg):
    from cell_image_analysis_tpu.ops.pallas.segsum import segment_sums_pallas

    rng = np.random.default_rng(P)
    # out-of-range segments (negative and >= n_seg) must be dropped
    seg = rng.integers(-3, n_seg + 3, size=P).astype(np.int32)
    data = rng.integers(-500, 500, size=(P, F)).astype(np.int64)
    ref = np.asarray(segment_sums_pallas(jnp.asarray(seg), jnp.asarray(data.astype(np.float32)),
                                         n_seg))
    got = segment_sums(torch.from_numpy(seg), torch.from_numpy(data), n_seg)
    assert got.dtype == torch.int64 and got.shape == (n_seg, F)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_segment_sums_take_int64_only():
    with pytest.raises(TypeError):
        segment_sums(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2), 3)
