"""PyTorch port: the work split of the fused CLAHE kernel
(`csrc/clahe_cells.cu`), emulated on the CPU by
`torch_port_helpers.clahe_kernel_emulation` — crops read by index in place
from a larger crop tensor, one to four bands of tile rows a cell, band-edge
maps from the neighbouring band, min / max from per-band partials — bit for
bit against the plain `clahe_cells` and against the JAX `clahe_cells`, at
the pipeline's bucket capacities."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import clahe_kernel_emulation, padded_crops, torch_threads

from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, clahe_cells_plain

torch_threads()

# 28, 37 and 46 px give 10 tile rows whose virtual grid folds back: at 4
# bands the last band is one tile row and reads rows above it
_SIDES = (1, 2, 7, 8, 12, 13, 14, 15, 16, 17, 28, 37, 46)
_FULL_CAP = 192


def _sizes(cap: int, ns_cap: int) -> list:
    """Every side of _SIDES and cap against two others; ns_cap 12 takes no
    side of 13-15 (they need 13-15 tiles on that axis)."""
    sides = [s for s in _SIDES + (cap,) if ns_cap == 16 or not 13 <= s <= 15]
    return [(a, sides[(i + k) % len(sides)]) for i, a in enumerate(sides) for k in (0, 3)]


@functools.lru_cache(maxsize=None)
def _case(cap: int, ns_cap: int, kind: str):
    """(crops (N, 192, 192) with garbage padding, ids, heights, widths, the
    JAX reference (C, cap, cap)).  The cells sit at scattered indices of a
    larger crop tensor, as stage A leaves them."""
    from cell_image_analysis_tpu.ops.clahe import clahe_cells as jax_clahe

    rng = np.random.default_rng(cap * 100 + ns_cap)
    sizes = _sizes(cap, ns_cap)
    crops, hs, ws = padded_crops(rng, sizes, _FULL_CAP)
    if kind == "float":
        crops[crops < 1e9] *= np.float32(0.731)
    elif kind == "flat":
        crops[crops < 1e9] = 7.0
    N = 2 * len(sizes) + 3
    order = rng.permutation(N)[:len(sizes)]
    big = np.full((N, _FULL_CAP, _FULL_CAP), 5e8, np.float32)
    big[order] = crops
    heights = np.ones(N, np.int32)
    widths = np.ones(N, np.int32)
    heights[order], widths[order] = hs, ws
    ids = order.astype(np.int32)
    ref = np.asarray(jax_clahe(jnp.asarray(crops[:, :cap, :cap]), jnp.asarray(hs),
                               jnp.asarray(ws), impl="scatter", ns_cap=ns_cap))
    return big, ids, heights, widths, ref


@pytest.mark.parametrize("bands", [1, 2, 4])
@pytest.mark.parametrize("cap,ns_cap", [(64, 12), (64, 16), (96, 12), (96, 16), (192, 16)])
def test_split_bit_equal_to_plain_and_jax(cap, ns_cap, bands):
    crops, ids, hs, ws, ref = _case(cap, ns_cap, "int")
    got = clahe_kernel_emulation(crops, ids, hs, ws, cap, bands, ns_cap=ns_cap)
    plain = clahe_bucket(torch.from_numpy(crops), torch.from_numpy(ids), torch.from_numpy(hs),
                         torch.from_numpy(ws), cap, ns_cap=ns_cap).numpy()
    assert np.array_equal(plain, ref)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("bands", [1, 2, 4])
@pytest.mark.parametrize("kind", ["float", "flat"])
def test_split_float_and_flat_crops(kind, bands):
    crops, ids, hs, ws, ref = _case(64, 16, kind)
    got = clahe_kernel_emulation(crops, ids, hs, ws, 64, bands, ns_cap=16)
    assert np.array_equal(got, ref)
    if kind == "flat":
        assert np.all(got == 0.0)


def test_bucket_is_clahe_cells_of_the_gathered_crops():
    crops, ids, hs, ws, _ = _case(96, 12, "int")
    t = [torch.from_numpy(a) for a in (crops, ids, hs, ws)]
    idx = t[1].long()
    want = clahe_cells_plain(t[0][idx][:, :96, :96], t[2][idx], t[3][idx], ns_cap=12)
    assert torch.equal(clahe_bucket(*t, 96, ns_cap=12), want)
    assert clahe_bucket(t[0], t[1][:0], t[2], t[3], 96, ns_cap=12).shape == (0, 96, 96)
