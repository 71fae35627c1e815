"""PyTorch port: the tile algorithm of the CC kernel
(`csrc/cc_tile_labels.cu`), emulated on the CPU by
`torch_port_helpers.cc_tile_emulation` — tile-local union-find, unions
across tile edges in seeded random orders, global roots, segment counts
and their prefix, ranks from them — bit for bit, in labels and counts,
against the port's `label_components_plain`, JAX
`label_components(impl="sweeps")` and `scipy.ndimage.label` at
connectivity 1 and 2, at small tiles and at the kernel's own; and against
JAX's Pallas kernel in interpret mode on one small mask."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from torch_port_helpers import cc_tile_emulation, torch_threads

from cell_image_analysis_tpu_torch.ops.cc import label_components_plain
from cell_image_analysis_tpu_torch.ops.cuda.cc import TILE_H, TILE_W

torch_threads()

TILES = [(4, 4), (8, 16), (TILE_H, TILE_W)]
ORDERS = (0, 1, 2)   # seeds of the union orders


def _serpentine(h, w):
    """Rows 0, 2, 4, ... full width, joined alternately at the right and the
    left end: one component through every tile."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    return m


def _corner_touch(th, tw):
    """Pixel pairs that touch only diagonally: at a tile corner (both
    diagonals), across a row edge inside a tile column and across a column
    edge inside a tile row.  Eight components at connectivity 1, four at 2."""
    m = np.zeros((2 * th, 3 * tw), bool)
    m[th - 1, tw - 1] = m[th, tw] = True                # corner (th, tw), down-right
    m[th - 1, 2 * tw] = m[th, 2 * tw - 1] = True        # corner (th, 2 tw), down-left
    m[th - 1, 2 * tw + 2] = m[th, 2 * tw + 3] = True    # row edge, inside tile column 2
    m[0, tw - 1] = m[1, tw] = True                      # column edge, inside tile row 0
    return m


@functools.lru_cache(maxsize=None)
def _frames(th: int, tw: int) -> dict:
    rng = np.random.default_rng(th * 100 + tw)
    frames = {f"sides_{h}x{w}": rng.random((2, h, w)) < 0.58
              for h, w in ((1, tw + 1), (th - 1, tw - 1), (th, tw), (th + 1, tw + 1),
                           (2 * th + 1, 1))}
    h, w = 3 * th + 2, 3 * tw + 2
    yy, xx = np.mgrid[0:h, 0:w]
    frames.update({
        "serpentine": _serpentine(h, w)[None],
        "corner_touch": _corner_touch(th, tw)[None],
        "all_true_and_empty": np.stack([np.ones((h, w), bool), np.zeros((h, w), bool)]),
        "checkerboard": ((yy + xx) % 2 == 0)[None],
        "random_0.55": rng.random((2, h, w)) < 0.55,
        "random_0.6": rng.random((2, h, w)) < 0.6,
    })
    return frames


CASES = [(t, name) for t in TILES for name in _frames(*t)]


def _scipy(mask, conn):
    out = [ndi.label(f, structure=None if conn == 1 else np.ones((3, 3), bool)) for f in mask]
    return np.stack([lab for lab, _ in out]).astype(np.int32), np.array([n for _, n in out])


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("tile,name", CASES, ids=[f"{t[0]}x{t[1]}-{n}" for t, n in CASES])
def test_tile_emulation_equals_plain_jax_and_scipy(tile, name, conn):
    from cell_image_analysis_tpu.ops.cc import label_components as jax_label

    mask = _frames(*tile)[name]
    ref, ref_count = _scipy(mask, conn)
    plain, plain_count = label_components_plain(torch.from_numpy(mask), conn)
    assert np.array_equal(plain.numpy(), ref) and np.array_equal(plain_count.numpy(), ref_count)
    for b in range(mask.shape[0]):
        lj, cj = jax_label(jnp.asarray(mask[b]), connectivity=conn, impl="sweeps")
        assert np.array_equal(np.asarray(lj), ref[b]) and int(cj) == ref_count[b]
    for seed in ORDERS:
        got, count = cc_tile_emulation(mask, conn, *tile, seed=seed)
        assert np.array_equal(got, ref), f"union order {seed}"
        assert np.array_equal(count, ref_count), f"union order {seed}"
    if name == "corner_touch":
        assert ref_count[0] == (8 if conn == 1 else 4)


@pytest.mark.parametrize("conn", [1, 2])
def test_tile_emulation_equals_the_pallas_kernel(conn):
    """JAX's TPU kernel, in interpret mode on the CPU, on one 48 x 64 mask
    at 8 x 16 tiles."""
    from cell_image_analysis_tpu.ops.cc import label_components as jax_label

    mask = np.random.default_rng(9).random((48, 64)) < 0.58
    lj, cj = jax_label(jnp.asarray(mask), connectivity=conn, impl="pallas")
    got, count = cc_tile_emulation(mask[None], conn, 8, 16, seed=conn)
    assert np.array_equal(got[0], np.asarray(lj)) and int(count[0]) == int(cj)
