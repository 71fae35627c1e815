"""PyTorch port: the radix select of `ops/percentile.kth_smallest`.

On the CPU, the plain digit passes (`kth_smallest_plain`) against
`torch.kthvalue`, `np.partition` and a numpy sort of the same order-
preserving keys (bit for bit), and `normalize_percentile` and
`threshold_mask` against numpy constructions.  The tests marked `cuda`
hold the kernel (`csrc/kthvalue_radix.cu`) to the plain version bit for bit
on the card and skip without one; on a GPU machine run

    python -m pytest tests/test_torch_kthvalue_radix.py -q
"""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from cell_image_analysis_tpu_torch.models.segmentation import threshold_mask
from cell_image_analysis_tpu_torch.ops.cuda.kthvalue import blocks_per_frame
from cell_image_analysis_tpu_torch.ops.percentile import (
    kth_smallest,
    kth_smallest_plain,
    normalize_percentile,
    percentile_ranks,
)
from cell_image_analysis_tpu_torch.utils import profiler

NORM_Q = (3.0, 99.8)
THRESH_Q = (3.0, 99.8, 90.0)


def _frames(kind: str, B: int, n: int, seed: int) -> np.ndarray:
    """(B, n) float32 frames of one kind of data."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(scale=500, size=(B, n)).astype(np.float32)
    if kind == "image":   # uint16 counts: background 80 +- 10, bright blobs
        x = rng.normal(80, 10, size=(B, n))
        x[rng.uniform(size=(B, n)) < 0.08] += rng.uniform(900, 1500)
        return np.clip(np.round(x), 0, 65535).astype(np.float32)
    if kind == "constant":
        return np.full((B, n), 7.25, np.float32)
    if kind == "ties":   # three values, each key's top 22 bits the same
        base = np.float32(1.0).view(np.uint32)
        return (base + rng.integers(0, 3, size=(B, n)).astype(np.uint32)).view(np.float32)
    if kind == "narrow":   # one top digit, many second digits: ranks share a top digit
        return rng.uniform(1.0, 1.25, size=(B, n)).astype(np.float32)
    if kind == "special":   # negatives, both zeros, both infinities, NaN
        pool = np.array([-np.inf, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0, np.inf, np.nan,
                         -np.nan], np.float32)
        return rng.choice(pool, size=(B, n)).astype(np.float32)
    raise ValueError(kind)


def _ranks(n: int) -> list:
    """Rank tuples: the ends, a repeat, and the normalization's 4 and the
    threshold's 6 ranks."""
    four = tuple(k for r in percentile_ranks(n, NORM_Q) for k in r[:2])
    six = tuple(k for r in percentile_ranks(n, THRESH_Q) for k in r[:2])
    return [(0, n - 1), (n // 2, 0, n // 2, n - 1), four, six]


def _by_keys(x: np.ndarray, ks: tuple) -> np.ndarray:
    """The ranks of each row by a numpy sort of the order-preserving uint32
    keys: negative floats' bits flipped, positive floats' sign bit set, NaN
    above +inf; every NaN reads as the canonical NaN."""
    u = x.view(np.uint32)
    key = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))
    key = np.where(np.isnan(x), np.uint32(0xFFC00000), key)
    k = np.sort(key, axis=1)[:, list(ks)]
    return np.where(k >> 31 == 1, k & np.uint32(0x7FFFFFFF), ~k).astype(np.uint32).view(
        np.float32)


SHAPES = [(1, 1), (2, 1), (16, 1), (1, 2), (2, 3), (16, 5), (1, 17), (2, 1000), (16, 4099),
          (2, 65537), (16, 16411), (1, 1024 * 1024)]
CASES = ([(B, n, "normal") for B, n in SHAPES] + [(B, n, "image") for B, n in SHAPES[5:]]
         + [(2, 3, "constant"), (16, 4099, "constant"), (1, 1000, "ties"), (16, 4099, "ties"),
            (2, 1000, "narrow"), (16, 65537, "narrow"),
            (2, 1000, "special"), (16, 4099, "special"), (1, 65537, "special")])


@pytest.mark.parametrize("B,n,kind", CASES)
def test_plain_radix_select_matches_kthvalue_and_partition(B, n, kind):
    x = _frames(kind, B, n, seed=B * 7919 + n)
    t = torch.from_numpy(x)
    for ks in _ranks(n):
        got = kth_smallest_plain(t, ks).numpy()
        assert got.shape == (B, len(ks)) and got.dtype == np.float32
        # bit for bit: the element of the same key
        np.testing.assert_array_equal(got.view(np.uint32), _by_keys(x, ks).view(np.uint32))
        # equal values (a -0.0 tied with +0.0 may read as either, NaN as NaN)
        ref = torch.stack([torch.kthvalue(t, k + 1, dim=1).values for k in ks], dim=1)
        np.testing.assert_array_equal(got, ref.numpy())
        part = np.partition(x, sorted(set(ks)), axis=1)[:, list(ks)]
        np.testing.assert_array_equal(got, part)


def test_kth_smallest_counts_frames_and_checks_ranks(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("kth_smallest reached a library selection")

    for name in ("kthvalue", "sort", "topk"):
        monkeypatch.setattr(torch, name, refuse)
    x = torch.from_numpy(_frames("image", 3, 4096, seed=5)).reshape(3, 64, 64)
    before = profiler.counters().get("percentile.frames", 0)
    got = kth_smallest(x, (4095, 0, 17))
    assert profiler.counters().get("percentile.frames", 0) == before + 3
    monkeypatch.undo()
    np.testing.assert_array_equal(got.numpy(), _by_keys(x.reshape(3, -1).numpy(), (4095, 0, 17)))
    for bad in ((4096,), (-1,), (0, 4096)):
        with pytest.raises(ValueError, match="outside"):
            kth_smallest(x, bad)


@pytest.mark.parametrize("frames,n,sms,want", [
    (16, 1024 * 1024, 132, 33),       # the 1024^2 cells: 528 blocks, 31,776 elements each
    (2, 4096 * 4096, 132, 264),       # the 4096^2 cell: 528 blocks
    (1, 100, 132, 1),                 # smaller than one block's share
    (4, 16384 * 3 + 1, 132, 4),       # by size: a block at least 16,384 elements
    (1000, 1024 * 1024, 132, 1),      # more frames than one wave of blocks
])
def test_blocks_per_frame(frames, n, sms, want):
    assert blocks_per_frame(frames, n, sms) == want


def _np_lerp(xs, rk, i):
    k0, k1, f = rk[i]
    return np.float32(xs[k0] * (np.float32(1) - f) + xs[k1] * f)


@pytest.mark.parametrize("B,side,kind", [(1, 64, "image"), (3, 97, "normal"), (2, 256, "image")])
def test_normalize_percentile_cpu_matches_numpy(B, side, kind):
    x = _frames(kind, B, side * side, seed=side).reshape(B, side, side)
    got = normalize_percentile(torch.from_numpy(x)).numpy()
    for b in range(B):
        xs = np.sort(x[b].ravel())
        rk = percentile_ranks(xs.size, NORM_Q)
        lo, hi = _np_lerp(xs, rk, 0), _np_lerp(xs, rk, 1)
        ref = (x[b] - lo) / np.float32(hi - lo + np.float32(1e-20))
        np.testing.assert_array_equal(got[b], ref)
        np.testing.assert_allclose(got[b], (x[b] - np.percentile(x[b], 3.0)) / (
            np.percentile(x[b], 99.8) - np.percentile(x[b], 3.0)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,side,kind", [(1, 64, "image"), (3, 97, "normal"), (2, 256, "image")])
def test_threshold_mask_cpu_matches_numpy(B, side, kind):
    x = _frames(kind, B, side * side, seed=side + 1).reshape(B, side, side)
    got = threshold_mask(torch.from_numpy(x)).numpy()
    f32 = np.float32
    for b in range(B):
        xs = np.sort(x[b].ravel())
        rk = percentile_ranks(xs.size, THRESH_Q)
        lo, hi = _np_lerp(xs, rk, 0), _np_lerp(xs, rk, 1)
        scale = f32(hi - lo + f32(1e-20))
        k0, k1, f = rk[2]
        thresh = f32(((xs[k0] - lo) / scale) * (f32(1) - f) + ((xs[k1] - lo) / scale) * f)
        ref = ndi.binary_opening((x[b] - lo) / scale > thresh)
        np.testing.assert_array_equal(got[b], ref)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


CARD_CASES = ([(16, 1024 * 1024, "image"), (2, 4096 * 4096, "image"), (16, 1024 * 1024, "normal"),
               (2, 4096 * 4096, "normal")]
              + [(B, n, kind) for B, n, kind in CASES if n < 1024 * 1024]
              + [(3, 1024 * 1024 + 3, "image"), (1, 4096 * 4096 - 1, "special"),
                 (64, 777, "ties"), (300, 4099, "image"), (2, 4096 * 4096, "narrow")])


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,kind", CARD_CASES)
def test_kernel_matches_plain_bit_for_bit(dev, B, n, kind):
    from cell_image_analysis_tpu_torch.ops.cuda import kthvalue as launcher

    x = torch.from_numpy(_frames(kind, B, n, seed=B + n)).to(dev)
    for ks in _ranks(n):
        before = launcher.LAUNCHES
        got = kth_smallest(x, ks)
        assert launcher.LAUNCHES == before + 1
        assert _bits_equal(got, kth_smallest_plain(x, ks))
        ref = torch.stack([torch.kthvalue(x, k + 1, dim=1).values for k in ks], dim=1)
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert _bits_equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, ref))


@pytest.mark.cuda
def test_kernel_takes_columns_in_calls_of_eight(dev):
    from cell_image_analysis_tpu_torch.ops.cuda import kthvalue as launcher

    n = 5000
    x = torch.from_numpy(_frames("normal", 4, n, seed=3)).to(dev)
    ks = tuple(range(0, n, 250)) + (0, 4999)          # 22 columns, a repeat
    before = launcher.LAUNCHES
    got = kth_smallest(x, ks)
    assert launcher.LAUNCHES == before + 3   # one call a chunk of 8 columns
    assert _bits_equal(got, kth_smallest_plain(x, ks))


@pytest.mark.cuda
def test_kernel_does_not_synchronize(dev):
    x = torch.from_numpy(_frames("image", 16, 256 * 256, seed=9)).to(dev).reshape(16, 256, 256)
    ks = tuple(k for r in percentile_ranks(256 * 256, THRESH_Q) for k in r[:2])
    want = kth_smallest(x, ks)          # builds and loads the library
    norm = normalize_percentile(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kth_smallest(x, ks)
        got_norm = normalize_percentile(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _bits_equal(got, want) and _bits_equal(got_norm, norm)


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_a_library_selection(dev, monkeypatch):
    x = torch.from_numpy(_frames("image", 2, 65536, seed=4)).to(dev).reshape(2, 256, 256)
    want = kth_smallest_plain(x.reshape(2, -1), (10, 65000))

    def refuse(*args, **kwargs):
        raise AssertionError("kth_smallest reached a library selection on the card")

    for name in ("kthvalue", "sort", "topk"):
        monkeypatch.setattr(torch, name, refuse)
    got = kth_smallest(x, (10, 65000))
    norm = normalize_percentile(x)
    mask = threshold_mask(x)
    monkeypatch.undo()
    assert _bits_equal(got, want)
    assert norm.shape == x.shape and mask.shape == x.shape
