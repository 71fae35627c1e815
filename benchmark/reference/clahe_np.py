"""Numpy oracle for CLAHE (contrast-limited adaptive histogram equalization).

A frozen copy of the port's `ops/oracle/clahe_np.py`, the benchmark's
reference for the CLAHE of each cell; the rest of this docstring is the
original's.

Faithful re-derivation of the algorithm behind
`skimage.exposure.equalize_adapthist(image, clip_limit=0.02)` at its reference
call sites (CAE_improved_modeltrain.py:92, improved_detection.py:98), written
from the published Zuiderveld algorithm and skimage's documented behavior
(skimage is not a dependency, so this module is the
executable specification that the JAX/Pallas kernel is tested against):

1. Rescale the input to 14-bit gray (0 .. NR_OF_GRAY-1 = 16383) by min-max
   stretch (``rescale_intensity(out_range=(0, NR_OF_GRAY-1))`` with
   in_range='image'), rounding to nearest.
2. kernel_size = shape // 8 per axis (skimage default).
3. Reflect-pad by (k//2) at the start and ((k - s % k) % k + ceil(k/2)) at the
   end of each axis, so the padded size is ceil(s/k)*k + k.
4. Bin with lut[v] = v // (1 + NR_OF_GRAY // nbins)  (nbins=256 -> // 65).
5. Per contextual region (ns_hist = ceil(s/k) tiles per axis, of size k,
   starting at offset k//2 in the padded image): 256-bin histogram; clip at
   clim = max(1, int(clip_limit * k_h * k_w)) with excess redistribution
   (vectorized first pass + Zuiderveld step-spread residual passes);
   mapping = clip(cumsum * (NR_OF_GRAY-1) / (k_h*k_w), max=NR_OF_GRAY-1)
   as integers.
6. For every pixel, bilinear interpolation between the 4 neighboring tile
   mappings (tile grid edge-padded by 1, i.e. border mappings clamped), with
   per-axis coefficient (padded_pos % k) / k; truncate the blended value to
   int (dtype cast).
7. Min-max rescale the result to [0, 1] float.

Known potential divergences from skimage (unverifiable offline — skimage is
not installed; each is bounded and documented):
- residual-excess spread order in step 5's final loop: the residual is
  < nbins counts per tile, so any deviation is below 1/(k_h*k_w) of CDF
  mass;
- skimage quantizes float input through uint16 first (img_as_uint, v*65535
  rounded) before the min-max stretch to 14-bit; this double rounding can
  shift isolated pixels by one 14-bit quantum vs our direct stretch, almost
  always erased by the //65 binning;
- skimage's map_histogram multiplies the cumsum by a float scale then
  truncates (`astype(int)`); we floor the exact integer product — at most
  one gray quantum apart where the float product lands within an ulp of an
  integer;
- skimage blends the 4 corner mappings in float64 then truncates; we
  compute the blend as EXACT integer arithmetic, floor(S / (kh*kw)) with
  S = sum of ny*nx*map over corners (ny/nx the integer coefficient
  numerators) — the true rational value, where the float64 path can land
  one ulp below an integer and floor one quantum low.  Exactness is what
  lets the device kernel (f32 accumulation of integers < 2^24) agree with
  this oracle bit-for-bit instead of inheriting f32-vs-f64 knife-edge
  flips (the r3 parity residue, BENCH.md r3s3/r4s1);
- the clip limit is computed as float32(clip_limit) * float32(kh*kw)
  truncated, mirroring the device kernel (f64 is unavailable on TPU).  In
  principle this could differ from skimage's float64 product by one count
  at knife edges; MEASURED over every reachable tile size (kernel side =
  max(1, s // 8), s <= 256 — tests/test_clahe.py::
  test_clip_limit_f32_vs_f64_divergence_bounded) the divergence class is
  EMPTY: products like 0.02 * 100 land within half an f32 ulp of the
  integer and round back to it, so f32 and f64 clip limits agree
  everywhere the pipeline can reach.
All four are far inside the 1e-3 anomaly-rate tolerance budgeted in
BASELINE.md.  tests/test_clahe_golden.py checks this module against an
independently written literal-loop transcription of the same published
algorithm (different code path: per-pixel loops, no vectorization) so a
vectorization/indexing bug cannot hide in a shared implementation.
"""

from __future__ import annotations

import numpy as np

NR_OF_GRAY = 2 ** 14


def clip_histogram(hist: np.ndarray, clip_limit: int) -> np.ndarray:
    """Clip a histogram at `clip_limit` counts/bin and redistribute the excess
    (Zuiderveld).  `hist` is int64 (nbins,)."""
    hist = hist.astype(np.int64).copy()
    excess_mask = hist > clip_limit
    excess = hist[excess_mask]
    n_excess = int(excess.sum() - excess.size * clip_limit)
    hist[excess_mask] = clip_limit

    # First pass: spread the mean increment into every bin that stays under
    # the limit; bins pushed past the limit are clipped and their overshoot
    # returned to the pool.
    bin_incr = n_excess // hist.size
    upper = clip_limit - bin_incr
    low_mask = hist < upper
    n_excess -= int(low_mask.sum()) * bin_incr
    hist[low_mask] += bin_incr
    mid_mask = (hist >= upper) & (hist < clip_limit)
    mid = hist[mid_mask]
    n_excess += int(mid.sum() - mid.size * clip_limit)
    hist[mid_mask] = clip_limit

    # Residual passes: walk the bins with a stride so the leftovers spread
    # roughly evenly; strictly decreasing n_excess guarantees termination.
    while n_excess > 0:
        step = max(1, hist.size // max(n_excess, 1))
        eligible = (hist < clip_limit) & (np.arange(hist.size) % step == 0)
        take = np.flatnonzero(eligible)[:n_excess]
        if take.size == 0:
            # every bin is at the limit; drop the remainder (degenerate case
            # where clip_limit * nbins < tile pixel count)
            break
        hist[take] += 1
        n_excess -= take.size
    return hist


def equalize_adapthist_np(
    image: np.ndarray,
    clip_limit: float = 0.02,
    nbins: int = 256,
    grid: int = 8,
) -> np.ndarray:
    """CLAHE per the specification above.  Returns float64 in [0, 1]."""
    image = np.asarray(image, dtype=np.float64)
    h, w = image.shape
    lo, hi = image.min(), image.max()
    if hi <= lo:
        return np.zeros_like(image)
    # 14-bit quantization: EXACT integer round-half-even for integer-valued
    # images (every uint16 TIFF channel) — k*16383/D is a small rational, so
    # both this oracle and the device kernel (ops/clahe._quantize14, same
    # predicate verbatim) evaluate it exactly and always agree.  Float-path
    # knife-edge pixels were the r3 parity-flip amplifier (BENCH.md r3s3);
    # vs skimage this is the already-documented one-quantum divergence class
    # (module header), now pinned at exact rational ties only.
    if (np.all(image == np.round(image)) and np.all((image >= 0) & (image < 16777216.0))
            and hi - lo <= 65535.0):
        k = (image - lo).astype(np.int64)
        D = int(hi - lo)
        t = 2 * k * (NR_OF_GRAY - 1) + D
        q = t // (2 * D)
        tie = (t % (2 * D)) == 0
        img14 = q - (tie & (q % 2 == 1))
    else:
        img14 = np.round((image - lo) / (hi - lo) * (NR_OF_GRAY - 1)).astype(np.int64)

    kh, kw = max(1, h // grid), max(1, w // grid)
    pad_top, pad_left = kh // 2, kw // 2
    pad_bot = (kh - h % kh) % kh + int(np.ceil(kh / 2.0))
    pad_right = (kw - w % kw) % kw + int(np.ceil(kw / 2.0))
    padded = np.pad(img14, ((pad_top, pad_bot), (pad_left, pad_right)), mode="reflect")

    bin_size = 1 + NR_OF_GRAY // nbins
    binned = padded // bin_size

    ns_h = padded.shape[0] // kh - 1   # = ceil(h/kh)
    ns_w = padded.shape[1] // kw - 1
    # f32 product to mirror the device kernel exactly (header: divergence 4)
    clim = max(1, int(np.float32(clip_limit) * np.float32(kh * kw)))

    # Per-tile clipped histograms -> gray mappings.
    maps = np.zeros((ns_h, ns_w, nbins), dtype=np.int64)
    for ty in range(ns_h):
        for tx in range(ns_w):
            tile = binned[
                pad_top + ty * kh : pad_top + (ty + 1) * kh,
                pad_left + tx * kw : pad_left + (tx + 1) * kw,
            ]
            hist = np.bincount(tile.ravel(), minlength=nbins)[:nbins]
            hist = clip_histogram(hist, clim)
            # integer floor-division form of cumsum * (NR_OF_GRAY-1)/(kh*kw);
            # differs from skimage's float path by at most one gray quantum
            m = (np.cumsum(hist) * (NR_OF_GRAY - 1)) // (kh * kw)
            maps[ty, tx] = np.minimum(m, NR_OF_GRAY - 1)

    # Bilinear interpolation of mappings over the original pixels — EXACT
    # integer blend: out = floor(S / (kh*kw)) with S = sum over corners of
    # ny*nx*map, ny in {kh-ay, ay}, nx in {kw-ax, ax} (header: divergence 3).
    ys, xs = np.mgrid[0:h, 0:w]
    yp, xp = ys + pad_top, xs + pad_left
    ty, tx = yp // kh, xp // kw
    ay = yp % kh
    ax = xp % kw
    b = binned[pad_top : pad_top + h, pad_left : pad_left + w]

    S = np.zeros((h, w), dtype=np.int64)
    for ey in (0, 1):
        my = np.clip(ty - 1 + ey, 0, ns_h - 1)
        ny = ay if ey else kh - ay
        for ex in (0, 1):
            mx = np.clip(tx - 1 + ex, 0, ns_w - 1)
            nx = ax if ex else kw - ax
            S += ny * nx * maps[my, mx, b]
    out = (S // (kh * kw)).astype(np.float64)
    lo2, hi2 = out.min(), out.max()
    if hi2 <= lo2:
        return np.zeros_like(out)
    return (out - lo2) / (hi2 - lo2)
