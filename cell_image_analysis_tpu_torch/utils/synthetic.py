"""Synthetic fluorescence frames, in numpy only.

The same arithmetic as `cell_image_analysis_tpu/utils/synthetic.py`, so the
same `rng` gives byte-identical frames (a test holds them equal): channel
2 is the segmentation marker, channel 1 the green analysis channel.  Cells
are elliptical Gaussian blobs with ring texture; a `mutant_fraction` of
them are larger, brighter and lumpier.  `make_cells` makes pre-extracted
64x64 cells for the training bench.
"""

from __future__ import annotations

import os

import numpy as np


def make_frame(rng: np.random.Generator, size: int = 512, n_cells: int = 25,
               mutant_fraction: float = 0.0, background: float = 80.0,
               noise: float = 10.0) -> np.ndarray:
    """One (size, size, 3) uint16 frame."""
    seg = np.full((size, size), background, np.float64)
    green = np.full((size, size), background, np.float64)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)

    for _ in range(n_cells):
        mutant = rng.uniform() < mutant_fraction
        cy, cx = rng.uniform(30, size - 30, 2)
        r = rng.uniform(9, 16) * (1.6 if mutant else 1.0)
        aspect = rng.uniform(1.0, 1.8)
        theta = rng.uniform(0, np.pi)
        amp = rng.uniform(900, 1500) * (1.8 if mutant else 1.0)

        dy, dx = yy - cy, xx - cx
        u = np.cos(theta) * dy + np.sin(theta) * dx
        v = -np.sin(theta) * dy + np.cos(theta) * dx
        d2 = (u / (r * aspect)) ** 2 + (v / r) ** 2
        body = np.exp(-d2 * 2.5)
        seg += amp * body
        ring = np.exp(-((np.sqrt(d2) - 0.7) ** 2) * 14.0)
        tex = 1.0
        if mutant:
            tex = 1.0 + 0.5 * np.sin(u * 1.3) * np.sin(v * 1.3)
        green += 0.7 * amp * (0.55 * body + 0.45 * ring) * tex

    frame = np.zeros((size, size, 3), np.float64)
    frame[..., 2] = seg
    frame[..., 1] = green
    frame[..., 0] = background
    frame += rng.normal(0, noise, frame.shape)
    return np.clip(frame, 0, 65535).astype(np.uint16)


def make_plate(rng: np.random.Generator, size: int = 4096, n_cells: int = 1280,
               mutant_fraction: float = 0.0, background: float = 80.0,
               noise: float = 10.0, cutoff: float = 6.0) -> np.ndarray:
    """`make_frame` for plates: the same draws from `rng` in the same order
    and the same arithmetic, but each cell is rendered only within
    `cutoff` of its normalized radii (the body there is below exp(-90) of
    its peak, the ring below exp(-393)), so the cost grows with the cells
    and not with cells x pixels.  Equal to `make_frame` from the same rng
    to within one count."""
    seg = np.full((size, size), background, np.float64)
    green = np.full((size, size), background, np.float64)
    for _ in range(n_cells):
        mutant = rng.uniform() < mutant_fraction
        cy, cx = rng.uniform(30, size - 30, 2)
        r = rng.uniform(9, 16) * (1.6 if mutant else 1.0)
        aspect = rng.uniform(1.0, 1.8)
        theta = rng.uniform(0, np.pi)
        amp = rng.uniform(900, 1500) * (1.8 if mutant else 1.0)

        half = int(np.ceil(cutoff * r * aspect))
        r0, r1 = max(int(cy) - half, 0), min(int(cy) + half + 2, size)
        c0, c1 = max(int(cx) - half, 0), min(int(cx) + half + 2, size)
        yy, xx = np.mgrid[r0:r1, c0:c1].astype(np.float64)
        dy, dx = yy - cy, xx - cx
        u = np.cos(theta) * dy + np.sin(theta) * dx
        v = -np.sin(theta) * dy + np.cos(theta) * dx
        d2 = (u / (r * aspect)) ** 2 + (v / r) ** 2
        body = np.exp(-d2 * 2.5)
        seg[r0:r1, c0:c1] += amp * body
        ring = np.exp(-((np.sqrt(d2) - 0.7) ** 2) * 14.0)
        tex = 1.0
        if mutant:
            tex = 1.0 + 0.5 * np.sin(u * 1.3) * np.sin(v * 1.3)
        green[r0:r1, c0:c1] += 0.7 * amp * (0.55 * body + 0.45 * ring) * tex

    frame = np.zeros((size, size, 3), np.float64)
    frame[..., 2] = seg
    frame[..., 1] = green
    frame[..., 0] = background
    frame += rng.normal(0, noise, frame.shape)
    return np.clip(frame, 0, 65535).astype(np.uint16)


def make_frame_instances(rng: np.random.Generator, size: int = 512, n_cells: int = 25,
                         mutant_fraction: float = 0.0, background: float = 80.0,
                         noise: float = 10.0, clustering: float = 0.0, fg_d2: float = 1.1,
                         cutoff: float = 3.0,
                         centers: list | None = None) -> tuple[np.ndarray, np.ndarray]:
    """One (size, size, 3) uint16 frame and its true instance labels
    (size, size) int32: a cell owns the pixels of its footprint
    ``d2 <= fg_d2`` where its normalized distance is the smallest.  A
    `clustering` fraction of cells is placed next to an earlier one.  Cells
    render into windows of `cutoff` normalized radii.  `centers`, if given,
    receives each cell's (centre row, centre column, short radius) in label
    order; the draws do not change."""
    seg = np.full((size, size), background, np.float64)
    green = np.full((size, size), background, np.float64)
    labels = np.zeros((size, size), np.int32)
    best_d2 = np.full((size, size), np.inf, np.float64)
    placed: list[tuple[float, float, float]] = []  # (cy, cx, r_eff)

    for idx in range(1, n_cells + 1):
        mutant = rng.uniform() < mutant_fraction
        r = rng.uniform(9, 16) * (1.6 if mutant else 1.0)
        aspect = rng.uniform(1.0, 1.8)
        theta = rng.uniform(0, np.pi)
        amp = rng.uniform(900, 1500) * (1.8 if mutant else 1.0)
        r_eff = r * (1 + aspect) / 2

        if placed and rng.uniform() < clustering:
            cy0, cx0, r0 = placed[int(rng.integers(len(placed)))]
            ang = rng.uniform(0, 2 * np.pi)
            d = rng.uniform(1.6, 2.6) * max(r_eff, r0)
            cy = float(np.clip(cy0 + d * np.sin(ang), 30, size - 30))
            cx = float(np.clip(cx0 + d * np.cos(ang), 30, size - 30))
        else:
            cy, cx = (float(v) for v in rng.uniform(30, size - 30, 2))
        placed.append((cy, cx, r_eff))
        if centers is not None:
            centers.append((cy, cx, r))

        w_half = int(np.ceil(cutoff * r * max(aspect, 1.0))) + 1
        y0, y1 = max(0, int(cy) - w_half), min(size, int(cy) + w_half + 1)
        x0, x1 = max(0, int(cx) - w_half), min(size, int(cx) + w_half + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)

        dy, dx = yy - cy, xx - cx
        u = np.cos(theta) * dy + np.sin(theta) * dx
        v = -np.sin(theta) * dy + np.cos(theta) * dx
        d2 = (u / (r * aspect)) ** 2 + (v / r) ** 2
        body = np.exp(-d2 * 2.5)
        seg[y0:y1, x0:x1] += amp * body
        ring = np.exp(-((np.sqrt(d2) - 0.7) ** 2) * 14.0)
        tex = 1.0
        if mutant:
            tex = 1.0 + 0.5 * np.sin(u * 1.3) * np.sin(v * 1.3)
        green[y0:y1, x0:x1] += 0.7 * amp * (0.55 * body + 0.45 * ring) * tex

        own = (d2 <= fg_d2) & (d2 < best_d2[y0:y1, x0:x1])
        labels[y0:y1, x0:x1][own] = idx
        bwin = best_d2[y0:y1, x0:x1]
        bwin[own] = d2[own]
        best_d2[y0:y1, x0:x1] = bwin

    frame = np.zeros((size, size, 3), np.float64)
    frame[..., 2] = seg
    frame[..., 1] = green
    frame[..., 0] = background
    frame += rng.normal(0, noise, frame.shape)
    return np.clip(frame, 0, 65535).astype(np.uint16), labels


def make_dataset(
    folder: str,
    n_frames: int = 4,
    size: int = 512,
    n_cells: int = 25,
    mutant_fraction: float = 0.0,
    seed: int = 0,
) -> list[str]:
    """Write n_frames TIFFs into `folder`; returns the file paths."""
    from cell_image_analysis_tpu_torch.io.tiff import imwrite

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_frames):
        frame = make_frame(rng, size=size, n_cells=n_cells, mutant_fraction=mutant_fraction)
        p = os.path.join(folder, f"frame_{i:03d}.tif")
        imwrite(p, frame)
        paths.append(p)
    return paths


def make_cells(rng: np.random.Generator, n: int, size: int = 64, mutant: bool = False) -> np.ndarray:
    """Pre-extracted normalized cell tensors in [0,1] (BASELINE.json config #1
    shape), bypassing segmentation."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(size * 0.35, size * 0.65, 2)
        r = rng.uniform(size * 0.15, size * 0.28) * (1.5 if mutant else 1.0)
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r)
        body = np.exp(-d2 * 2.0)
        ring = np.exp(-((np.sqrt(d2) - 0.8) ** 2) * 10.0)
        img = 0.6 * body + 0.4 * ring
        if mutant:
            img *= 1.0 + 0.4 * np.sin(yy * 0.9) * np.sin(xx * 0.9)
        img += rng.normal(0, 0.03, (size, size))
        out[i] = np.clip(img, 0, 1)
    return out
