"""The benchmark's frame generator: synthetic fluorescence frames from a seed.

A frozen copy of the frame arithmetic of the port's
`utils/synthetic.make_frame_instances` (elliptical Gaussian cells with a
ring texture; channel 2 is the segmentation marker, channel 1 the green
analysis channel, channel 0 the background), so that a change to the
port's generator cannot move the yardstick.  It draws from `rng` in the
same order and returns the same bytes (a test holds them equal); the
instance labels, which the benchmark does not use, are not computed.

Frame i of a pool comes from `np.random.default_rng([pool_seed, 0, i])`,
so the frames are independent of one another and are made in a few
worker processes.  The pool is the traffic mix's (`pool_seed`), the same
frames for every run; a run's seed draws the batches from it, so that
every seed screens the same set of frames in another order and another
grouping.  numpy only: the workers import nothing else.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def make_frame(rng: np.random.Generator, size: int, n_cells: int,
               mutant_fraction: float = 0.0, background: float = 80.0, noise: float = 10.0,
               clustering: float = 0.0, cutoff: float = 3.0) -> np.ndarray:
    """One (size, size, 3) uint16 frame of `n_cells` cells."""
    seg = np.full((size, size), background, np.float64)
    green = np.full((size, size), background, np.float64)
    placed: list = []   # (cy, cx, r_eff)
    for _ in range(n_cells):
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

    frame = np.zeros((size, size, 3), np.float64)
    frame[..., 2] = seg
    frame[..., 1] = green
    frame[..., 0] = background
    frame += rng.normal(0, noise, frame.shape)
    return np.clip(frame, 0, 65535).astype(np.uint16)


def frame_rng(seed: int, i: int) -> np.random.Generator:
    """The generator of frame i of the pool of `seed` (any whole number)."""
    return np.random.default_rng([seed % 2 ** 64, 0, i])


def pool_frame(seed: int, i: int, traffic: dict) -> np.ndarray:
    """Frame i of the pool of `seed` under the traffic mix `traffic`."""
    return make_frame(frame_rng(seed, i), traffic["size"], traffic["cells_per_frame"],
                      mutant_fraction=traffic["mutant_fraction"],
                      background=traffic["background"], noise=traffic["noise"],
                      clustering=traffic["clustering"], cutoff=traffic["cutoff"])


def make_pool(traffic: dict, workers: int = 4) -> np.ndarray:
    """The traffic mix's (pool_frames, size, size, 3) uint16 pool, made in
    `workers` spawned processes (1: in this process), which have ended
    when it returns."""
    seed, n = traffic["pool_seed"], traffic["pool_frames"]
    if workers <= 1 or n == 1:
        return np.stack([pool_frame(seed, i, traffic) for i in range(n)])
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, n), mp_context=ctx) as ex:
        frames = list(ex.map(pool_frame, [seed] * n, range(n), [traffic] * n))
    return np.stack(frames)


def batch_draws(seed: int, traffic: dict):
    """An endless stream of batches: each is `frame_batch` distinct pool
    indices drawn from the seed, never the same set as the batch before."""
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    n, b = traffic["pool_frames"], traffic["frame_batch"]
    prev = None
    while True:
        idx = np.sort(rng.choice(n, size=b, replace=False))
        if prev is not None and np.array_equal(idx, prev) and n > b:
            continue
        prev = idx
        yield idx
