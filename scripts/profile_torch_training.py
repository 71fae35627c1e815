#!/usr/bin/env python3
"""Time the port's CAE training step on one GPU and show where it goes.

    python3 scripts/profile_torch_training.py [--cells 2657] [--epochs 2]

Runs `train.trainer.fit_cae` on synthetic 64x64 cells (Gaussian blobs with
noise, made with numpy from a seed) at the default `TrainConfig` batch of
32, and prints the images/s of each variant: augmentation on and off, and
cuDNN's algorithm search (`torch.backends.cudnn.benchmark`) off and on.
Then one epoch under `torch.profiler`: the top operators by device time
and by host time, and the host-side synchronizations.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cells(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    cy, cx = rng.uniform(24, 40, (2, n, 1, 1)).astype(np.float32)
    s = rng.uniform(6, 12, (n, 1, 1)).astype(np.float32)
    img = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
    img += rng.normal(0, 0.03, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=2657)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cell_image_analysis_tpu_torch.config import AugmentConfig, TrainConfig
    from cell_image_analysis_tpu_torch.train.trainer import fit_cae

    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    X = torch.tensor(cells(args.cells), device="cuda")
    off = AugmentConfig(rotation_range=0, width_shift_range=0, height_shift_range=0,
                        zoom_range=0, horizontal_flip=False, vertical_flip=False)
    cfg = TrainConfig(epochs=args.epochs, val_split=0.0001)
    n_train = len(X) - int(np.ceil(0.0001 * len(X)))
    fit_cae(X[:256], train_cfg=TrainConfig(epochs=1), verbose=False)   # warm-up
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for name, aug in (("augment on", AugmentConfig()), ("augment off", off)):
            fit_cae(X[:256], train_cfg=TrainConfig(epochs=1), aug_cfg=aug, verbose=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit_cae(X, train_cfg=cfg, aug_cfg=aug, verbose=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            steps = args.epochs * (n_train // 32)
            print(f"cudnn.benchmark {bench}, {name}: {n_train * args.epochs / secs:.1f} images/s, "
                  f"{secs / steps * 1e3:.2f} ms a step ({steps} steps) [{smi}]", flush=True)
    torch.backends.cudnn.benchmark = False
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_cae(X, train_cfg=TrainConfig(epochs=1, val_split=0.0001), verbose=False)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    syncs = [e for e in ka if "Synchronize" in e.key or "Memcpy" in e.key or "item" in e.key]
    for e in syncs:
        print(f"host event {e.key}: {e.count} calls, {e.self_cpu_time_total / 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
