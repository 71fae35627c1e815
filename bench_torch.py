#!/usr/bin/env python
"""Benchmark of the PyTorch port: prints one JSON line.

    python bench_torch.py [--backend stardist|threshold] [--mode screen|train] [--device cpu]

The port's counterpart of `bench.py`, through
`cell_image_analysis_tpu_torch.utils.bench`:

- `--mode screen` (default): screening throughput, cells/s per GPU, on 48
  synthetic 1024^2 frames (seed 7, 80 cells) in 3 pipelined batches of 16,
  best of 2 timed runs after two warm-ups; `--backend stardist` (default:
  U-Net, star-polygon NMS, rasterize) reports
  `screening_cells_per_sec_per_chip_stardist` against
  CPU_BASELINE_STARDIST.json, `--backend threshold`
  `screening_cells_per_sec_per_chip` against CPU_BASELINE.json;
- `--mode train`: `cae_train_cells_per_sec_per_chip`, `fit_cae` on 2,048
  synthetic cells for 12 epochs after a one-epoch warm-up, against
  CPU_BASELINE_TRAIN.json.

`vs_baseline` compares with the reference's stack run in one CPU process
on another machine (the committed CPU_BASELINE*.json), not with any
accelerator; stderr says so, with the device.  It runs on the GPU, and
exits 2 without one unless `--device cpu` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=["threshold", "stardist"], default="stardist")
    ap.add_argument("--mode", choices=["screen", "train"], default="screen")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from cell_image_analysis_tpu_torch.io.artifacts import resolve_device
    from cell_image_analysis_tpu_torch.utils.bench import (
        BASELINE_NOTE,
        run_bench,
        run_train_bench,
    )

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.exit(2, f"{ap.prog}: error: {e} (--device cpu)\n")
    if args.mode == "train":
        print(run_train_bench(device=device))
    else:
        print(run_bench(backend=args.backend, device=device))
    print(f"device: {device}; {BASELINE_NOTE}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
