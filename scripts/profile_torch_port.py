#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time, on one GPU.

    python3 scripts/profile_torch_port.py [--frames 16] [--size 1024] [--trace PATH]

Screens the bench's synthetic frames (seed 7, 80 cells per 1024^2 frame)
through `score_frames_fused` once to warm up, then:

1. times the stages of one batch with a host clock around synchronized
   calls: percentile + U-Net forward, the rest of `predict_instances`
   (top-K, NMS, rasterize), stage A (run regionprops, QC, crops), and the
   CLAHE -> resize -> scoring bucket loop (the remainder of the full run);
2. traces one full run with `torch.profiler` and prints the device time
   by kernel, the summed device time against the wall time (the device's
   busy share), and with `--trace` writes the Chrome trace there.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--cells", type=int, default=80)
    ap.add_argument("--trace", help="write the torch.profiler Chrome trace to this path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    from cell_image_analysis_tpu.config import SegConfig
    from cell_image_analysis_tpu.utils.synthetic import make_frame
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.ops.extract import extract_candidates_from_labels_runs
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    frames = np.stack([make_frame(rng, size=args.size, n_cells=args.cells)
                       for _ in range(args.frames)])
    segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(frames[..., 1].astype(np.float32), device=dev)
    cfg = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
    stage_a = dict(label_capacity=128, cell_capacity=128, rcap=32)
    backend = StarDistBackend(load_unet_variables(), cfg, device=dev)
    model, params = load_scoring_params(device=dev)

    def full():
        return score_frames_fused(model, params, segs, greens, backend, chunk=32,
                                  caps=(64, 96), **stage_a)

    def timed(fn, n=3):
        out, best = None, float("inf")
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3

    full()
    with torch.inference_mode():
        (_, t_unet) = timed(lambda: backend.model(normalize_percentile(segs)[..., None]))
        (labels, _), t_seg = timed(lambda: predict_instances(segs, backend.model, cfg))
        _, t_a = timed(lambda: extract_candidates_from_labels_runs(labels, greens, **stage_a))
    (scores, stats), t_full = timed(full)
    n = len(stats["area"])
    print(f"batch of {args.frames} x {args.size}^2, {n} cells (best of 3, ms):")
    for name, t in (("percentile + U-Net", t_unet), ("top-K + NMS + raster", t_seg - t_unet),
                    ("stage A", t_a), ("CLAHE/resize/score loop + host",
                                       t_full - t_seg - t_a), ("total", t_full)):
        print(f"  {name:32s} {t:9.2f}  ({100 * t / t_full:5.1f}%)")
    print(f"  cells/s {n / t_full * 1e3:.1f}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled run: wall {wall:.2f} ms, device kernel time {dev_ms:.2f} ms "
          f"(busy {100 * dev_ms / wall:.1f}%, idle {100 - 100 * dev_ms / wall:.1f}%)")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25,
                                    max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
