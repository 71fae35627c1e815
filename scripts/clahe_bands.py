#!/usr/bin/env python3
"""Blocks a cell of the fused CLAHE kernel, timed on one GPU.

    python3 scripts/clahe_bands.py [--frames-npy PATH]

`ops/cuda/clahe_kernel.default_bands` launches a cluster of 4 blocks a
cell while a bucket has fewer cells than the card has SMs, else 2.  This
script holds that choice against 1, 2 and 4 blocks a cell, calling the
kernel's C entry beneath the wrapper: on the bench's StarDist main path
(16 frames of 1024^2, seed 7, 80 cells each; its cap-64 bucket) at
bucket sizes from 32 cells to all of them, on both sides of the switch,
and on every bucket of the threshold path.  Each launch is
checked bit-equal to `clahe_cells_plain`; the time is torch.profiler's
device time over 20 launches (`chip_smoke.device_ms`).  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = (1, 2, 4)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames-npy", help="reuse the frames saved at this path (made and saved "
                                         "there when it does not exist)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import torch

    if not torch.cuda.is_available():
        print("clahe_bands: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import THRESH_KW, device_ms, smi_line
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend, ThresholdBackend
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells_plain, size_buckets
    from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr
    from cell_image_analysis_tpu_torch.ops.cuda.clahe_kernel import default_bands
    from cell_image_analysis_tpu_torch.ops.extract import stage_a
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    print(smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.frames_npy and os.path.exists(args.frames_npy):
        frames = np.load(args.frames_npy)
    else:
        rng = np.random.default_rng(7)
        frames = np.stack([make_frame(rng, size=1024, n_cells=80) for _ in range(16)])
        if args.frames_npy:
            np.save(args.frames_npy, frames)
    segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(frames[..., 1].astype(np.float32), device=dev)

    def buckets(segment_fn, kw):
        with torch.inference_mode():
            cand, _, _ = stage_a(segment_fn, segs, greens, kw)
        B, ccap, full_cap = cand.crops.shape[:3]
        crops = cand.crops.reshape(B * ccap, full_cap, full_cap).float().contiguous()
        hs, ws = cand.heights.reshape(-1).int(), cand.widths.reshape(-1).int()
        return crops, hs, ws, size_buckets(hs, ws, cand.valid.reshape(-1), (64, 96), full_cap)

    def launch(crops, ids, hs, ws, cap, ns_cap, bands):
        out = torch.empty((ids.numel(), cap, cap), dtype=torch.float32, device=dev)
        check(library().cia_clahe_cells(
            crops.data_ptr(), crops.shape[1], crops.shape[0], ids.data_ptr(), ids.numel(),
            hs.data_ptr(), ws.data_ptr(), cap, ns_cap, 0.02, 8, bands, out.data_ptr(),
            stream_ptr(dev)), "clahe_cells")
        return out

    def sweep(what, crops, ids, hs, ws, cap, ns_cap):
        ids = ids.int().contiguous()
        idx = ids.long()
        ref = clahe_cells_plain(crops[idx][:, :cap, :cap], hs[idx], ws[idx], ns_cap=ns_cap)
        ms = {}
        for bands in BANDS:
            if not torch.equal(launch(crops, ids, hs, ws, cap, ns_cap, bands), ref):
                raise AssertionError(f"{what}: {bands} blocks a cell differ from the plain version")
            ms[bands] = device_ms(lambda: launch(crops, ids, hs, ws, cap, ns_cap, bands),
                                  ("clahe_cells_kernel",))
        fastest = min(ms, key=ms.get)
        chosen = default_bands(ids.numel(), dev)
        print(f"{what}: {ids.numel()} cells cap {cap} ns_cap {ns_cap}: device ms "
              + " / ".join(f"{ms[b]:.4f}" for b in BANDS) + " at 1/2/4 blocks a cell; "
              f"fastest {fastest}, the wrapper launches {chosen} "
              f"({100 * ms[chosen] / ms[fastest] - 100:+.1f}%)", flush=True)

    cfg = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
    crops, hs, ws, bk = buckets(StarDistBackend(load_unet_variables(), cfg, device=dev),
                                dict(label_capacity=128, cell_capacity=128, rcap=32))
    ids, cap, ns_cap = max(bk, key=lambda b: b[0].numel())
    n = ids.numel()
    print(f"SMs: {sms}; StarDist main path: buckets "
          f"{[(int(b[0].numel()), b[1]) for b in bk]}", flush=True)
    for c in sorted({32, sms // 2, sms - 1, sms, 2 * sms, 4 * sms, n}):
        if c <= n:
            sweep("StarDist main path", crops, ids[:c], hs, ws, cap, ns_cap)
    del crops

    kw = {k: v for k, v in THRESH_KW.items() if k not in ("chunk", "caps")}
    crops, hs, ws, bk = buckets(ThresholdBackend(), dict(kw, rcap=32))
    for ids, cap, ns_cap in bk:
        if ids.numel():
            sweep("threshold path", crops, ids, hs, ws, cap, ns_cap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
