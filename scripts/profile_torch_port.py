#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time, on one GPU.

    python3 scripts/profile_torch_port.py [--backend stardist|threshold] [--frames 16]
                                          [--size 1024] [--trace PATH] [--src DIR]
                                          [--capacities bench|screener] [--pipeline N]

Screens the bench's synthetic frames (seed 7, 80 cells per 1024^2 frame)
through `score_frames_fused` at the bench's settings for the backend
(`--capacities screener`: at the capacities `ProductionMutantScreening`
uses by default, 1024 candidates, raster cap and cell capacity 512, label
capacity 1024) once to warm up, then:

1. times the stages of one batch with a host clock around synchronized
   calls (best of 3), the CLAHE -> resize -> scoring bucket loop being
   the remainder of the full run.  StarDist: percentile + U-Net forward,
   the rest of `predict_instances` (top-K, NMS, rasterize), stage A (run
   regionprops, QC, crops).  Threshold: `threshold_mask` (order
   statistics, opening), stage A on the mask (run table, hook CC, run
   moments, QC, crops); and, outside the total, stage A of the exact
   label route (CC kernel, pixel regionprops, QC, crops).  Then the
   bucket loop is split into its three parts: in three more full runs,
   every call that `score_frames_fused` makes to a CLAHE function, to
   `resize_cells` and to `score_cells` (the names its module imports) is
   wrapped in a synchronized host clock, and each part's sum is kept
   (best of 3), with the number of CLAHE calls;
2. traces one full run with `torch.profiler` and prints the device time
   by kernel, the summed device time against the wall time (the device's
   busy share), and with `--trace` writes the Chrome trace there;
3. with `--pipeline N`: screens N batches (the same frames N times) one
   at a time (`wait(start())` each) and with one batch in flight (start
   k+1, then wait k, as the screener does), in turns, best of 3 each, and
   the host's time inside the `start` and the `wait` calls.

`--frames-npy PATH` keeps the frames between runs.  `--src DIR` profiles
the `cell_image_analysis_tpu_torch` package of another checkout (an
earlier commit unpacked with `git archive`), so that two versions can be
timed in one run on one card; the frames and the segmentation settings
always come from this script's own checkout.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _own_module(name: str, relpath: str):
    """A self-contained module of this checkout, loaded by path (whatever
    package `--src` puts first on the import path)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod             # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def bucket_loop_split(torch, run, n: int = 3) -> dict:
    """The bucket loop's parts over n runs of `run()`: each CLAHE, resize
    and scoring call of `score_frames_fused` timed between two
    synchronizations, summed by part a run; the best run of each part
    (ms), and the CLAHE calls of a run."""
    from cell_image_analysis_tpu_torch.pipeline import scoring

    parts = {name: "CLAHE" for name in vars(scoring) if name.startswith("clahe")}
    parts.update(resize_cells="resize", score_cells="scoring")
    originals = {name: getattr(scoring, name) for name in parts}
    acc = {}

    def wrap(name):
        def timed_call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kw)
            torch.cuda.synchronize()
            part = parts[name]
            acc[part] = acc.get(part, 0.0) + (time.perf_counter() - t0) * 1e3
            acc[part + " calls"] = acc.get(part + " calls", 0) + 1
            return out
        return timed_call

    best = {}
    try:
        for name in parts:
            setattr(scoring, name, wrap(name))
        for _ in range(n):
            acc.clear()
            run()
            best = {k: min(v, best.get(k, v)) for k, v in acc.items()}
    finally:
        for name, fn in originals.items():
            setattr(scoring, name, fn)
    return {"CLAHE": best["CLAHE"], "resize": best["resize"], "scoring": best["scoring"],
            "launches of CLAHE": best["CLAHE calls"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("stardist", "threshold"), default="stardist")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--cells", type=int, default=80)
    ap.add_argument("--trace", help="write the torch.profiler Chrome trace to this path")
    ap.add_argument("--frames-npy", help="reuse the frames saved at this path (made and saved "
                                         "there when it does not exist)")
    ap.add_argument("--capacities", choices=("bench", "screener"), default="bench")
    ap.add_argument("--pipeline", type=int, default=0, metavar="N",
                    help="also time N batches one at a time and with one in flight")
    ap.add_argument("--src", default=REPO,
                    help="checkout whose cell_image_analysis_tpu_torch is profiled")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    SegConfig = _own_module("_port_config", "cell_image_analysis_tpu_torch/config.py").SegConfig
    make_frame = _own_module("_port_synthetic",
                             "cell_image_analysis_tpu_torch/utils/synthetic.py").make_frame
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import (
        StarDistBackend,
        ThresholdBackend,
        threshold_mask,
        threshold_segment,
    )
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.ops.extract import (
        extract_candidates,
        extract_candidates_from_labels_runs,
        extract_candidates_from_mask,
    )
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    import cell_image_analysis_tpu_torch as pkg

    print(f"package: {os.path.dirname(pkg.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    if args.frames_npy and os.path.exists(args.frames_npy):
        frames = np.load(args.frames_npy)
    else:
        rng = np.random.default_rng(7)
        frames = np.stack([make_frame(rng, size=args.size, n_cells=args.cells)
                           for _ in range(args.frames)])
        if args.frames_npy:
            np.save(args.frames_npy, frames)
    segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(frames[..., 1].astype(np.float32), device=dev)
    model, params = load_scoring_params(device=dev)
    screener = args.capacities == "screener"   # pipeline/screening.py's defaults
    if args.backend == "stardist":
        cfg = (SegConfig(raster_cap=512) if screener
               else SegConfig(max_candidates=256, raster_patch=96, raster_cap=128))
        stage_a = (dict(label_capacity=1024, cell_capacity=512, rcap=32) if screener
                   else dict(label_capacity=128, cell_capacity=128, rcap=32))
        backend = StarDistBackend(load_unet_variables(), cfg, device=dev)
    else:   # utils/bench.py:250-253
        stage_a = (dict(label_capacity=1024, cell_capacity=512, rcap=32) if screener
                   else dict(label_capacity=4096, cell_capacity=128, rcap=32))
        backend = ThresholdBackend()

    fallback_runs = []

    class Twin:
        """The exact twin, counting the batches that fall back to it."""

        def __init__(self, fn):
            self.fn = fn
            for flag in ("returns_mask", "returns_overflow", "runs_props"):
                if hasattr(fn, flag):
                    setattr(self, flag, getattr(fn, flag))

        def __call__(self, x):
            fallback_runs.append(1)
            return self.fn(x)

    twin = Twin(backend.exact_twin())

    def full():
        return score_frames_fused(model, params, segs, greens, backend, chunk=32,
                                  caps=(64, 96), fallback_segment_fn=twin,
                                  **stage_a, **({} if args.backend == "stardist"
                                                else {"fg_fraction": 0.12}))

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
        if args.backend == "stardist":
            (_, t_unet) = timed(lambda: backend.model(normalize_percentile(segs)[..., None]))
            (labels, _), t_seg = timed(lambda: predict_instances(segs, backend.model, cfg))
            _, t_a = timed(lambda: extract_candidates_from_labels_runs(labels, greens, **stage_a))
            stages = [("percentile + U-Net", t_unet), ("top-K + NMS + raster", t_seg - t_unet),
                      ("stage A", t_a)]
        else:
            mask, t_seg = timed(lambda: threshold_mask(segs))
            _, t_a = timed(lambda: extract_candidates_from_mask(mask, greens, **stage_a))
            stages = [("threshold mask", t_seg), ("stage A (mask route)", t_a)]
            labels, t_lab = timed(lambda: threshold_segment(segs))
            label_kw = dict(stage_a, fg_fraction=0.12)
            label_kw.pop("rcap")
            _, t_la = timed(lambda: extract_candidates(labels, greens, **label_kw))
    fallback_runs.clear()
    (scores, stats), t_full = timed(full)
    n_fallback = len(fallback_runs) // 3
    split = bucket_loop_split(torch, full)
    n = len(stats["area"])
    print(f"{args.backend}, {args.capacities} capacities: batch of {args.frames} x "
          f"{args.size}^2, {n} cells (best of 3, ms):")
    stages += [("CLAHE/resize/score loop + host", t_full - t_seg - t_a), ("total", t_full)]
    for name, t in stages:
        print(f"  {name:32s} {t:9.2f}  ({100 * t / t_full:5.1f}%)")
    print(f"  cells/s {n / t_full * 1e3:.1f}")
    print(f"  runs through the exact twin in a full run (an overflow flag fired): {n_fallback}"
          + ("; the loop's remainder and the total include that second run" if n_fallback
             else ""))
    print(f"  bucket loop by part, each call synchronized "
          f"({split.pop('launches of CLAHE')} CLAHE launches):")
    for name, t in split.items():
        print(f"    {name:30s} {t:9.2f}")
    if args.backend == "threshold":
        print(f"  exact label route, outside the total: threshold_segment {t_lab:.2f} ms "
              f"(threshold mask + CC kernel + compaction), stage A {t_la:.2f} ms "
              "(pixel regionprops, QC, crops)")

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
    if args.pipeline:
        pipeline_times(torch, args.pipeline, n, lambda: dict(
            model=model, params=params, segs=segs, greens=greens, segment_fn=backend, chunk=32,
            caps=(64, 96), fallback_segment_fn=twin, **stage_a,
            **({} if args.backend == "stardist" else {"fg_fraction": 0.12})))
    return 0


def pipeline_times(torch, n_batches: int, n_cells: int, kwargs) -> None:
    """N batches one at a time and with one in flight, in turns (best of 3
    each), with the host's time inside the start and the wait calls."""
    from cell_image_analysis_tpu_torch.pipeline.scoring import (
        score_frames_fused_start,
        score_frames_fused_wait,
    )

    def run(in_flight: bool) -> tuple:
        host = {"start": 0.0, "wait": 0.0}

        def call(name, fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[name] += (time.perf_counter() - t0) * 1e3
            return out

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = []
        for _ in range(n_batches):
            pending.append(call("start", score_frames_fused_start, **kwargs()))
            while len(pending) > (1 if in_flight else 0):
                call("wait", score_frames_fused_wait, pending.pop(0))
        while pending:
            call("wait", score_frames_fused_wait, pending.pop(0))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, host

    best = {}
    for in_flight in (False, True, True, False, False, True):
        t, host = run(in_flight)
        if in_flight not in best or t < best[in_flight][0]:
            best[in_flight] = (t, host)
    for in_flight, name in ((False, "one at a time"), (True, "one in flight")):
        t, host = best[in_flight]
        print(f"{n_batches} batches, {name}: {t:.2f} ms ({n_batches * n_cells / t * 1e3:.1f} "
              f"cells/s); host inside start {host['start']:.2f} ms, inside wait "
              f"{host['wait']:.2f} ms")
    a, b = best[False][0], best[True][0]
    print(f"one in flight takes {100 * (a - b) / a:.1f}% less wall time than one at a time")


if __name__ == "__main__":
    sys.exit(main())
