#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time, on one GPU.

    python3 scripts/profile_torch_port.py [--backend stardist|threshold] [--frames 16]
                                          [--size 1024] [--trace PATH] [--src DIR]
                                          [--capacities bench|screener|plate] [--pipeline N]
                                          [--span-batches 4] [--bench R]

Screens the bench's synthetic frames (seed 7, 80 cells per 1024^2 frame)
through `score_frames_fused` at the bench's settings for the backend
(`--capacities screener`: at the capacities `ProductionMutantScreening`
uses by default, 1024 candidates, raster cap and cell capacity 512, label
capacity 1024; `--capacities plate`, StarDist: the plate rows' settings,
`utils/bench.plate_settings(--size)`, on `make_frame_instances` frames,
e.g. `--frames 2 --size 4096 --cells 1280`, a batch of the 4096^2 row)
once to warm up, then:

1. times the stages of one batch with a host clock around synchronized
   calls (best of 3), the CLAHE -> resize -> scoring bucket loop being
   the remainder of the full run.  StarDist: percentile + U-Net forward,
   the rest of `predict_instances` (top-K, NMS, rasterize), stage A (run
   regionprops, QC, crops).  Threshold: `threshold_segment` (order
   statistics, opening, the CC kernel), stage A (run regionprops, QC,
   crops); and, outside the total, stage A of the exact twin (pixel
   regionprops, QC, crops);
2. traces `--span-batches` batches with `torch.profiler`, each started
   before the one before it is waited on (the screener's loop), and
   prints the device time by kernel, the summed device time against the
   wall time (the device's busy share), and the port's spans
   (`utils.profiler`) a batch: calls, host ms, self ms (less the child
   spans) and device ms (the kernels and copies launched inside the span
   and no child of it, matched to their launch call by the profiler's
   correlation ids), with the counters beside; with `--trace` it writes
   the Chrome trace there;
3. with `--pipeline N`: screens N batches (the same frames N times) one
   at a time (`wait(start())` each) and with one batch in flight (start
   k+1, then wait k, as the screener does), in turns, best of 3 each, and
   the host's time inside the `start` and the `wait` calls.

`--bench R`, in place of all that: R runs of the screening bench
(`utils/bench.run_bench`: batches of 16, all started before the first
wait, two warm-ups, best of 2) for each backend on the frames
(`--frames 48` is the bench's own workload), each line with its cells,
seconds, fallbacks and peak memory.

`--frames-npy PATH` keeps the frames between runs.  `--src DIR` profiles
(or benches) the `cell_image_analysis_tpu_torch` package of another
checkout (an earlier commit unpacked with `git archive`), so that two
versions can be timed in one run on one card; the frames and the
segmentation settings always come from this script's own checkout.  To
compare two commits, run parent, change, change, parent in fresh
processes on the same `--frames-npy`.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import bisect
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


def device_ms_by_span(events, names) -> dict:
    """{span name: device ms} of a profiler session's `events()`: each
    kernel, copy or fill on the device goes to the innermost span of
    `names` open when the host called the CUDA runtime to launch it (the
    call and the device's activity share the profiler's correlation id);
    those launched outside every span to "(outside the spans)"."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type.name == "CPU" and e.name in names)
    starts = [sp[0] for sp in spans]
    # the CUDA API calls (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
    launched = {e.id: e.time_range.start for e in events
                if e.device_type.name == "CPU" and e.name.startswith("cu")}
    out: dict = {}
    for e in events:
        if e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue
        t, owner = launched.get(e.id), "(outside the spans)"
        if t is None:
            owner = "(no launch call seen)"
        else:
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if spans[i][1] >= t:      # nested: the latest start that holds t
                    owner = spans[i][2]
                    break
        out[owner] = out.get(owner, 0.0) + (e.time_range.end - e.time_range.start) * 1e-3
    return out


def print_span_table(prof, summary: dict) -> None:
    """The spans a batch (host, self and device ms) and the counters."""
    n = max(summary["batches"], 1)
    dev = device_ms_by_span(prof.events(), set(summary["spans"]))
    print(f"spans a batch ({summary['batches']} batches; ms):")
    print(f"  {'span':28s} {'calls':>7s} {'host':>9s} {'self':>9s} {'device':>9s}")
    rows = sorted(summary["spans"].items(), key=lambda kv: -kv[1]["host_ms"])
    for name, sp in rows:
        print(f"  {name:28s} {sp['calls'] / n:7.2f} {sp['host_ms'] / n:9.2f} "
              f"{sp['self_ms'] / n:9.2f} {dev.get(name, 0.0) / n:9.2f}")
    for other in ("(outside the spans)", "(no launch call seen)"):
        if other in dev:
            print(f"  {other:28s} {'':7s} {'':9s} {'':9s} {dev[other] / n:9.2f}")
    print("counters a batch:")
    for name, c in sorted(summary["counters"].items()):
        print(f"  {name:28s} {c / n:9.2f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("stardist", "threshold"), default="stardist")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--cells", type=int, default=80)
    ap.add_argument("--trace", help="write the torch.profiler Chrome trace to this path")
    ap.add_argument("--frames-npy", help="reuse the frames saved at this path (made and saved "
                                         "there when it does not exist)")
    ap.add_argument("--capacities", choices=("bench", "screener", "plate"), default="bench")
    ap.add_argument("--pipeline", type=int, default=0, metavar="N",
                    help="also time N batches one at a time and with one in flight")
    ap.add_argument("--span-batches", type=int, default=4, metavar="B",
                    help="batches in the profiled run (the span table's)")
    ap.add_argument("--src", default=REPO,
                    help="checkout whose cell_image_analysis_tpu_torch is profiled")
    ap.add_argument("--bench", type=int, default=0, metavar="R",
                    help="instead of profiling, run the screening bench R times a backend")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    SegConfig = _own_module("_port_config", "cell_image_analysis_tpu_torch/config.py").SegConfig
    synthetic = _own_module("_port_synthetic", "cell_image_analysis_tpu_torch/utils/synthetic.py")
    plate = args.capacities == "plate"
    if plate and args.backend != "stardist":
        ap.error("--capacities plate is the StarDist plate rows'")
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import (
        StarDistBackend,
        ThresholdBackend,
        threshold_segment,
    )
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.ops.extract import (
        extract_candidates,
        extract_candidates_from_labels_runs,
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
        if plate:   # utils/bench._make_frames from 2048^2 up
            frames = np.stack([synthetic.make_frame_instances(rng, size=args.size,
                                                              n_cells=args.cells)[0]
                               for _ in range(args.frames)])
        else:
            frames = np.stack([synthetic.make_frame(rng, size=args.size, n_cells=args.cells)
                               for _ in range(args.frames)])
        if args.frames_npy:
            np.save(args.frames_npy, frames)
    if args.bench:
        from cell_image_analysis_tpu_torch.utils import bench

        for _ in range(args.bench):
            for backend in ("stardist", "threshold"):
                report = {}
                line = bench.run_bench(n_frames=len(frames), size=args.size, n_cells=args.cells,
                                       backend=backend, device=dev, frames=frames, report=report)
                print(f"bench {backend}: {line}; {report['cells']} cells in "
                      f"{report['seconds']:.4f} s, fell back {report['fallback_batches']} of "
                      f"{report['batches_run']}, peak {report['peak_gib']:.3f} GiB", flush=True)
        return 0
    segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(frames[..., 1].astype(np.float32), device=dev)
    model, params = load_scoring_params(device=dev)
    screener = args.capacities == "screener"   # pipeline/screening.py's defaults
    if plate:
        own_bench = _own_module("_port_bench", "cell_image_analysis_tpu_torch/utils/bench.py")
        seg, kw = own_bench.plate_settings(args.size)
        cfg = SegConfig(**seg)
        stage_a = {k: kw[k] for k in ("label_capacity", "cell_capacity", "rcap")}
        backend = StarDistBackend(load_unet_variables(), cfg, device=dev)
    elif args.backend == "stardist":
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
            for flag in ("returns_overflow", "runs_props"):
                if hasattr(fn, flag):
                    setattr(self, flag, getattr(fn, flag))

        def __call__(self, x):
            fallback_runs.append(1)
            return self.fn(x)

    twin = Twin(backend.exact_twin())

    fused_kw = dict(chunk=32, caps=(64, 96), fallback_segment_fn=twin, **stage_a,
                    **({} if args.backend == "stardist" else {"fg_fraction": 0.12}))

    def full():
        return score_frames_fused(model, params, segs, greens, backend, **fused_kw)

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
            stages = [("percentile + U-Net", t_unet), ("top-K + NMS + raster", t_seg - t_unet)]
        else:
            labels, t_seg = timed(lambda: threshold_segment(segs))
            stages = [("threshold mask + CC", t_seg)]
            label_kw = dict(stage_a, fg_fraction=0.12)
            label_kw.pop("rcap")
            _, t_la = timed(lambda: extract_candidates(labels, greens, **label_kw))
        _, t_a = timed(lambda: extract_candidates_from_labels_runs(labels, greens, **stage_a))
        stages.append(("stage A", t_a))
    fallback_runs.clear()
    (scores, stats), t_full = timed(full)
    n_fallback = len(fallback_runs) // 3
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
    if args.backend == "threshold":
        print(f"  exact twin's stage A, outside the total: {t_la:.2f} ms "
              "(pixel regionprops, QC, crops)")

    from torch.profiler import ProfilerActivity, profile

    from cell_image_analysis_tpu_torch.pipeline.scoring import (
        score_frames_fused_start,
        score_frames_fused_wait,
    )
    try:
        from cell_image_analysis_tpu_torch.utils import profiler
        profiler.summary
    except AttributeError:      # a checkout (--src) whose package has no spans
        profiler = None

    def start():
        return score_frames_fused_start(model, params, segs, greens, backend, **fused_kw)

    if profiler is not None:
        profiler.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = start()
        for _ in range(args.span_batches - 1):
            nxt = start()
            score_frames_fused_wait(pending)
            pending = nxt
        score_frames_fused_wait(pending)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # a span's range is an annotation on both timelines, not work: the
    # kernel table and the device total leave them out
    averages = prof.key_averages()
    ops = type(averages)([e for e in averages if not getattr(e, "is_user_annotation", False)],
                         use_device="cuda")
    dev_ms = sum(e.self_device_time_total for e in ops if e.device_type.name == "CUDA") / 1e3
    print(f"profiled run of {args.span_batches} batches: wall {wall:.2f} ms, device kernel "
          f"time {dev_ms:.2f} ms (busy {100 * dev_ms / wall:.1f}%, "
          f"idle {100 - 100 * dev_ms / wall:.1f}%)")
    print(ops.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    if profiler is None:
        print("the profiled package records no spans")
    else:
        print_span_table(prof, profiler.summary())
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    if args.pipeline:
        pipeline_times(torch, args.pipeline, n, lambda: dict(
            model=model, params=params, segs=segs, greens=greens, segment_fn=backend,
            **fused_kw))
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
