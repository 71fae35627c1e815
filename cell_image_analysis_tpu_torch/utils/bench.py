"""Benchmark of the port: screening and CAE-training throughput, cells/s per GPU.

Counterpart of `cell_image_analysis_tpu/utils/bench.py`, with its workload,
protocol and metric names:

- `run_bench`: 48 synthetic 1024^2 frames (`_make_frames`, seed 7, 80
  cells), 3 batches of 16 through `score_frames_fused_start` / `_wait`
  with every batch started before the first is waited on, two warm-up
  runs of the first batch (which also build the kernels), best of 2 timed
  runs; one JSON line `screening_cells_per_sec_per_chip_stardist` or
  `screening_cells_per_sec_per_chip` (threshold);
- `run_train_bench`: `train/trainer.fit_cae` on 2,048 `make_cells` cells,
  12 epochs after a one-epoch warm-up; one JSON line
  `cae_train_cells_per_sec_per_chip`.  The split is `TrainConfig`'s
  (`val_split`, `seed`), which is what `fit_cae` trains on; JAX's bench
  counts a hard-coded 80/20 split of seed 42 instead.

The backends run at the JAX bench's settings (its `utils/bench.py:130-184,
222-253`): StarDist at K = 256 candidates, raster patch 96, raster cap 128
(the label capacity), NMS pair budget 8192, cell capacity 128, rcap 32;
the threshold backend at label capacity 4096, cell capacity 128,
fg_fraction 0.12; both at chunk 32, caps (64, 96), with the backend's
exact twin (`exact_twin()`) as the overflow fallback.  Above 1024^2 the
StarDist capacities scale with the frame (`plate_settings`, the rule of
the screener); the plate-scale rows, JAX's `scripts/bench_2048.py`
and `scripts/bench_4096.py`, are `scripts/bench_2048_torch.py` and
`scripts/bench_4096_torch.py`: `run_bench(frame_batch=2)` at 2048^2 and
4096^2.  `fused=False` is JAX's host-chunked route (`score_frames` at
chunk 256, one batch at a time).  The JAX bench's `CIA_BENCH_*`
environment knobs and TPU settings have no counterpart: the settings
follow from the backend and the frame size.

`vs_baseline` divides by the committed `CPU_BASELINE*.json`: the
reference's stack (numpy/scipy/sklearn oracles, Keras/TF for the U-Net and
the CAE training) in one CPU process on another machine, measured by the
JAX package's `run_cpu_reference` / `run_cpu_train_reference`, which the
port does not carry (the card's machine has no TensorFlow).  It is not a
number of any accelerator.

Every entry runs on the card unless the caller passes `device="cpu"`, and
raises without a GPU.  `_fit_params` and `stardist_backend` also serve the
parity harness (`utils/parity.measure_parity`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from cell_image_analysis_tpu_torch.io.artifacts import resolve_device

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BASELINE_PATH = os.path.join(_REPO_ROOT, "CPU_BASELINE.json")
_BASELINE_STARDIST_PATH = os.path.join(_REPO_ROOT, "CPU_BASELINE_STARDIST.json")
_BASELINE_TRAIN_PATH = os.path.join(_REPO_ROOT, "CPU_BASELINE_TRAIN.json")
BASELINE_NOTE = ("vs_baseline: against CPU_BASELINE*.json, the reference's stack in one CPU "
                 "process on another machine; not a number of any accelerator")

FRAME_BATCH = 16
# the StarDist backend's settings (JAX utils/bench.py:130-184, 222-241) and
# the fused call's settings of each backend (JAX utils/bench.py:207-253);
# the raster cap is StarDist's label capacity
STARDIST_SEG = dict(max_candidates=256, raster_patch=96, raster_cap=128, nms_max_pairs=8192)
_COMMON_KW = dict(chunk=32, caps=(64, 96))
STARDIST_KW = dict(label_capacity=STARDIST_SEG["raster_cap"], cell_capacity=128, rcap=32,
                   **_COMMON_KW)
THRESHOLD_KW = dict(label_capacity=4096, cell_capacity=128, fg_fraction=0.12, **_COMMON_KW)


def plate_settings(size: int) -> tuple:
    """(seg, kw): the StarDist backend's `SegConfig` fields and the fused
    call's settings for frames of size^2, by the screener's rule
    (`config.capacity_scale`, `scaled_seg_config`, `row_scale`) applied to
    the 1024^2 tuning `STARDIST_SEG` / `STARDIST_KW`: with s the frame-area
    multiple, K, the raster cap (StarDist's label capacity), the NMS pair
    budget and the cell capacity times s; rcap times the row-width
    multiple.  Up to 1024^2 the tuning itself.  At 4096^2: K 4096, raster
    cap 2048, pairs 131072, rcap 128 (JAX's `scripts/bench_4096.py:20-29`)
    and cell capacity 2048, where JAX sets 1024: the selection of the first
    `cell_capacity` geometry-passing labels (`ops/extract.py`) truncates
    without a flag, and a 4096^2 frame of 1,280 planted cells held 1,324
    cells, so the capacity is the rule's bound, not a tuning.  At 2048^2:
    K 1024, raster cap 512, pairs 32768, cell capacity 512, rcap 64 (JAX's
    `scripts/bench_2048.py` sets none and runs at K 256, which drops
    cells)."""
    from cell_image_analysis_tpu_torch.config import (
        SegConfig,
        capacity_scale,
        row_scale,
        scaled_seg_config,
    )

    s = capacity_scale(size, size)
    cfg = scaled_seg_config(SegConfig(**STARDIST_SEG), s)
    seg = {k: getattr(cfg, k) for k in STARDIST_SEG}
    kw = dict(STARDIST_KW, label_capacity=seg["raster_cap"],
              cell_capacity=STARDIST_KW["cell_capacity"] * s,
              rcap=STARDIST_KW["rcap"] * row_scale(size))
    return seg, kw


def _make_frames(n_frames: int, size: int, n_cells: int, seed: int = 7,
                 planted: list | None = None) -> list:
    """`n_frames` (size, size, 3) uint16 frames of one rng stream:
    `make_frame`, or `make_frame_instances` from 2048^2 up (cost linear in
    the cells, not cells x pixels); byte-identical to JAX's.  `planted`, if
    given (from 2048^2 up), receives each frame's (n_cells, 3) planted
    cells: centre row, centre column, short radius."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame, make_frame_instances

    rng = np.random.default_rng(seed)
    if size >= 2048:
        frames = []
        for _ in range(n_frames):
            centers = []
            frames.append(make_frame_instances(rng, size=size, n_cells=n_cells,
                                               centers=centers)[0])
            if planted is not None:
                planted.append(np.array(centers))
        return frames
    if planted is not None:
        raise ValueError("planted cells are recorded from 2048^2 up (make_frame_instances)")
    return [make_frame(rng, size=size, n_cells=n_cells) for _ in range(n_frames)]


def _host_estimators(arrays: dict) -> dict:
    """The fitted host estimators of the scoring npz's arrays."""
    from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector
    from cell_image_analysis_tpu_torch.models.pca import PCA
    from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
    from cell_image_analysis_tpu_torch.models.svm import OneClassSVM

    def svm(name, nu):
        return OneClassSVM(nu=nu, gamma_=float(arrays[f"svm_{name}/gamma"]),
                           support_vectors_=arrays[f"svm_{name}/support_vectors"],
                           dual_coef_=arrays[f"svm_{name}/dual_coef"],
                           intercept_=-float(arrays[f"svm_{name}/rho"]))

    comps = arrays["pca_components"]
    return dict(
        scaler=RobustScaler(center_=arrays["scaler_center"], scale_=arrays["scaler_scale"]),
        pca=PCA(n_components=comps.shape[0], mean_=arrays["pca_mean"], components_=comps),
        cons=svm("conservative", 0.05), mod=svm("moderate", 0.10),
        ens=EnsembleDetector(mse_threshold=float(arrays["ensemble_mse_threshold"])),
        fft_scaler=RobustScaler(center_=arrays["fft_scaler_center"],
                                scale_=arrays["fft_scaler_scale"]),
        fft_det=svm("fft", 0.10))


def _fit_params(seed: int = 0, X: np.ndarray | None = None, device=None,
                cae_state: dict | None = None):
    """(CAE module, ScoringParams, host estimators) on `device` (default:
    the card).  Not part of the timed path.

    Without `X`: the committed `assets/scoring_synthetic.npz`, which is the
    JAX package's `_fit_params(seed=0)` (`scripts/make_torch_port_assets.py`),
    and the host estimators of the same arrays.  With `X` ((N, 64, 64, 1)
    float32 cells; the parity harness passes oracle-extracted ones): a CAE
    from `models/cae.init_cae` on a CPU `torch.Generator` seeded with
    `seed` (or the state dict `cae_state`), then, in JAX's order, the
    RobustScaler, PCA(64), the conservative (nu 0.05) and moderate (nu
    0.10) SVMs, the ensemble threshold and the FFT scaler and SVM (nu
    0.10).  `host` holds `model` and the fitted estimators under JAX's
    keys (`scaler`, `pca`, `cons`, `mod`, `ens`, `fft_scaler`, `fft_det`)."""
    from cell_image_analysis_tpu_torch.io.artifacts import (
        SCORING_PARAMS_PATH,
        build_scoring_params,
        scoring_params_from_numpy,
    )

    dev = resolve_device(device)
    if X is None:
        if seed != 0 or cae_state is not None:
            raise ValueError("_fit_params: the committed fit is seed 0's; pass X to fit anew")
        with np.load(SCORING_PARAMS_PATH) as z:
            arrays = {k: z[k] for k in z.files}
        model, params = scoring_params_from_numpy(arrays, device=dev)
        return model, params, dict(model=model, **_host_estimators(arrays))

    from cell_image_analysis_tpu_torch.models.cae import (
        CAE,
        encode,
        init_cae,
        reconstruction_errors,
    )
    from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector
    from cell_image_analysis_tpu_torch.models.pca import PCA
    from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
    from cell_image_analysis_tpu_torch.models.svm import OneClassSVM
    from cell_image_analysis_tpu_torch.ops.fft_features import fft_features

    if cae_state is None:
        model = init_cae(torch.Generator().manual_seed(seed))
    else:
        model = CAE()
        model.load_state_dict(cae_state)
    model = model.to(dev).eval()
    Xd = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    feats = encode(model, Xd)
    scaler = RobustScaler().fit(feats)
    pca = PCA(n_components=64).fit(scaler.transform(feats))
    reduced = pca.transform(scaler.transform(feats))
    cons = OneClassSVM(nu=0.05).fit(reduced)
    mod = OneClassSVM(nu=0.10).fit(reduced)
    ens = EnsembleDetector.fit(reconstruction_errors(model, Xd)[0].cpu().numpy())
    fft = fft_features(Xd)
    fft_scaler = RobustScaler().fit(fft)
    fft_det = OneClassSVM(nu=0.10).fit(fft_scaler.transform(fft))
    model, params = build_scoring_params(
        model, None, scaler, pca,
        {"Conservative": cons, "Moderate": mod, "FFT": fft_det, "FFT_scaler": fft_scaler},
        ens, device=dev)
    host = dict(model=model, scaler=scaler, pca=pca, cons=cons, mod=mod, ens=ens,
                fft_scaler=fft_scaler, fft_det=fft_det)
    return model, params, host


def stardist_backend(device=None, seg: dict | None = None):
    """The bench's `StarDistBackend` (`seg`, default `STARDIST_SEG`: tiled
    rasterizer, run-length stage A) over the committed U-Net
    (`assets/unet_synthetic.pkl`), on `device`."""
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend

    return StarDistBackend(load_unet_variables(), SegConfig(**(seg or STARDIST_SEG)),
                           device=device)


class _CountedCalls:
    """A segment_fn that counts its calls, with the wrapped one's flags: the
    bench's re-runs through the exact twin."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0
        for flag in ("returns_overflow", "runs_props"):
            if hasattr(fn, flag):
                setattr(self, flag, getattr(fn, flag))

    def __call__(self, segs):
        self.calls += 1
        return self.fn(segs)


def _batch_pipeline(model, params, backend: str = "threshold", device=None, fused: bool = True,
                    size: int = 1024):
    """(run, run_stream, fallback) for frames of size^2: `run(segs,
    greens)` screens one batch (`score_frames_fused`, or with `fused=False`
    JAX's host-chunked `score_frames` at chunk 256) and returns (cells,
    (scores, stats)); `run_stream(batches)` starts every batch with
    `score_frames_fused_start`, then waits on each in order (`_wait`
    fetches to the host), and returns (cells, device bytes the pending
    handles held once all were started or None on the CPU, each frame's
    geometry-passing labels (`frame_geometry`)); `fallback.calls` counts
    the batches that re-ran through the exact twin.  StarDist runs at
    `plate_settings(size)`, the threshold backend at `THRESHOLD_KW`."""
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import (
        frame_geometry,
        score_frames,
        score_frames_fused,
        score_frames_fused_start,
        score_frames_fused_wait,
    )

    if backend == "stardist":
        seg, kw = plate_settings(size)
        segment_fn = stardist_backend(device=device, seg=seg)
    elif backend == "threshold":
        kw = dict(THRESHOLD_KW)
        segment_fn = ThresholdBackend()
    else:
        raise ValueError(f"unknown backend {backend!r}")
    fallback = _CountedCalls(segment_fn.exact_twin())
    kw["fallback_segment_fn"] = fallback
    if not fused:   # JAX's host-chunked route (its utils/bench.py:200-212)
        kw.pop("caps", None)
        kw["chunk"] = 256
    screen = score_frames_fused if fused else score_frames

    def run(segs, greens):
        scores, stats = screen(model, params, segs, greens, segment_fn, **kw)
        return len(stats["area"]), (scores, stats)

    def run_stream(batches):
        dev = batches[0][0].device
        cuda = dev.type == "cuda"
        before = torch.cuda.memory_allocated(dev) if cuda else 0
        pendings = [score_frames_fused_start(model, params, s, g, segment_fn, **kw)
                    for s, g in batches]
        held = torch.cuda.memory_allocated(dev) - before if cuda else None
        total = 0
        for pend in pendings:
            _, stats = score_frames_fused_wait(pend)
            total += len(stats["area"])
        return total, held, np.concatenate([frame_geometry(p) for p in pendings])

    return run, run_stream, fallback


def run_device_bench(n_frames: int = 48, size: int = 1024, n_cells: int = 80,
                     backend: str = "threshold", device=None, frames=None,
                     frame_batch: int = FRAME_BATCH, fused: bool = True) -> dict:
    """Screening throughput on `device` (default: the card); the
    counterpart of JAX's `run_tpu_bench`.  `frames`: the (n_frames, size,
    size, 3) frames, if the caller made them already (else
    `_make_frames(n_frames, size, n_cells)`; making them is not timed).
    Batches of `frame_batch` frames (JAX's bench runs both backends at 16,
    its plate rows at 2); two warm-up runs of the first batch, then the
    best of 2 timed runs of every batch: `fused`, all started before the
    first is waited on; else JAX's host-chunked route, one batch at a
    time.  The capacities follow the frame size (`_batch_pipeline`).
    Returns cells, seconds, cells_per_sec, frames_per_sec, n_frames, size,
    frame_batch, fused, backend, the device's name, `fallback_batches` of
    `batches_run` (over warm-ups and timed runs), `geometry` (the best
    timed run's geometry-passing labels of each frame, which the cell
    capacity bounds; None when not pipelined), and on the card
    `pending_gib` (what the started handles held; None when not
    pipelined) and `peak_gib` (the timed runs' peak)."""
    dev = resolve_device(device)
    model, params, _ = _fit_params(device=dev)
    if frames is None:
        frames = _make_frames(n_frames, size, n_cells)
    stack = np.stack(frames[:n_frames])
    if stack.shape[:3] != (n_frames, size, size):
        raise ValueError(f"frames of shape {stack.shape[:3]}, expected {(n_frames, size, size)}")
    if frame_batch < 1:
        raise ValueError(f"frame_batch {frame_batch} < 1")
    segs = torch.tensor(stack[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(stack[..., 1].astype(np.float32), device=dev)
    del stack
    run, run_stream, fallback = _batch_pipeline(model, params, backend, dev, fused=fused,
                                                size=size)
    batches = [(segs[i:i + frame_batch], greens[i:i + frame_batch])
               for i in range(0, n_frames, frame_batch)]
    cuda = dev.type == "cuda"

    def one_at_a_time(batches):
        return sum(run(s, g)[0] for s, g in batches), None, None

    run(*batches[0])
    run(*batches[0])
    best = None
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        total, held, geometry = (run_stream if fused else one_at_a_time)(batches)
        dt = time.perf_counter() - t0
        if best is None or total / dt > best["cells_per_sec"]:
            best = dict(cells=total, seconds=dt, cells_per_sec=total / dt,
                        frames_per_sec=n_frames / dt, n_frames=n_frames, size=size,
                        geometry=None if geometry is None else geometry.tolist(),
                        pending_gib=held / 2 ** 30 if cuda and held is not None else None,
                        peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None)
    best.update(backend=backend, device=torch.cuda.get_device_name(dev) if cuda else "cpu",
                frame_batch=frame_batch, fused=fused,
                fallback_batches=fallback.calls, batches_run=2 + 2 * len(batches))
    return best


def _read_baseline(path: str) -> float | None:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)["cells_per_sec"]
    return None


def load_cpu_baseline(backend: str = "threshold") -> float | None:
    return _read_baseline(_BASELINE_STARDIST_PATH if backend == "stardist" else _BASELINE_PATH)


def _line(metric: str, rate: float, base: float | None) -> str:
    return json.dumps({"metric": metric, "value": round(rate, 2), "unit": "cells/s/chip",
                       "vs_baseline": round(rate / base, 2) if base else None})


def run_bench(n_frames: int = 48, size: int = 1024, n_cells: int = 80,
              backend: str = "threshold", device=None, frames=None,
              report: dict | None = None, frame_batch: int = FRAME_BATCH,
              fused: bool = True) -> str:
    """The headline: 3 pipelined batches of 16 frames against the
    backend's CPU baseline; one JSON line.  `report`, if given, receives
    `run_device_bench`'s result; `frame_batch` and `fused` are its."""
    res = run_device_bench(n_frames=n_frames, size=size, n_cells=n_cells, backend=backend,
                           device=device, frames=frames, frame_batch=frame_batch, fused=fused)
    if report is not None:
        report.update(res)
    suffix = "_stardist" if backend == "stardist" else ""
    return _line(f"screening_cells_per_sec_per_chip{suffix}", res["cells_per_sec"],
                 load_cpu_baseline(backend))


# JAX's plate-scale rows (scripts/bench_2048.py, scripts/bench_4096.py):
# side -> (frames, cells a frame, frame batch)
PLATE_ROWS = {2048: (12, 320, 2), 4096: (4, 1280, 2)}


def plate_line(size: int, res: dict) -> str:
    """The JSON line of JAX's plate-scale scripts, from
    `run_device_bench`'s result: `mpx_per_sec` on the 4096^2 row only."""
    out = {"metric": f"screening_cells_per_sec_per_chip_stardist_{size}",
           "value": round(res["cells_per_sec"], 2), "unit": "cells/s/chip",
           "frames_per_sec": round(res["frames_per_sec"], 3)}
    if size == 4096:
        out["mpx_per_sec"] = round(res["frames_per_sec"] * size * size / 1e6, 1)
    out["cells"] = res["cells"]
    return json.dumps(out)


def plate_row_main(size: int, argv=None) -> int:
    """`scripts/bench_{size}_torch.py [n_frames] [frame_batch] [--device
    D]`: StarDist screening of `PLATE_ROWS[size]`'s frames at
    `plate_settings(size)`, pipelined; one JSON line on stdout, the
    device, the settings, the batches that fell back, the largest frame's
    geometry-passing labels against the cell capacity and the memory on
    stderr.  Without a GPU it exits 2 unless given `--device cpu`."""
    import argparse
    import sys

    n_frames, n_cells, frame_batch = PLATE_ROWS[size]
    ap = argparse.ArgumentParser(
        prog=f"bench_{size}_torch.py",
        description=f"Plate-scale bench row: {size}^2 frames, {n_cells} cells a frame, "
                    "through the fused StarDist path on one GPU")
    ap.add_argument("n_frames", nargs="?", type=int, default=n_frames)
    ap.add_argument("frame_batch", nargs="?", type=int, default=frame_batch)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU, slowly)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.exit(2, f"{ap.prog}: error: {e} (--device cpu)\n")
    seg, kw = plate_settings(size)
    print(f"device: {device}; StarDist settings {seg}, {kw}", file=sys.stderr)
    res = run_device_bench(n_frames=args.n_frames, size=size, n_cells=n_cells,
                           backend="stardist", device=device, frame_batch=args.frame_batch)
    print(plate_line(size, res))
    top, cap = max(res["geometry"]), kw["cell_capacity"]
    reached = " (reached: the frame may have lost cells)" if top >= cap else ""
    print(f"{res['device']}: {args.n_frames} frames in batches of {args.frame_batch}; batches "
          f"that fell back to the exact twin {res['fallback_batches']} of {res['batches_run']}; "
          f"geometry-passing labels of the largest frame {top}, cell capacity {cap}{reached}; "
          f"pending {res['pending_gib']} GiB, peak {res['peak_gib']} GiB", file=sys.stderr)
    return 0


def run_train_bench(n_cells: int = 2048, epochs: int = 12, device=None, train_cfg=None,
                    report: dict | None = None) -> str:
    """CAE training throughput on `device` (default: the card): the
    production `fit_cae` (on-device augmentation, the step, the per-epoch
    validation and the Keras callbacks) on `make_cells(default_rng(3),
    n_cells)`, after a one-epoch warm-up, synchronized before the clock
    stops.  cells/s = train cells consumed (steps x batch x epochs run)
    per wall second, with `train_cfg`'s (default `TrainConfig()`) split,
    batch and seed.  `report`, if given, receives cells, seconds,
    cells_per_sec, steps, epochs and the device's name."""
    from cell_image_analysis_tpu_torch.config import TrainConfig
    from cell_image_analysis_tpu_torch.train.trainer import fit_cae, train_test_split
    from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

    dev = resolve_device(device)
    cfg = train_cfg or TrainConfig()
    X = torch.as_tensor(make_cells(np.random.default_rng(3), n_cells)[..., None], device=dev)
    cuda = dev.type == "cuda"
    fit_cae(X, train_cfg=dataclasses.replace(cfg, epochs=1), verbose=False)   # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, history = fit_cae(X, train_cfg=dataclasses.replace(cfg, epochs=epochs), verbose=False)
    if cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_train = len(train_test_split(np.arange(n_cells), cfg.val_split, cfg.seed)[0])
    steps = max(1, n_train // cfg.batch_size)   # fit_cae's own count
    ran = len(history.history["loss"])
    cells_per_sec = steps * cfg.batch_size * ran / dt
    if report is not None:
        report.update(cells=steps * cfg.batch_size * ran, seconds=dt,
                      cells_per_sec=cells_per_sec, steps=steps, epochs=ran,
                      device=torch.cuda.get_device_name(dev) if cuda else "cpu")
    return _line("cae_train_cells_per_sec_per_chip", cells_per_sec,
                 _read_baseline(_BASELINE_TRAIN_PATH))
