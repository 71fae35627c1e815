#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one GPU

Phases (any failure exits non-zero before the last line is printed):

0. environment: the GPU's name and power limit, nvcc, torch/CUDA/triton
   versions, CUTLASS headers; no GPU -> exit 1 at once, no CPU run;
1. build `cell_image_analysis_tpu_torch/csrc/*.cu` with nvcc (sm_90a);
2. each hand-written kernel against its plain PyTorch version on the card
   at main-path shapes (Winograd conv: max|y - ref| / max|ref| < 1e-5;
   segment sum and CLAHE core: equal), with median times of both;
3. the main path — StarDist screening of 16 synthetic 1024^2 frames
   (the bench's frames and settings) through `score_frames_fused`, run
   twice; the launch counts of the second run must all be > 0;
4. the port on the GPU against the port on the CPU on one 512^2 frame:
   identical cell sets, predictions and scores within 1e-4, except what
   `utils.parity` allows and lists (label pixels within 1e-3 px of a
   polygon boundary, decisions within 1e-4 of their threshold);
5. a JSON line with each kernel's numbers, the `nvidia-smi` name/power
   line, and the final `{"ok": true, "device": {...}}` line.

It imports no JAX.  Needs the rest of the repository beside it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "cell_image_analysis_tpu_torch"
WINO_SHAPES = {  # main-path U-Net layers: (B, H, W, Ci, Co)
    "Conv_1": (16, 1024, 1024, 32, 32),
    "Conv_7": (16, 128, 128, 256, 256),
    "Conv_8": (16, 256, 256, 384, 128),
}
CLAHE_CAPS = ((64, 12), (96, 12), (192, 16))  # bucket capacity, ns_cap
TOL = 1e-4  # GPU-vs-CPU score tolerance, and the near-threshold band


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 7) -> float:
    """Median CUDA-event time of `fn()` over n runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_env(torch) -> None:
    log(f"[0] nvidia-smi: {smi_line()}")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True)
    if nvcc.returncode != 0:
        nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                              capture_output=True, text=True, check=True)
    log(f"[0] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    triton = importlib.util.find_spec("triton")
    triton_v = "not installed"
    if triton is not None:
        import triton as triton_mod

        triton_v = triton_mod.__version__
    log(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton_v}, "
        f"jax {'importable' if importlib.util.find_spec('jax') else 'not installed'}")
    log(f"[0] CUTLASS headers at /usr/local/cutlass/include: "
        f"{os.path.isdir('/usr/local/cutlass/include')}")
    log(f"[0] device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def phase_build() -> float:
    from cell_image_analysis_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[1] built {os.path.relpath(path, REPO)} in {secs:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'reused'})")
    return secs


def phase_kernels(torch, dev, unet_vars) -> dict:
    from cell_image_analysis_tpu.utils.synthetic import make_frame_instances
    from cell_image_analysis_tpu_torch.ops.clahe import (
        clahe_core_plain,
        clahe_prepare,
    )
    from cell_image_analysis_tpu_torch.ops.cuda.clahe_kernel import clahe_core_cuda
    from cell_image_analysis_tpu_torch.ops.cuda.segsum import segment_sums_cuda
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
    from cell_image_analysis_tpu_torch.ops.runs import run_moment_table
    from cell_image_analysis_tpu_torch.ops.segsum import segment_sums_plain
    from cell_image_analysis_tpu_torch.ops.winograd import (
        winograd_conv3x3_plain,
        winograd_kernel_transform,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}

    # Winograd conv, the committed U-Net weights of three main-path layers
    err_w, ms_w, plain_w = 0.0, 0.0, 0.0
    for name, (B, H, W, ci, co) in WINO_SHAPES.items():
        Wt = torch.tensor(unet_vars["params"][name]["kernel"], device=dev)
        bias = torch.tensor(unet_vars["params"][name]["bias"], device=dev)
        x = torch.relu(torch.randn((B, H, W, ci), generator=gen, device=dev))
        U = winograd_kernel_transform(Wt).reshape(16, ci, co)
        y = winograd_conv3x3_cuda(x, U, bias)
        ref = winograd_conv3x3_plain(x, Wt, bias)
        torch.cuda.synchronize()
        abs_err = float((y - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        t_k = time_ms(lambda: winograd_conv3x3_cuda(x, U, bias))
        t_p = time_ms(lambda: winograd_conv3x3_plain(x, Wt, bias))
        log(f"[2] winograd {name} {B}x{H}x{W}x{ci}->{co}: max abs err {abs_err:.3e}, "
            f"rel {rel:.3e}; kernel {t_k:.3f} ms, plain F.conv2d {t_p:.3f} ms")
        if not rel < 1e-5:
            raise AssertionError(f"winograd {name}: relative error {rel:.3e} >= 1e-5")
        err_w, ms_w, plain_w = max(err_w, abs_err), ms_w + t_k, plain_w + t_p
        del x, y, ref
    res["winograd_conv3x3"] = dict(max_abs_err=err_w, ms=ms_w, plain_ms=plain_w)

    # segment sum over one 1024-row frame's run table (true instance labels)
    _, labels = make_frame_instances(np.random.default_rng(7), size=1024, n_cells=80)
    labels = torch.tensor(labels.astype(np.int32), device=dev)[None]
    seg, data, n_seg = run_moment_table(labels, capacity=128, rcap=32)
    got = segment_sums_cuda(seg, data, n_seg)
    ref = segment_sums_plain(seg, data, n_seg)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("segment_sum: kernel differs from index_add_")
    t_k = time_ms(lambda: segment_sums_cuda(seg, data, n_seg))
    t_p = time_ms(lambda: segment_sums_plain(seg, data, n_seg))
    log(f"[2] segment_sum {tuple(data.shape)} -> ({n_seg}, 6), "
        f"{int((ref[:, 0] > 0).sum())} labels: equal; kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
    res["segment_sum"] = dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p)

    # CLAHE core on a 32-cell chunk per bucket capacity
    rng = np.random.default_rng(3)
    ms_c, plain_c = 0.0, 0.0
    for cap, ns_cap in CLAHE_CAPS:
        lo_side = 16 if ns_cap == 12 else 13
        hs = rng.integers(lo_side, cap + 1, size=32).astype(np.int32)
        ws = rng.integers(lo_side, cap + 1, size=32).astype(np.int32)
        crops = np.round(rng.uniform(80, 3000, size=(32, cap, cap))).astype(np.float32)
        prep = clahe_prepare(torch.tensor(crops, device=dev), torch.tensor(hs, device=dev),
                             torch.tensor(ws, device=dev), ns_cap=ns_cap)
        core = prep[:7]
        got = clahe_core_cuda(*core, ns_cap * ns_cap)
        ref = clahe_core_plain(*core, ns_cap * ns_cap)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            n_bad = int((got != ref).sum())
            raise AssertionError(f"clahe_core cap {cap}: {n_bad} values differ")
        t_k = time_ms(lambda: clahe_core_cuda(*core, ns_cap * ns_cap))
        t_p = time_ms(lambda: clahe_core_plain(*core, ns_cap * ns_cap))
        log(f"[2] clahe_core 32 cells cap {cap} ns_cap {ns_cap}: bit-equal; "
            f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
        ms_c, plain_c = ms_c + t_k, plain_c + t_p
    res["clahe_core"] = dict(max_abs_err=0.0, ms=ms_c, plain_ms=plain_c)
    return res


class _RecordingBackend:
    """Wraps a segment_fn to keep the last batch's overflow flags."""

    def __init__(self, backend):
        self.backend = backend
        self.overflow = None

    def __call__(self, segs):
        labels, ovf = self.backend(segs)
        self.overflow = ovf
        return labels, ovf


def _check_result(scores: dict, stats: dict, n_frames: int) -> int:
    n = len(stats["area"])
    if n < 10 * n_frames:
        raise AssertionError(f"only {n} cells from {n_frames} frames")
    for k in ("reconstruction_mse", "conservative_scores", "moderate_scores", "fft_scores"):
        if scores[k].shape != (n,) or not np.all(np.isfinite(scores[k])):
            raise AssertionError(f"{k}: shape {scores[k].shape} or non-finite values")
    if scores["fft_features"].shape != (n, 27) or not np.all(np.isfinite(scores["fft_features"])):
        raise AssertionError("fft_features: bad shape or non-finite values")
    for k in ("conservative", "moderate", "ensemble", "fft"):
        if not set(np.unique(scores[f"{k}_predictions"])) <= {-1, 1}:
            raise AssertionError(f"{k}_predictions outside {{-1, +1}}")
    return n


def phase_main_path(torch, dev, unet_vars, seg_cfg, stage_a) -> tuple:
    from cell_image_analysis_tpu.utils.synthetic import make_frame
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.ops.cuda import clahe_kernel, segsum, winograd
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)  # utils/bench._make_frames(16, 1024, 80)
    frames = np.stack([make_frame(rng, size=1024, n_cells=80) for _ in range(16)])
    log(f"[3] made 16 frames 1024^2 in {time.perf_counter() - t0:.1f} s (host numpy)")
    segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(frames[..., 1].astype(np.float32), device=dev)
    backend = _RecordingBackend(StarDistBackend(unet_vars, seg_cfg, device=dev))
    model, params = load_scoring_params(device=dev)
    mods = (winograd, segsum, clahe_kernel)

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = score_frames_fused(model, params, segs, greens, backend, chunk=32,
                                 caps=(64, 96), **stage_a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (_, _), t_first = run()
    log(f"[3] first run (warm-up) {t_first:.2f} s")
    for m in mods:
        m.LAUNCHES = 0
    (scores, stats), t_run = run()
    launches = {"winograd_conv3x3": winograd.LAUNCHES, "segment_sum": segsum.LAUNCHES,
                "clahe_core": clahe_kernel.LAUNCHES}
    n = _check_result(scores, stats, 16)
    log(f"[3] segmentation overflow flags per frame: "
        f"{backend.overflow.int().tolist()} (run-table overflow raises in the pipeline)")
    log(f"[3] cells {n}; rates " + ", ".join(
        f"{k} {scores[f'{k}_anomaly_rate']:.4f}"
        for k in ("conservative", "moderate", "ensemble", "fft")))
    log(f"[3] launches in the timed run: {launches}")
    log(f"[3] timed run: {t_run:.3f} s wall, {n / t_run:.1f} cells/s "
        f"({16 / t_run:.2f} frames/s)")
    if bool(backend.overflow.any()):
        raise AssertionError("a segmentation overflow flag is set on the smoke frames")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    return launches, n, t_run


def phase_gpu_vs_cpu(torch, dev, unet_vars, seg_cfg, stage_a) -> None:
    from cell_image_analysis_tpu.utils.synthetic import make_frame
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.utils.parity import boundary_flips, compare_screens

    frame = make_frame(np.random.default_rng(11), size=512, n_cells=25)
    results, labels = [], []
    for d in (dev, torch.device("cpu")):
        backend = StarDistBackend(unet_vars, seg_cfg, device=d)
        model, params = load_scoring_params(device=d)
        segs = torch.tensor(frame[None, ..., 2].astype(np.float32), device=d)
        greens = torch.tensor(frame[None, ..., 1].astype(np.float32), device=d)
        results.append(score_frames_fused(model, params, segs, greens, backend, chunk=32,
                                          caps=(64, 96), **stage_a))
        with torch.inference_mode():
            lab, det = predict_instances(segs, backend.model, seg_cfg)
        labels.append(lab[0].cpu())
    # the CPU run is the reference; label maps may differ only at knife edges
    flips = {(0, lab): n for lab, n in boundary_flips(
        labels[1], labels[0], det.points[0], det.dists[0], det.keep[0]).items()}
    report = compare_screens(results[1], results[0], flips,
                             float(params.ensemble_mse_threshold), tol=TOL)
    log(f"[4] 512^2 frame, GPU vs CPU: {report['n_cells']} cells, same cell set; "
        f"max score difference {report['max_score_diff']:.3e}; knife-edge cells "
        f"{report['knife_edge_cells']}; within {TOL} of a threshold "
        f"{report['near_threshold']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cell_image_analysis_tpu.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables

    dev = torch.device("cuda", 0)
    seg_cfg = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
    stage_a = dict(label_capacity=128, cell_capacity=128, rcap=32)
    unet_vars = load_unet_variables()

    if 0 in phases:
        phase_env(torch)
    if 1 in phases:
        phase_build()
    kernels = phase_kernels(torch, dev, unet_vars) if 2 in phases else {}
    launches = {}
    if 3 in phases:
        launches, _, _ = phase_main_path(torch, dev, unet_vars, seg_cfg, stage_a)
    if 4 in phases:
        phase_gpu_vs_cpu(torch, dev, unet_vars, seg_cfg, stage_a)
    if phases != {0, 1, 2, 3, 4}:
        log(f"partial run (phases {sorted(phases)}): no result line")
        return 1

    meta = {
        "winograd_conv3x3": ("csrc/winograd_conv3x3.cu",
                             "cell_image_analysis_tpu/ops/pallas/winograd.py:184"),
        "segment_sum": ("csrc/segment_sum.cu",
                        "cell_image_analysis_tpu/ops/pallas/segsum.py:49"),
        "clahe_core": ("csrc/clahe_core.cu",
                       "cell_image_analysis_tpu/ops/pallas/clahe_kernel.py:184"),
    }
    rows = [dict(name=name, route="cuda", source=f"{PKG}/{src}", replaces=rep,
                 launches=launches[name], **kernels[name])
            for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
