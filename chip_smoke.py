#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one GPU

Phases (any failure exits non-zero before the last line is printed):

0. environment: the GPU's name and power limit, nvcc, torch/CUDA/triton
   versions, CUTLASS headers; no GPU -> exit 1 at once, no CPU run;
1. build `cell_image_analysis_tpu_torch/csrc/*.cu` with nvcc (sm_90a);
2. each hand-written kernel against its plain PyTorch version on the card
   at main-path shapes, with the kernel's device time (torch.profiler over
   20 launches), an event-timed wrapper call, the plain version's time,
   the one PyTorch call that computes the same function where there is
   one, and the bound (the least time the card could take: bytes over
   3.35 TB/s or operations over their peak, H100 SXM published figures):
   Winograd conv at all 13 U-Net layers, B = 16: max|y - ref| / max|ref|
   < 1e-5, its row summed over Conv_1, Conv_7 and Conv_8, library call
   cuDNN fp32; segment sum on the 16 frames' run table (524,288 x 6):
   equal, library call `index_add_`; the fused CLAHE kernel on 32 random
   cells at each bucket capacity, on the main path's own size buckets
   (StarDist stage A of the 16 frames; its row sums these) and on the
   threshold path's (the mask route's stage A; the row's `threshold_*`
   keys): bit-equal; `label_components` (the tile CC kernel, compaction
   included) on the 16 frames' threshold masks at connectivity 1 and 2:
   labels and counts equal to `label_components_plain`, with the eager
   compaction that the parent ran after its kernel timed for the record;
   then on 1024^2 structural masks (all-true, a full-frame serpentine,
   random at 0.59 density) at connectivity 1 and 2: equal to labels
   derived from `scipy.ndimage.label` on the host;
3. the main path — StarDist screening of the bench's 16 synthetic
   1024^2 frames (made once, on the host, for phases 2, 3, 5 and 6)
   through `score_frames_fused`, run twice; the launch counts of the
   second run must all be > 0, CLAHE at most once a non-empty size bucket,
   and no overflow flag may fire;
4. the port on the GPU against the port on the CPU on one 512^2 frame,
   StarDist and both threshold routes: identical cell sets, predictions
   and scores within 1e-4, except what `utils.parity` allows and lists
   (label pixels within 1e-3 px of a polygon boundary, decisions within
   1e-4 of their threshold);
5. threshold screening of the 16 frames at the bench's threshold
   settings: (a) the mask route with the exact label route as fallback,
   run twice, the second timed; (b) the label route alone (CC kernel,
   pixel regionprops); (c) the mask route at rcap 8, whose fallback must
   fire.  (a) and (b) give the same cells, areas and predictions, scores
   within 1e-4; (c) equals (b) exactly.  The counts are set to 0 before
   each run and read after it: (a) launches segment sum and CLAHE (at
   most once a size bucket), (b) the CC kernel too (its row's count), and
   (c) as many CC calls as (b) (one per batch; each call is
   `ops.cuda.cc.KERNELS_PER_CALL` launches);
6. the StarDist exact twin (scatter rasterizer, K^2 NMS pairs, pixel
   regionprops) on the 16 frames: phase 3's cells, areas and scores
   within 1e-4, except the listed cells of polygons that the scatter
   rasterizer clips to its patch; then a run at an NMS budget of 64
   pairs must fall back to the twin and equal it;
7. screening from files at full width: four sample folders of synthetic
   TIFFs (`wildtype`, 40 frames of 1024^2, so batches of 16, 16 and 8 with
   two in flight; `mutantA`, 8 frames and a corrupt file; `odd`, 2 frames
   of 1004 x 1020; `empty`), written in worker processes while phases 1-3
   run, go through `ProductionMutantScreening(assets/screening_store_synthetic,
   PipelineConfig())` with the bundled U-Net at the default capacities.
   The three samples with cells come back, the skip messages are printed,
   the output files exist (the three figures only where matplotlib is
   installed: without it the screener is told to leave them out, which the
   log says),
   per-file counts sum to `total_cells`, and `wildtype`'s scores equal, bit
   for bit, `score_frames_fused` called on the same decoded frames in the
   same three batches; Winograd, segment sum and CLAHE were launched.
   Those direct calls, and one on `odd`, run with every call of a kernel's
   wrapper held against the kernel's plain version on the same tensors
   (`_HeldAgainstPlain`), so each kernel is checked at the screener's own
   shapes, which are not phase 2's: B = 16, 8 and 2, frames padded to
   1008 x 1024, label capacity 1024, 16 x 512 crop slots, the exact twin's
   pixel-regionprops table.  Cells/s, the stage report and the TIFF decode
   seconds of the timed run are printed, and the host waits inside
   `score_frames_fused_start`, counted in a second pass over `wildtype`;
8. the threshold screener on 16 of those frames; the same 16 frames
   through `score_frames_fused` and `extract_quality_cells` on one frame
   with each backend, again with every kernel call held against its plain
   version (the threshold backend's goes through the CC kernel), and
   `extract_quality_cells` on the card against the same call on the CPU;
9. `python -m cell_image_analysis_tpu_torch.cli screen` in a subprocess on
   `mutantA` (exit 0, summary CSV), and on a model directory that does not
   exist (exit code not 0);
10. a JSON line with each kernel's numbers, the `nvidia-smi` name/power
   line, and the final `{"ok": true, "device": {...}}` line.

It imports no JAX.  Needs the rest of the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "cell_image_analysis_tpu_torch"
WINO_LAYERS = {  # the U-Net's 13 3x3 convs on the bench's 16 frames: (B, H, W, Ci, Co)
    "Conv_0": (16, 1024, 1024, 1, 32), "Conv_1": (16, 1024, 1024, 32, 32),
    "Conv_2": (16, 512, 512, 32, 64), "Conv_3": (16, 512, 512, 64, 64),
    "Conv_4": (16, 256, 256, 64, 128), "Conv_5": (16, 256, 256, 128, 128),
    "Conv_6": (16, 128, 128, 128, 256), "Conv_7": (16, 128, 128, 256, 256),
    "Conv_8": (16, 256, 256, 384, 128), "Conv_9": (16, 256, 256, 128, 128),
    "Conv_10": (16, 512, 512, 192, 64), "Conv_11": (16, 512, 512, 64, 64),
    "Conv_12": (16, 512, 512, 64, 128),
}
WINO_ROW = ("Conv_1", "Conv_7", "Conv_8")  # the kernels row's ms sum these three
CLAHE_CAPS = ((64, 12), (96, 12), (192, 16))  # bucket capacity, ns_cap
TOL = 1e-4  # GPU-vs-CPU score tolerance, and the near-threshold band
H100_HBM_BYTES_S = 3.35e12  # H100 SXM published peaks (NVIDIA data sheet), at 700 W
H100_TF32_FLOPS = 495e12
# utils/bench.py:250-253, the threshold backend's screening settings
THRESH_KW = dict(chunk=32, caps=(64, 96), label_capacity=4096, cell_capacity=128,
                 fg_fraction=0.12)
N_BUCKETS = 3  # caps 64 and 96, and the full crop capacity
ALL_PHASES = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9}
STORE = os.path.join(REPO, "assets", "screening_store_synthetic")
# phase 7's sample folders: (name, frames, seed, mutant_fraction, crop)
SAMPLES = (("wildtype", 40, 21, 0.0, None), ("mutantA", 8, 22, 0.7, None),
           ("odd", 2, 23, 0.0, (1004, 1020)))
CHUNK_FRAMES = 8  # frames a worker process writes
FRAME_SIZE, FRAME_CELLS = 1024, 80  # phase 7's frames, as the bench's


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 7) -> float:
    """Median CUDA-event time of `fn()` over n runs after one warm-up: one
    host-wrapped call between two events, so at tens of microseconds it
    measures the wrapper as much as the kernel."""
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


def device_ms(fn, kernels: tuple, n: int = 20) -> float:
    """The device time a call of `fn()` spends in the kernels whose names
    contain one of `kernels`: torch.profiler's device time over n calls
    after one warm-up, divided by n (no wrapper or launch gap in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if any(k in e.key for k in kernels))
    if total <= 0:
        raise AssertionError(f"torch.profiler saw no device time of {kernels}")
    return total / 1e3 / n


def bound(n_bytes: float, flops: float = 0.0, flop_rate: float = 0.0) -> tuple:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate (H100 SXM
    published peaks), with which of the two sets it."""
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3 if flops else 0.0
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def winograd_bound(B: int, H: int, W: int, ci: int, co: int) -> tuple:
    """A Winograd F(2,3) layer at the layer's own Ci and Co (not the
    kernel's padded ones): 16 positions x 2x2 tiles x Ci x Co products,
    2 operations each, three times over at the TF32 tensor-core peak,
    since three TF32 products (3xTF32) are the price of float32 accuracy
    on the TF32 tensor cores; bytes: x read and y written once, U_hi,
    U_lo and the bias read once."""
    tiles = B * -(-H // 2) * -(-W // 2)
    flops = 3 * 2 * 16 * tiles * ci * co
    n_bytes = 4 * (B * H * W * (ci + co) + 2 * 16 * ci * co + co)
    return bound(n_bytes, flops, H100_TF32_FLOPS)


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


def stage_a_buckets(torch, segment_fn, segs, greens, candidate_kwargs) -> dict:
    """A path's stage A on the 16 frames, as `score_frames_fused` runs it:
    the candidates' crops (N, 192, 192), heights and widths (N,) and the
    size buckets [(ids, cap, ns_cap)]."""
    from cell_image_analysis_tpu_torch.pipeline.scoring import _stage_a, size_buckets

    with torch.inference_mode():
        cand, _ = _stage_a(segment_fn, segs, greens, candidate_kwargs)
    B, ccap, full_cap = cand.crops.shape[:3]
    crops = cand.crops.reshape(B * ccap, full_cap, full_cap).float().contiguous()
    heights, widths = cand.heights.reshape(-1).int(), cand.widths.reshape(-1).int()
    buckets = size_buckets(heights, widths, cand.valid.reshape(-1), (64, 96), full_cap)
    return dict(crops=crops, heights=heights, widths=widths, buckets=buckets)


def _clahe_check(torch, crops, ids, hs, ws, cap, ns_cap, what: str) -> dict:
    """The fused CLAHE kernel bit-equal to its plain version on one bucket,
    its device time, the event-timed wrapper call, the plain version's
    time and its bound."""
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, clahe_cells_plain

    idx = ids.long()

    def plain():
        return clahe_cells_plain(crops[idx][:, :cap, :cap], hs[idx], ws[idx], ns_cap=ns_cap)

    ref = plain()
    got = clahe_bucket(crops, ids, hs, ws, cap, ns_cap=ns_cap)
    torch.cuda.synchronize()
    if not torch.equal(got, ref) or bool(torch.isnan(got).any()):
        raise AssertionError(f"clahe_cells {what}: {int((got != ref).sum())} values differ")
    ms = device_ms(lambda: clahe_bucket(crops, ids, hs, ws, cap, ns_cap=ns_cap),
                   ("clahe_cells_kernel",))
    t_k = time_ms(lambda: clahe_bucket(crops, ids, hs, ws, cap, ns_cap=ns_cap))
    t_p = time_ms(plain, n=3)
    C = ids.numel()
    n_bytes = 4 * (float((hs[idx].long() * ws[idx].long()).sum()) + C * cap * cap + 3 * C)
    b_ms, _ = bound(n_bytes)
    log(f"[2] clahe_cells {what}, {C} cells cap {cap} ns_cap {ns_cap}: bit-equal; kernel "
        f"device {ms:.4f} ms, wrapper call {t_k:.4f} ms; bound {b_ms * 1e3:.2f} us "
        f"({n_bytes / 1e6:.2f} MB), {100 * b_ms / ms:.1f}% of it; plain {t_p:.3f} ms")
    return dict(ms=ms, event_ms=t_k, plain_ms=t_p, bound_ms=b_ms)


def _clahe_buckets(torch, path: dict, what: str) -> dict:
    """`_clahe_check` on each non-empty bucket of a path, summed."""
    row = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for ids, cap, ns_cap in path["buckets"]:
        if ids.numel():
            r = _clahe_check(torch, path["crops"], ids.int(), path["heights"], path["widths"],
                             cap, ns_cap, f"{what} bucket")
            row = {k: row[k] + r[k] for k in row}
    log(f"[2] clahe_cells, the {what}'s buckets: kernel device {row['ms']:.4f} ms, bound "
        f"{row['bound_ms'] * 1e3:.2f} us, plain {row['plain_ms']:.3f} ms")
    return row


def phase_kernels(torch, dev, unet_vars, main, thresh) -> dict:
    from cell_image_analysis_tpu_torch.models.segmentation import threshold_mask
    from cell_image_analysis_tpu_torch.ops.cc import (
        cc_min_labels_plain,
        compact_labels,
        label_components,
        label_components_plain,
    )
    from cell_image_analysis_tpu_torch.ops.cuda.segsum import segment_sums_cuda
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
    from cell_image_analysis_tpu_torch.ops.runs import run_moment_table
    from cell_image_analysis_tpu_torch.ops.segsum import segment_sums_plain
    from cell_image_analysis_tpu_torch.ops.winograd import (
        pad_input,
        winograd_conv3x3_plain,
        winograd_operands,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}

    # Winograd conv, the committed U-Net weights of all 13 layers at main-path shapes
    err_w, all_k, all_p = 0.0, 0.0, 0.0
    row = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    largest = (0.0, "operations")   # the row's bound_by: that of its largest layer bound
    for name, (B, H, W, ci, co) in WINO_LAYERS.items():
        Wt = torch.tensor(unet_vars["params"][name]["kernel"], device=dev)
        bias = torch.tensor(unet_vars["params"][name]["bias"], device=dev)
        x = torch.relu(torch.randn((B, H, W, ci), generator=gen, device=dev))
        xp, ops = pad_input(x), winograd_operands(Wt, bias)
        y = winograd_conv3x3_cuda(xp, *ops)
        ref = winograd_conv3x3_plain(x, Wt, bias)
        torch.cuda.synchronize()
        abs_err = float((y - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        t_k = time_ms(lambda: winograd_conv3x3_cuda(xp, *ops))
        t_p = time_ms(lambda: winograd_conv3x3_plain(x, Wt, bias))
        pad = (f"; the wrapper's channel pad {ci}->{xp.shape[-1]} {time_ms(lambda: pad_input(x)):.3f} ms"
               if xp.shape != x.shape else "")
        log(f"[2] winograd {name} {B}x{H}x{W}x{ci}->{co}: max abs err {abs_err:.3e}, "
            f"rel {rel:.3e}; kernel {t_k:.3f} ms, plain F.conv2d {t_p:.3f} ms{pad}")
        if not rel < 1e-5:
            raise AssertionError(f"winograd {name}: relative error {rel:.3e} >= 1e-5")
        err_w, all_k, all_p = max(err_w, abs_err), all_k + t_k, all_p + t_p
        if name in WINO_ROW:
            d_k = device_ms(lambda: winograd_conv3x3_cuda(xp, *ops), ("winograd_kernel",), n=5)
            b_ms, b_by = winograd_bound(B, H, W, ci, co)
            largest = max(largest, (b_ms, b_by))
            # the plain version is one cuDNN fp32 call, the library's
            t_l = time_ms(lambda: torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), Wt.permute(3, 2, 0, 1), bias, padding=1))
            log(f"[2] winograd {name}: kernel device {d_k:.3f} ms; bound {b_ms:.3f} ms "
                f"({b_by}), {100 * b_ms / d_k:.1f}% of it; F.conv2d alone {t_l:.3f} ms")
            for k, v in (("ms", d_k), ("event_ms", t_k), ("plain_ms", t_p), ("bound_ms", b_ms),
                         ("library_ms", t_l)):
                row[k] += v
        del x, xp, y, ref
    log(f"[2] winograd, all 13 layers: kernel {all_k:.3f} ms, plain {all_p:.3f} ms; "
        f"{' + '.join(WINO_ROW)}: kernel device {row['ms']:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms")
    res["winograd_conv3x3"] = dict(max_abs_err=err_w, bound_by=largest[1], **row)

    # segment sum over the 16 frames' run table, as stage A of the main path builds it
    seg, data, n_seg = run_moment_table(main["labels"], capacity=128, rcap=32)
    got = segment_sums_cuda(seg, data, n_seg)
    ref = segment_sums_plain(seg, data, n_seg)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("segment_sum: kernel differs from index_add_")
    keep = (seg >= 0) & (seg < n_seg)
    seg_k, data_k = seg[keep].long(), data[keep]
    out = torch.zeros((n_seg, data.shape[1]), dtype=torch.int64, device=dev)
    t_d = device_ms(lambda: segment_sums_cuda(seg, data, n_seg), ("segment_sum_kernel",))
    t_k = time_ms(lambda: segment_sums_cuda(seg, data, n_seg))
    t_p = time_ms(lambda: segment_sums_plain(seg, data, n_seg))
    t_l = time_ms(lambda: out.index_add_(0, seg_k, data_k))
    b_ms, b_by = bound(seg.numel() * 4 + data.numel() * 8 + n_seg * data.shape[1] * 8)
    log(f"[2] segment_sum {tuple(data.shape)} -> ({n_seg}, 6), "
        f"{int((ref[:, 0] > 0).sum())} labels: equal; kernel device {t_d:.4f} ms, wrapper "
        f"call {t_k:.4f} ms; bound {b_ms * 1e3:.2f} us ({b_by}), {100 * b_ms / t_d:.1f}% of "
        f"it; plain {t_p:.3f} ms, index_add_ alone {t_l:.3f} ms")
    res["segment_sum"] = dict(max_abs_err=0.0, ms=t_d, event_ms=t_k, plain_ms=t_p,
                              bound_ms=b_ms, bound_by=b_by, library_ms=t_l)

    # CLAHE: 32 random cells at each bucket capacity, then the main path's buckets
    rng = np.random.default_rng(3)
    for cap, ns_cap in CLAHE_CAPS:
        lo_side = 16 if ns_cap == 12 else 13
        hs = rng.integers(lo_side, cap + 1, size=32).astype(np.int32)
        ws = rng.integers(lo_side, cap + 1, size=32).astype(np.int32)
        crops = np.round(rng.uniform(80, 3000, size=(32, cap, cap))).astype(np.float32)
        t = [torch.tensor(a, device=dev) for a in (crops, hs, ws)]
        _clahe_check(torch, t[0], torch.arange(32, dtype=torch.int32, device=dev), t[1], t[2],
                     cap, ns_cap, "32 random cells")
    row = _clahe_buckets(torch, main, "main path")
    thr = _clahe_buckets(torch, thresh, "threshold path")
    res["clahe_cells"] = dict(max_abs_err=0.0, bound_by="bytes", library_ms=None, **row,
                              threshold_ms=thr["ms"], threshold_bound_ms=thr["bound_ms"])

    # CC on the 16 frames' threshold masks (the threshold label route's input)
    masks = threshold_mask(main["segs"])
    log(f"[2] label_components input: {tuple(masks.shape)} masks, "
        f"{float(masks.float().mean()):.4f} foreground")
    for conn in (1, 2):
        got, count = label_components(masks, conn)
        ref, ref_count = label_components_plain(masks, conn)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(count, ref_count)):
            n_bad = int((got != ref).sum())
            raise AssertionError(f"label_components connectivity {conn}: {n_bad} labels, "
                                 f"{int((count != ref_count).sum())} counts differ")
        err = float((got - ref).abs().max())
        t_d = device_ms(lambda: label_components(masks, conn), ("cc_tile_",))
        t_k = time_ms(lambda: label_components(masks, conn))
        t_p = time_ms(lambda: label_components_plain(masks, conn), n=3)
        raw = cc_min_labels_plain(masks, conn)
        t_c = time_ms(lambda: compact_labels(raw))
        b_ms, b_by = bound(masks.numel() * (1 + 4))
        log(f"[2] label_components connectivity {conn}: {int(count.sum())} components, labels "
            f"and counts equal; kernels device {t_d:.4f} ms, wrapper call {t_k:.4f} ms; bound "
            f"{b_ms * 1e3:.2f} us ({b_by}), {100 * b_ms / t_d:.1f}% of it; plain {t_p:.3f} ms; "
            f"for the record, the eager compaction alone (the parent's route after its "
            f"raw-label kernel) {t_c:.4f} ms")
        if conn == 1:   # the connectivity of the main path
            res["cc_tile_labels"] = dict(max_abs_err=err, ms=t_d, event_ms=t_k, plain_ms=t_p,
                                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, ref, raw
    _cc_structural(torch, dev)
    return res


def _cc_structural(torch, dev, side: int = 1024) -> None:
    """`label_components` on masks that cross every tile, which the plain
    sweeps cannot finish (a geodesic of ~side^2 / 2 pixels): all true, a
    serpentine over the whole frame, random at 0.59 density; labels and
    counts equal to those of `scipy.ndimage.label` on the host."""
    from scipy import ndimage as ndi

    from cell_image_analysis_tpu_torch.ops.cc import label_components

    serpentine = np.zeros((side, side), bool)
    serpentine[::2] = True
    serpentine[1::4, -1] = True
    serpentine[3::4, 0] = True
    rng = np.random.default_rng(5)
    host = np.stack([np.ones((side, side), bool), serpentine,
                     rng.random((side, side)) < 0.59, rng.random((side, side)) < 0.59])
    masks = torch.from_numpy(host).to(dev)
    for conn in (1, 2):
        got, count = label_components(masks, conn)
        got, count = got.cpu().numpy(), count.cpu().numpy()
        for b, name in enumerate(("all-true", "serpentine", "random 0.59 #1", "random 0.59 #2")):
            ref, n = ndi.label(host[b], structure=None if conn == 1 else np.ones((3, 3), bool))
            if count[b] != n or not np.array_equal(got[b], ref):
                raise AssertionError(f"label_components {name} {side}^2, connectivity {conn}: "
                                     f"{int((got[b] != ref).sum())} labels differ, count "
                                     f"{count[b]} vs scipy {n}")
        log(f"[2] label_components on {side}^2 all-true, serpentine and two random 0.59 masks, "
            f"connectivity {conn}: counts {count.tolist()}, equal to scipy.ndimage.label")


class _Recording:
    """Wraps a segment_fn, keeping its flags, its number of calls and the
    last batch's overflow flags."""

    def __init__(self, fn):
        self.fn, self.calls, self.overflow = fn, 0, None
        for flag in ("returns_mask", "returns_overflow", "runs_props"):
            if hasattr(fn, flag):
                setattr(self, flag, getattr(fn, flag))

    def __call__(self, segs):
        self.calls += 1
        out = self.fn(segs)
        if getattr(self.fn, "returns_overflow", False):
            self.overflow = out[1]
        return out


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


def make_frames(torch, dev) -> tuple:
    """The bench's 16 frames (utils/bench._make_frames(16, 1024, 80)):
    (seg channels, green channels), each (16, 1024, 1024) on the card."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    frames = np.stack([make_frame(rng, size=1024, n_cells=80) for _ in range(16)])
    log(f"[3] made 16 frames 1024^2 in {time.perf_counter() - t0:.1f} s (host numpy)")
    return (torch.tensor(frames[..., 2].astype(np.float32), device=dev),
            torch.tensor(frames[..., 1].astype(np.float32), device=dev))


def _kernel_modules():
    from cell_image_analysis_tpu_torch.ops.cuda import cc, clahe_kernel, segsum, winograd

    return {"winograd_conv3x3": winograd, "segment_sum": segsum, "clahe_cells": clahe_kernel,
            "cc_tile_labels": cc}


def _reset_launches() -> None:
    for m in _kernel_modules().values():
        m.LAUNCHES = 0


def _read_launches() -> dict:
    return {name: m.LAUNCHES for name, m in _kernel_modules().items()}


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_main_path(torch, dev, unet_vars, seg_cfg, stage_a, segs, greens,
                    n_buckets: int) -> tuple:
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    backend = _Recording(StarDistBackend(unet_vars, seg_cfg, device=dev))
    model, params = load_scoring_params(device=dev)

    def run():
        return _timed(torch, lambda: score_frames_fused(
            model, params, segs, greens, backend, chunk=32, caps=(64, 96), **stage_a))

    (_, _), t_first = run()
    log(f"[3] first run (warm-up) {t_first:.2f} s")
    _reset_launches()
    (scores, stats), t_run = run()
    launches = _read_launches()
    n_frames = segs.shape[0]
    n = _check_result(scores, stats, n_frames)
    log(f"[3] segmentation overflow flags per frame: "
        f"{backend.overflow.int().tolist()}")
    log(f"[3] cells {n}; rates " + ", ".join(
        f"{k} {scores[f'{k}_anomaly_rate']:.4f}"
        for k in ("conservative", "moderate", "ensemble", "fft")))
    log(f"[3] launches in the timed run: {launches}")
    log(f"[3] timed run: {t_run:.3f} s wall, {n / t_run:.1f} cells/s "
        f"({n_frames / t_run:.2f} frames/s)")
    if bool(backend.overflow.any()):
        raise AssertionError("a segmentation overflow flag is set on the smoke frames")
    missing = [k for k in ("winograd_conv3x3", "segment_sum", "clahe_cells") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the path were not launched: {missing}")
    if launches["clahe_cells"] > n_buckets:
        raise AssertionError(f"[3] {launches['clahe_cells']} CLAHE launches for {n_buckets} "
                             "non-empty size buckets")
    log(f"[3] CLAHE: {launches['clahe_cells']} launches, {n_buckets} non-empty size buckets")
    return launches, (scores, stats), backend.fn


def _screen_threshold(torch, d, segs, greens, params_model, rcap=32, label_route=False,
                      fallback=True):
    """One threshold screening on device d; returns ((scores, stats), the
    fallback's recorder)."""
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    model, params = params_model
    backend = ThresholdBackend()
    twin = _Recording(backend.exact_twin())
    fn = backend.exact_twin() if label_route else backend
    out = score_frames_fused(model, params, segs, greens, fn, rcap=rcap,
                             fallback_segment_fn=twin if fallback else None, **THRESH_KW)
    return out, twin


def phase_gpu_vs_cpu(torch, dev, unet_vars, seg_cfg, stage_a) -> None:
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.utils.parity import boundary_flips, compare_screens

    frame = make_frame(np.random.default_rng(11), size=512, n_cells=25)
    results, labels, thresh = [], [], []
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
        mask_route, twin = _screen_threshold(torch, d, segs, greens, (model, params))
        if twin.calls:
            raise AssertionError(f"[4] threshold mask route overflowed on {d}")
        label_route, _ = _screen_threshold(torch, d, segs, greens, (model, params),
                                           label_route=True, fallback=False)
        thresh.append((mask_route, label_route))
    # the CPU run is the reference; label maps may differ only at knife edges
    flips = {(0, lab): n for lab, n in boundary_flips(
        labels[1], labels[0], det.points[0], det.dists[0], det.keep[0]).items()}
    thr = float(params.ensemble_mse_threshold)
    report = compare_screens(results[1], results[0], flips, thr, tol=TOL)
    log(f"[4] 512^2 frame, StarDist GPU vs CPU: {report['n_cells']} cells, same cell set; "
        f"max score difference {report['max_score_diff']:.3e}; knife-edge cells "
        f"{report['knife_edge_cells']}; within {TOL} of a threshold "
        f"{report['near_threshold']}")
    (gpu_mask, gpu_label), (cpu_mask, cpu_label) = thresh
    for name, ref, got in (("mask route GPU vs CPU", cpu_mask, gpu_mask),
                           ("label route GPU vs CPU", cpu_label, gpu_label),
                           ("GPU mask route vs label route", gpu_label, gpu_mask)):
        report = compare_screens(ref, got, {}, thr, tol=TOL)
        _check_result(*got, 1)
        log(f"[4] 512^2 frame, threshold {name}: {report['n_cells']} cells, same cell set; "
            f"max score difference {report['max_score_diff']:.3e}; within {TOL} of a "
            f"threshold {report['near_threshold']}")


def _assert_same(a: tuple, b: tuple, what: str) -> None:
    """Two (scores, stats) results are identical."""
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            raise AssertionError(f"{what}: different keys")
        for k in x:
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{what}: {k} differs")


def phase_threshold(torch, dev, segs, greens, params_model) -> dict:
    from cell_image_analysis_tpu_torch.utils.parity import compare_screens

    def run(**kw):
        return _timed(torch, lambda: _screen_threshold(torch, dev, segs, greens, params_model,
                                                       **kw))

    def counted(**kw):
        """One run with the launch counts set to 0 just before it and read
        just after."""
        _reset_launches()
        out = run(**kw)
        return out, _read_launches()

    (_, _), t_first = run()
    log(f"[5] (a) mask route, first run (warm-up) {t_first:.2f} s")
    ((res_a, twin_a), t_a), launches_a = counted()
    ((res_b, _), t_b), launches_b = counted(label_route=True, fallback=False)
    ((res_c, twin_c), t_c), launches_c = counted(rcap=8)
    n_frames = segs.shape[0]
    n = _check_result(*res_a, n_frames)
    log(f"[5] (a) mask route + fallback: {n} cells, {n / t_a:.1f} cells/s, {t_a:.3f} s wall "
        f"({n_frames / t_a:.2f} frames/s); fallback calls {twin_a.calls}; "
        f"launches {launches_a}")
    log(f"[5] (b) label route (CC kernel, pixel regionprops): {len(res_b[1]['area'])} cells, "
        f"{t_b:.3f} s wall (one run); launches {launches_b}")
    log(f"[5] (c) mask route at rcap 8: fallback calls {twin_c.calls}, {t_c:.3f} s wall "
        f"(one run, both routes); launches {launches_c}")
    if twin_a.calls != 0:
        raise AssertionError("[5] (a) the mask route overflowed at rcap 32")
    if twin_c.calls != 1:
        raise AssertionError("[5] (c) the fallback did not fire at rcap 8")
    missing = [k for k in ("segment_sum", "clahe_cells") if launches_a[k] <= 0]
    missing += [f"(b) {k}" for k in ("cc_tile_labels", "segment_sum", "clahe_cells")
                if launches_b[k] <= 0]
    if missing:
        raise AssertionError(f"[5] kernels of the threshold path were not launched: {missing}")
    if max(launches_a["clahe_cells"], launches_b["clahe_cells"]) > N_BUCKETS:
        raise AssertionError(f"[5] more CLAHE launches than the {N_BUCKETS} size buckets")
    # the fallback re-runs the whole batch through the label route once
    if launches_c["cc_tile_labels"] != launches_b["cc_tile_labels"]:
        raise AssertionError(f"[5] (c) made {launches_c['cc_tile_labels']} CC calls, the label "
                             f"route {launches_b['cc_tile_labels']}")
    report = compare_screens(res_b, res_a, {}, float(params_model[1].ensemble_mse_threshold),
                             tol=TOL)
    log(f"[5] (a) vs (b): same {report['n_cells']} cells and areas; max score difference "
        f"{report['max_score_diff']:.3e}; within {TOL} of a threshold "
        f"{report['near_threshold']}")
    _assert_same(res_c, res_b, "(c) vs (b)")
    log("[5] (c) equals (b) exactly")
    return launches_a, launches_b


def _clipped_cells(torch, model, seg_cfg, twin_cfg, segs) -> set:
    """(frame, label id) of the cells whose label pixels differ between the
    tiled and the scatter rasterizer.  Each differing pixel must lie outside
    the scatter patch of the polygon that the tiled render gave it: the
    scatter rasterizer clips polygons wider than its patch, and nothing
    else may differ."""
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.ops.rasterize import _compact_and_key

    with torch.inference_mode():
        tiled, det = predict_instances(segs, model, seg_cfg)
        scatter, _ = predict_instances(segs, model, twin_cfg)
    centers, _, keys, keep = _compact_and_key(det.points, det.dists, det.probs, det.keep,
                                              seg_cfg.raster_cap or None)
    diff = torch.nonzero(tiled != scatter)
    if diff.numel() == 0:
        return set()
    b, r, c = diff.T
    lab, lab_s = tiled[b, r, c], scatter[b, r, c]
    slot_labels = torch.where(keep, 0xFFFF - (keys & 0xFFFF), -1)          # (B, K)
    match = slot_labels[b] == lab[:, None]
    if bool((lab == 0).any()) or bool((match.sum(dim=1) != 1).any()):
        raise AssertionError("[6] the scatter render differs where the tiled one drew "
                             "no polygon")
    k = match.int().argmax(dim=1)
    half = twin_cfg.raster_patch // 2
    r0 = torch.round(centers[b, k, 0]).int() - half
    c0 = torch.round(centers[b, k, 1]).int() - half
    inside = ((r >= r0) & (r < r0 + twin_cfg.raster_patch)
              & (c >= c0) & (c < c0 + twin_cfg.raster_patch))
    if bool(inside.any()):
        raise AssertionError(f"[6] {int(inside.sum())} label pixels differ inside their "
                             "polygon's scatter patch")
    pairs = torch.cat([torch.stack([b, lab], 1), torch.stack([b, lab_s], 1)]).tolist()
    return {(f, lb) for f, lb in pairs if lb > 0}


def phase_twin(torch, dev, seg_cfg, stage_a, segs, greens, backend, params_model,
               main_result) -> None:
    import dataclasses

    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.utils.parity import compare_screens

    model, params = params_model
    twin = backend.exact_twin()

    def run(fn, fallback=None):
        return _timed(torch, lambda: score_frames_fused(
            model, params, segs, greens, fn, chunk=32, caps=(64, 96),
            fallback_segment_fn=fallback, **stage_a))

    _reset_launches()
    res_twin, t_twin = run(twin)
    launches = _read_launches()
    n = _check_result(*res_twin, segs.shape[0])
    log(f"[6] exact twin: {n} cells, {t_twin:.3f} s wall (one run), {n / t_twin:.1f} cells/s; "
        f"launches {launches}")
    clipped = _clipped_cells(torch, backend.model, seg_cfg, twin.cfg, segs)
    report = compare_screens(main_result, res_twin, {}, float(params.ensemble_mse_threshold),
                             tol=TOL, exclude=clipped)
    log(f"[6] twin vs phase 3: same {report['n_cells']} cells and areas, max score difference "
        f"{report['max_score_diff']:.3e}; patch-clipped cells left out: {sorted(clipped)}")

    tight = _Recording(StarDistBackend(None, dataclasses.replace(seg_cfg, nms_max_pairs=64),
                                       model=backend.model))
    twin_rec = _Recording(twin)
    res_forced, t_forced = run(tight, fallback=twin_rec)
    if not (bool(tight.overflow.any()) and twin_rec.calls == 1):
        raise AssertionError("[6] the 64-pair NMS budget did not fall back to the twin")
    _assert_same(res_forced, res_twin, "forced fallback vs twin")
    log(f"[6] NMS budget 64 pairs: overflow in frames "
        f"{torch.nonzero(tight.overflow).flatten().tolist()}, fell back to the twin, equal to "
        f"it; {t_forced:.3f} s wall")


def write_frames(folder: str, first: int, n: int, seed: int, mutant_fraction: float,
                 crop, size: int, n_cells: int) -> int:
    """Worker process: frames `first .. first + n - 1` of a sample folder
    (`make_dataset` with its own seed into a scratch folder, renamed),
    cropped to `crop` = (h, w) if given."""
    from cell_image_analysis_tpu_torch.io.tiff import imread, imwrite
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    scratch = f"{folder}.part{first}"
    for i, path in enumerate(make_dataset(scratch, n_frames=n, size=size, n_cells=n_cells,
                                          mutant_fraction=mutant_fraction, seed=seed)):
        target = os.path.join(folder, f"frame_{first + i:03d}.tif")
        if crop is not None:
            imwrite(target, imread(path)[:crop[0], :crop[1]])
        else:
            os.replace(path, target)
    shutil.rmtree(scratch)
    return n


def start_sample_folders(root: str):
    """Start the worker processes that write phase 7's folders under
    `root`; returns (pool, futures, {sample: folder}).  A folder of more
    than CHUNK_FRAMES frames is written in chunks, the k-th with seed
    `seed + 1000 * k`."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(max_workers=max(1, min(6, (os.cpu_count() or 2) - 2)),
                               mp_context=multiprocessing.get_context("spawn"))
    folders, futures = {}, []
    for name, n, seed, mutant, crop in SAMPLES:
        folders[name] = os.path.join(root, name)
        os.makedirs(folders[name])
        for k, first in enumerate(range(0, n, CHUNK_FRAMES)):
            futures.append(pool.submit(write_frames, folders[name], first,
                                       min(CHUNK_FRAMES, n - first), seed + 1000 * k, mutant,
                                       crop, FRAME_SIZE, FRAME_CELLS))
    folders["empty"] = os.path.join(root, "empty")
    os.makedirs(folders["empty"])
    with open(os.path.join(folders["mutantA"], "corrupt.tif"), "wb") as f:
        f.write(b"not a tiff at all")
    return pool, futures, folders


class _HeldAgainstPlain:
    """While active, every call the port makes of a kernel's wrapper is held
    against the kernel's plain version on the same tensors, so each kernel
    is checked at the very shapes and data a path gives it: segment sum,
    CLAHE and connected components bit-equal, Winograd
    max|y - ref| / max|ref| < 1e-5.  The path gets the kernel's result.  The
    plain versions launch no kernel of the port, so the launch counts see
    the path's launches only.  `held` maps a kernel to {input signature:
    calls}."""

    def __init__(self, torch):
        from cell_image_analysis_tpu_torch.models import unet
        from cell_image_analysis_tpu_torch.ops.cuda import cc, clahe_kernel, segsum

        self.torch = torch
        self.held = {"winograd_conv3x3": {}, "segment_sum": {}, "clahe_cells": {},
                     "cc_tile_labels": {}}
        self.max_rel_err = 0.0
        self._targets = ((segsum, "segment_sums_cuda", self._segsum),
                         (clahe_kernel, "clahe_cells_cuda", self._clahe),
                         (cc, "label_components_cuda", self._cc),
                         (unet, "winograd_conv3x3", self._winograd))
        self._real = {}

    def __enter__(self):
        for module, name, checker in self._targets:
            self._real[name] = getattr(module, name)
            setattr(module, name, checker)
        return self

    def __exit__(self, *exc):
        for module, name, _ in self._targets:
            setattr(module, name, self._real[name])

    def _note(self, kernel: str, signature: tuple) -> None:
        self.held[kernel][signature] = self.held[kernel].get(signature, 0) + 1

    def _segsum(self, seg, data, n_seg):
        from cell_image_analysis_tpu_torch.ops.segsum import segment_sums_plain

        got = self._real["segment_sums_cuda"](seg, data, n_seg)
        if not self.torch.equal(got, segment_sums_plain(seg, data, n_seg)):
            raise AssertionError(f"segment_sum {tuple(data.shape)} -> {n_seg} segments differs "
                                 "from its plain version on a path's own table")
        self._note("segment_sum", (tuple(data.shape), n_seg))
        return got

    def _clahe(self, crops, ids, heights, widths, cap, **kw):
        from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells_plain

        got = self._real["clahe_cells_cuda"](crops, ids, heights, widths, cap, **kw)
        idx = ids.long()
        ref = clahe_cells_plain(crops[idx][:, :cap, :cap], heights[idx], widths[idx], **kw)
        if not self.torch.equal(got, ref):
            raise AssertionError(f"clahe_cells, {ids.numel()} of {crops.shape[0]} slots at cap "
                                 f"{cap}: {int((got != ref).sum())} values differ from the "
                                 "plain version on a path's own bucket")
        self._note("clahe_cells", (tuple(crops.shape), cap, kw.get("ns_cap")))
        return got

    def _cc(self, mask, connectivity):
        from cell_image_analysis_tpu_torch.ops.cc import label_components_plain

        got, count = self._real["label_components_cuda"](mask, connectivity)
        ref, ref_count = label_components_plain(mask, connectivity)
        if not (self.torch.equal(got, ref) and self.torch.equal(count, ref_count)):
            raise AssertionError(f"label_components {tuple(mask.shape)}, connectivity "
                                 f"{connectivity}, differs from its plain version")
        self._note("cc_tile_labels", (tuple(mask.shape), connectivity))
        return got, count

    def _winograd(self, x, W, bias=None):
        from cell_image_analysis_tpu_torch.ops.winograd import winograd_conv3x3_plain

        y = self._real["winograd_conv3x3"](x, W, bias)
        ref = winograd_conv3x3_plain(x, W, bias)
        rel = float((y - ref).abs().max()) / float(ref.abs().max())
        if not rel < 1e-5:
            raise AssertionError(f"winograd {tuple(x.shape)} -> {W.shape[-1]}: relative error "
                                 f"{rel:.3e} >= 1e-5 on a path's own activations")
        self.max_rel_err = max(self.max_rel_err, rel)
        self._note("winograd_conv3x3", (tuple(x.shape), W.shape[-1]))
        return y

    def report(self, tag: str, needed: tuple) -> None:
        """Log what was held; fail if a kernel in `needed` was held no time."""
        for kernel, seen in self.held.items():
            if not seen:
                if kernel in needed:
                    raise AssertionError(f"{tag} no call of {kernel} was held against its "
                                         "plain version")
                continue
            shapes = "; ".join(f"{sig} x{n}" for sig, n in sorted(seen.items(), key=str))
            extra = (f", max relative error {self.max_rel_err:.3e} (gate 1e-5)"
                     if kernel == "winograd_conv3x3" else ", bit-equal")
            log(f"{tag} {kernel}: {sum(seen.values())} calls held against the plain version at "
                f"the path's own inputs{extra}: {shapes}")


class _CountedStart:
    """Stands in for `score_frames_fused_start` in the screener's module:
    the same call under `torch.cuda.set_sync_debug_mode("warn")`, counting
    the host waits that the call makes."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls, self.waits, self.where = torch, fn, 0, 0, {}

    def __call__(self, *args, **kwargs):
        torch = self.torch
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = self.fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.calls += 1
        for w in caught:
            if "synchroniz" in str(w.message):
                self.waits += 1
                key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                self.where[key] = self.where.get(key, 0) + 1
        return out


def _per_file_counts(printed: str) -> dict:
    """{sample: [cells of each file]} from the screener's console lines."""
    counts, sample = {}, None
    for line in printed.splitlines():
        if line.startswith("Processing "):
            sample = line[len("Processing "):].rstrip(".")
            counts[sample] = []
        elif sample and ".tif: " in line and line.rstrip().endswith(" cells"):
            counts[sample].append(int(line.split(": ")[1].split()[0]))
    return counts


def phase_screening(torch, dev, unet_vars, folders: dict, out_root: str, figures: bool):
    from cell_image_analysis_tpu_torch.config import OUTPUT_FILES_SCREENING, PipelineConfig
    from cell_image_analysis_tpu_torch.io.ingest import FrameStream, list_tiffs
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.pipeline import screening
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    screener = screening.ProductionMutantScreening(STORE, PipelineConfig(), unet_vars)
    if screener.device.type != dev.type:
        raise AssertionError(f"[7] the screener's default device is {screener.device}")
    out = os.path.join(out_root, "screen_stardist")
    twin = screener._segment_fallback = _Recording(screener._segment_fallback)
    n_batches = sum(-(-n // 16) for _, n, *_ in SAMPLES)   # one shape a folder
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:   # the timed run: nothing of the smoke's stands in the screener's way
        with contextlib.redirect_stdout(printed):
            (results, detailed), t_all = _timed(torch, lambda: screener.screen_mutant_samples(
                folders, out, figures=figures))
    finally:
        log(printed.getvalue().rstrip())
    launches = _read_launches()
    printed = printed.getvalue()
    smi = smi_line()
    meter_line = (f"[7] screening cells/s (ThroughputMeter, {screener.meter.items} cells, "
                  f"{screener.meter.seconds:.3f} s): {screener.meter.rate:.1f} [{smi}]")
    timer_line = f"[7] {screener.timer.report().replace(chr(10), ' |')} [{smi}]"
    decode_line = (f"[7] TIFF decode seconds, summed over the ingest workers: "
                   f"{screener.decode_seconds:.3f} [{smi}]")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fallback_runs = twin.calls

    if set(results) != {"wildtype", "mutantA", "odd"}:
        raise AssertionError(f"[7] samples with results: {sorted(results)}")
    for needle in ("No .tif files found", "Error processing", "corrupt.tif"):
        if needle not in printed:
            raise AssertionError(f"[7] {needle!r} was not printed")
    for name in OUTPUT_FILES_SCREENING:
        if name.endswith(".png") and not figures:
            continue
        if not os.path.getsize(os.path.join(out, name)) > 0:
            raise AssertionError(f"[7] output file {name} is empty")
    log(f"[7] output files present: {'all of' if figures else 'the CSVs and the report of'} "
        f"OUTPUT_FILES_SCREENING ({'figures asserted' if figures else 'no matplotlib: figures not asserted'})")
    per_file = _per_file_counts(printed)
    for name, n_files, *_ in SAMPLES:
        if len(per_file[name]) != n_files or sum(per_file[name]) != results[name]["total_cells"]:
            raise AssertionError(f"[7] {name}: per-file counts {per_file[name]} vs total "
                                 f"{results[name]['total_cells']}")
        if results[name]["total_cells"] < 10 * n_files:
            raise AssertionError(f"[7] {name}: only {results[name]['total_cells']} cells")
    missing = [k for k in ("winograd_conv3x3", "segment_sum", "clahe_cells") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"[7] kernels of the screening path were not launched: {missing}")
    for k in ("mse", "conservative_score", "moderate_score"):
        if not np.all(np.isfinite([row[k] for row in detailed])):
            raise AssertionError(f"[7] non-finite {k}")

    # wildtype again through the in-flight path, and directly: the same
    # decoded frames in the same batches through score_frames_fused
    # (that second pass, not the timed run, counts the host waits in _start)
    files = list_tiffs(folders["wildtype"])
    counted = _CountedStart(torch, screening.score_frames_fused_start)
    screening.score_frames_fused_start = counted
    try:
        merged, counts, _ = screener._score_sample_frames(files)
    finally:
        screening.score_frames_fused_start = counted.fn

    def direct_batches(folder: str) -> tuple:
        """A folder's decoded frames, the `score_frames_fused` result of each
        batch of 16 with the screener's own arguments, and the last batch's
        seg channels on the card."""
        frames = [(seg, green) for _, seg, green in FrameStream(list_tiffs(folder))]
        out = []
        for at in range(0, len(frames), 16):
            segs = screener.frames_to_device([f[0] for f in frames[at:at + 16]])
            greens = screener.frames_to_device([f[1] for f in frames[at:at + 16]])
            seg_fn, kwargs = screener.fused_arguments(*segs.shape[1:])
            out.append(score_frames_fused(screener.model, screener.scoring_params, segs,
                                          greens, seg_fn, **kwargs))
        return frames, out, segs

    # The direct calls run with every kernel call held against its plain
    # version: the screener's own shapes (16 x 512 crop slots, label capacity
    # 1024, B = 16, 8 and 2, 1004 x 1020 frames padded to 1008 x 1024) on
    # both the main route and the exact twin that every overflow re-runs
    # through (its pixel-regionprops table, its crops).
    with _HeldAgainstPlain(torch) as held:
        frames, direct, segs = direct_batches(folders["wildtype"])
        _, odd_direct, _ = direct_batches(folders["odd"])
    held.report("[7]", needed=("winograd_conv3x3", "segment_sum", "clahe_cells"))
    if len(odd_direct[0][1]["area"]) != results["odd"]["total_cells"]:
        raise AssertionError("[7] odd: the held direct call found other cells than the screener")
    if SAMPLES[0][:2] == ("wildtype", 40) and [len(st["frame_index"]) > 0 for _, st in direct] \
            != [True] * 3:
        raise AssertionError("[7] wildtype did not make three batches with cells")
    for k, v in merged.items():
        if k.endswith("_anomaly_rate") or k == "_frame_names":
            continue
        if not np.array_equal(v, np.concatenate([s[k] for s, _ in direct])):
            raise AssertionError(f"[7] wildtype {k}: the screener differs from direct "
                                 "score_frames_fused calls")
    direct_counts = []
    for (_, st), at in zip(direct, range(0, len(frames), 16)):
        direct_counts += [int((st["frame_index"] == i).sum())
                          for i in range(len(frames[at:at + 16]))]
    if counts != direct_counts or counts != per_file["wildtype"]:
        raise AssertionError("[7] wildtype per-file counts differ between the screener and "
                             "direct calls")
    rows = [r for r in detailed if r["sample_name"] == "wildtype"]
    if [r["mse"] for r in rows] != [float(v) for v in merged["reconstruction_mse"]]:
        raise AssertionError("[7] wildtype: the report's rows differ from a second screening")
    n_cells = sum(r["total_cells"] for r in results.values())
    log(f"[7] wildtype: {len(rows)} cells in {len(direct)} batches; every score array and "
        "the per-file counts equal, bit for bit, direct score_frames_fused calls on the same "
        "decoded frames")
    log("[7] rates: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {r[f'{k}_anomaly_rate']:.4f}"
                               for k in ("conservative", "moderate", "ensemble", "fft"))
        for name, r in results.items()))
    log(f"[7] launches while screening: {launches}; peak device memory {peak_gib:.2f} GiB")
    with torch.inference_mode():
        _, det = predict_instances(segs, screener._segment.model, screener._segment.cfg)
    log(f"[7] batches that re-ran through the exact twin: {fallback_runs} of {n_batches}; "
        f"overflow flags of wildtype's last batch ({segs.shape[0]} frames): NMS pair budget "
        f"{int(det.nms_overflow.sum())}, raster tile cap {int(det.raster_overflow.sum())}, "
        f"candidate cap {int(det.cand_overflow.sum())}")
    log(meter_line)
    log(f"[7] screen_mutant_samples wall (reports included): {t_all:.3f} s, {n_cells} cells "
        f"[{smi}]")
    log(timer_line)
    log(f"[7] host waits inside score_frames_fused_start (counted in a second pass over "
        f"wildtype, not in the timed run): {counted.waits} in {counted.calls} calls, at "
        f"{counted.where} [{smi}]")
    log(decode_line)
    return launches


def _cells_close(got, ref, what: str, allowed: int) -> None:
    """Two `extract_quality_cells` results: the same number of cells; cells
    of equal area within TOL; at most `allowed` cells whose area differs
    (label pixels at a polygon's knife edge)."""
    (cells, stats), (cells_c, stats_c) = got, ref
    if len(cells) != len(cells_c) or len(cells) < 10:
        raise AssertionError(f"[8] {what}: {len(cells)} cells on the card, {len(cells_c)} "
                             "on the CPU")
    same = np.array([a["area"] == b["area"] for a, b in zip(stats, stats_c)])
    worst = float(np.abs(cells[same] - cells_c[same]).max())
    log(f"[8] extract_quality_cells, {what}: {len(cells)} cells on the card and on the CPU, "
        f"max difference {worst:.3e}; cells whose area differs: {int((~same).sum())}")
    if worst > TOL or int((~same).sum()) > allowed:
        raise AssertionError(f"[8] {what}: the card's cells differ from the CPU's")


def phase_threshold_screener(torch, dev, unet_vars, folders: dict, out_root: str,
                             figures: bool) -> None:
    import dataclasses

    from cell_image_analysis_tpu_torch.config import PipelineConfig, SegConfig
    from cell_image_analysis_tpu_torch.io.ingest import list_tiffs, split_channels
    from cell_image_analysis_tpu_torch.io.tiff import imread
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening

    files = list_tiffs(folders["wildtype"])[:16]
    cut = os.path.join(out_root, "wildtype16")
    os.makedirs(cut)
    for path in files:
        os.link(path, os.path.join(cut, os.path.basename(path)))
    cfg = dataclasses.replace(PipelineConfig(), seg=SegConfig(backend="threshold"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        screener = ProductionMutantScreening(STORE, cfg)
        cpu = ProductionMutantScreening(STORE, cfg, device="cpu")
    _reset_launches()
    with contextlib.redirect_stdout(printed):
        (results, _), t_all = _timed(torch, lambda: screener.screen_mutant_samples(
            {"wildtype": cut}, os.path.join(out_root, "screen_threshold"), figures=figures))
    launches = _read_launches()
    r = results["wildtype"]
    if r["total_cells"] < 10 * len(files) or sum(_per_file_counts(printed.getvalue())["wildtype"]) \
            != r["total_cells"]:
        raise AssertionError(f"[8] threshold screener: {r['total_cells']} cells")
    if launches["segment_sum"] <= 0 or launches["clahe_cells"] <= 0:
        raise AssertionError(f"[8] threshold screener launched {launches}")
    log(f"[8] threshold screener, {len(files)} frames: {r['total_cells']} cells, "
        f"{screener.meter.rate:.1f} cells/s, {t_all:.3f} s wall with reports; rates "
        f"conservative {r['conservative_anomaly_rate']:.4f}, moderate "
        f"{r['moderate_anomaly_rate']:.4f}; launches {launches} [{smi_line()}]")

    # the same 16 frames once more, directly, and one frame through
    # extract_quality_cells, with every kernel call held against its plain
    # version: the mask route's run table and crops at the screener's
    # capacities, the CC kernel and the pixel regionprops of the label route
    decoded = [split_channels(imread(path)) for path in files]
    seg, green = decoded[0]
    seg_fn, kwargs = screener.fused_arguments(*seg.shape)
    with _HeldAgainstPlain(torch) as held:
        direct = score_frames_fused(screener.model, screener.scoring_params,
                                    screener.frames_to_device([d[0] for d in decoded]),
                                    screener.frames_to_device([d[1] for d in decoded]),
                                    seg_fn, **kwargs)
        _reset_launches()
        got = screener.extract_quality_cells(seg, green)
    launches = _read_launches()
    held.report("[8]", needed=("segment_sum", "clahe_cells", "cc_tile_labels"))
    if len(direct[1]["area"]) != r["total_cells"]:
        raise AssertionError("[8] the held direct call found other cells than the screener")
    if launches["cc_tile_labels"] <= 0 or launches["clahe_cells"] <= 0:
        raise AssertionError(f"[8] extract_quality_cells (threshold) launched {launches}")
    _cells_close(got, cpu.extract_quality_cells(seg, green),
                 f"threshold backend (launches {launches})", allowed=0)
    with contextlib.redirect_stdout(io.StringIO()):
        star = ProductionMutantScreening(STORE, PipelineConfig(), unet_vars)
        star_cpu = ProductionMutantScreening(STORE, PipelineConfig(), unet_vars, device="cpu")
    _reset_launches()
    with _HeldAgainstPlain(torch) as held:
        got = star.extract_quality_cells(seg, green)
    launches = _read_launches()
    held.report("[8] StarDist extract_quality_cells,",
                needed=("winograd_conv3x3", "segment_sum", "clahe_cells"))
    if launches["winograd_conv3x3"] <= 0 or launches["segment_sum"] <= 0:
        raise AssertionError(f"[8] extract_quality_cells (StarDist) launched {launches}")
    _cells_close(got, star_cpu.extract_quality_cells(seg, green),
                 f"StarDist backend (launches {launches})", allowed=2)
    scores = star.compute_anomaly_scores(got[0])
    if scores["reconstruction_mse"].shape != (len(got[0]),) or not np.all(
            np.isfinite(scores["conservative_scores"])):
        raise AssertionError("[8] compute_anomaly_scores: bad shape or non-finite values")
    log(f"[8] compute_anomaly_scores on those {len(got[0])} cells: conservative rate "
        f"{scores['conservative_anomaly_rate']:.4f}, ensemble {scores['ensemble_anomaly_rate']:.4f}")


def phase_cli(folders: dict, out_root: str, figures: bool) -> None:
    out = os.path.join(out_root, "cli")
    base = [sys.executable, "-m", "cell_image_analysis_tpu_torch.cli", "screen", "--sample",
            f"mutantA={folders['mutantA']}", *([] if figures else ["--no-figures"])]
    t0 = time.perf_counter()
    done = subprocess.run([*base, "--models", STORE, "--output", out], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0 or not os.path.exists(os.path.join(out, "screening_summary.csv")):
        raise AssertionError(f"[9] cli screen exited {done.returncode}:\n{done.stdout[-2000:]}\n"
                             f"{done.stderr[-2000:]}")
    summary = done.stdout.split("QUICK SUMMARY:")[1].strip().splitlines()[-1]
    log(f"[9] cli screen on mutantA: exit 0 in {time.perf_counter() - t0:.1f} s, summary CSV "
        f"present; {summary}")
    bad = subprocess.run([*base, "--models", os.path.join(out_root, "no_such_models"),
                          "--output", os.path.join(out_root, "cli_bad")], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if bad.returncode == 0:
        raise AssertionError("[9] cli screen with a missing model directory exited 0")
    log(f"[9] cli screen with a missing model directory: exit {bad.returncode} "
        f"({bad.stderr.strip().splitlines()[-1][:120]})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(str(p) for p in sorted(ALL_PHASES)),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables

    dev = torch.device("cuda", 0)
    seg_cfg = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
    stage_a = dict(label_capacity=128, cell_capacity=128, rcap=32)
    unet_vars = load_unet_variables()

    if 0 in phases:
        phase_env(torch)
    figures = importlib.util.find_spec("matplotlib") is not None
    log("[0] report packages: " + ", ".join(
        f"{m} {'importable' if importlib.util.find_spec(m) else 'not installed'}"
        for m in ("pandas", "matplotlib", "seaborn")))
    tmp_root = tempfile.mkdtemp(prefix="chip_smoke_")
    pool = None
    try:
        if phases & {7, 8, 9}:
            # the sample folders are written while phases 1-3 run
            pool, futures, folders = start_sample_folders(tmp_root)
        if 1 in phases:
            phase_build()
        segs = greens = main_a = None
        if phases & {2, 3, 5, 6}:
            segs, greens = make_frames(torch, dev)
        if phases & {2, 3}:
            from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend

            stardist = StarDistBackend(unet_vars, seg_cfg, device=dev)
            main_a = stage_a_buckets(torch, stardist, segs, greens, stage_a)
            main_a.update(labels=stardist(segs)[0], segs=segs)   # segment sum's input
        kernels = {}
        if 2 in phases:
            from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend

            thresh_a = stage_a_buckets(torch, ThresholdBackend(), segs, greens, dict(
                {k: v for k, v in THRESH_KW.items() if k not in ("chunk", "caps")}, rcap=32))
            kernels = phase_kernels(torch, dev, unet_vars, main_a, thresh_a)
            del thresh_a
        launches, main_result, backend = {}, None, None
        if 3 in phases:
            n_buckets = sum(1 for ids, _, _ in main_a["buckets"] if ids.numel())
            launches, main_result, backend = phase_main_path(torch, dev, unet_vars, seg_cfg,
                                                             stage_a, segs, greens, n_buckets)
        if 4 in phases:
            phase_gpu_vs_cpu(torch, dev, unet_vars, seg_cfg, stage_a)
        params_model = load_scoring_params(device=dev)
        if 5 in phases:
            launches_a, launches_b = phase_threshold(torch, dev, segs, greens, params_model)
            launches["cc_tile_labels"] = launches_b["cc_tile_labels"]
            if 2 in phases:
                kernels["clahe_cells"]["threshold_launches"] = launches_a["clahe_cells"]
        if 6 in phases and 3 in phases:
            phase_twin(torch, dev, seg_cfg, stage_a, segs, greens, backend, params_model,
                       main_result)
        del segs, greens, main_a, main_result
        torch.cuda.empty_cache()
        screening_launches = {}
        if pool is not None:
            t0 = time.perf_counter()
            n_written = sum(f.result() for f in futures)
            log(f"[7] {n_written} frames in {sorted(folders)} were written by worker "
                f"processes; waited {time.perf_counter() - t0:.1f} s more for them")
        if 7 in phases:
            screening_launches = phase_screening(torch, dev, unet_vars, folders, tmp_root,
                                                 figures)
        if 8 in phases:
            phase_threshold_screener(torch, dev, unet_vars, folders, tmp_root, figures)
        if 9 in phases:
            phase_cli(folders, tmp_root, figures)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp_root, ignore_errors=True)
    if phases != ALL_PHASES:
        log(f"partial run (phases {sorted(phases)}): no result line")
        return 1

    meta = {
        "winograd_conv3x3": ("csrc/winograd_conv3x3.cu",
                             "cell_image_analysis_tpu/ops/pallas/winograd.py:184"),
        "segment_sum": ("csrc/segment_sum.cu",
                        "cell_image_analysis_tpu/ops/pallas/segsum.py:49"),
        "clahe_cells": ("csrc/clahe_cells.cu",
                        "cell_image_analysis_tpu/ops/pallas/clahe_kernel.py:184"),
        "cc_tile_labels": ("csrc/cc_tile_labels.cu",
                           "cell_image_analysis_tpu/ops/pallas/cc_kernel.py:80"),
    }
    # `launches`: wrapper calls in one batch of 16 frames, phase 3 (CC:
    # phase 5 (b), the label route); `launches_per_batch`: the kernel
    # launches on the card they make (a CC call is the module's
    # KERNELS_PER_CALL); `screening_launches`: wrapper calls while phase 7
    # screened its folders; `ms` is the
    # kernel's device time (torch.profiler), `event_ms` one event-timed
    # wrapper call; CLAHE's `threshold_*`: the threshold path, phase 5 (a)
    modules = _kernel_modules()
    rows = [dict(name=name, route="cuda", source=f"{PKG}/{src}", replaces=rep,
                 launches=launches[name],
                 launches_per_batch=launches[name] * getattr(modules[name], "KERNELS_PER_CALL", 1),
                 screening_launches=screening_launches[name],
                 **kernels[name])
            for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
