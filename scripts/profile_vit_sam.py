#!/usr/bin/env python3
"""Time Cellpose-SAM's network on the card: the fused attention kernel
(`csrc/vit_attention.cu`) against the plain materialised form on one
block's worth of heads, the linear kernel (`csrc/vit_linear.cu`) against
cuBLAS float32 at one block's four linears, and the whole ViT-L forward
over a batch of 256^2 tiles, with its device time by kernel
(torch.profiler).

    python scripts/profile_vit_sam.py [--tiles 100] [--weights NPZ] [--out JSON]

Random weights (`init_vit_sam`) unless `--weights` names a Cellpose-SAM
file.  Prints one JSON object: the card, the attention's device ms fused
and plain with the fused one's error against the plain form and its
least time (`benchmark/backends/cellpose_sam/counts.attention_work`'s
rule for one call); for each of qkv, proj, lin1 and lin2 at the batch's
rows (random x, W x 0.02 and bias) the kernel's and cuBLAS float32's ms
(median of `--reps` event-timed calls) and max |error| against the
product in float64 over the largest output, with the 3xTF32 bound (3 x
2MNK at 495 TFLOP/s); the forward's ms, its top device ops, the peak
memory.  Needs a GPU.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cell_image_analysis_tpu_torch.io.artifacts import load_cellpose_weights  # noqa: E402
from cell_image_analysis_tpu_torch.models import vit_sam  # noqa: E402
from cell_image_analysis_tpu_torch.ops.cuda import _build  # noqa: E402
from cell_image_analysis_tpu_torch.ops.vit_attention import (  # noqa: E402
    vit_attention,
    vit_attention_plain,
)
from cell_image_analysis_tpu_torch.ops.vit_linear import vit_linear  # noqa: E402

LINEARS = {"qkv": (1024, 3072), "proj": (1024, 1024), "lin1": (1024, 4096),
           "lin2": (4096, 1024)}                       # (K, N)


def event_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=100)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_vit_sam.py: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    res = {"card": card, "build_s": round(time.perf_counter() - t0, 1), "tiles": args.tiles}

    # one block's attention at the batch's heads
    bh = args.tiles * 16
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(bh, 1024, 64, generator=g, device=dev) for _ in range(3))
    rel_h, rel_w = (torch.randn(bh, 1024, 32, generator=g, device=dev) for _ in range(2))
    with torch.inference_mode():
        fused = vit_attention(q, k, v, rel_h, rel_w, 0.125)
        plain = vit_attention_plain(q, k, v, rel_h, rel_w, 0.125)
        res["attention_rel_err"] = ((fused - plain).abs().max() / plain.abs().max()).item()
        del fused, plain
        res["attention_fused_ms"] = event_ms(
            lambda: vit_attention(q, k, v, rel_h, rel_w, 0.125), args.reps)
        res["attention_plain_ms"] = event_ms(
            lambda: vit_attention_plain(q, k, v, rel_h, rel_w, 0.125), args.reps)
    flops = args.tiles * (4.0 * 16 * 1024 ** 2 * 64 + 2.0 * 16 * 1024 ** 2)
    nbytes = 4.0 * args.tiles * 16 * 1024 * (4 * 64 + 64)
    res["attention_bound_ms"] = 1e3 * max(flops / 495e12, nbytes / 3.35e12)
    del q, k, v, rel_h, rel_w

    # one block's four linears at the batch's rows
    M = args.tiles * 1024
    for name, (K, N) in LINEARS.items():
        x = torch.randn(M, K, generator=g, device=dev)
        w = torch.randn(N, K, generator=g, device=dev) * 0.02
        b = torch.randn(N, generator=g, device=dev) * 0.1
        with torch.inference_mode():
            ref = torch.nn.functional.linear(x.double(), w.double(), b.double())
            top = ref.abs().max()
            row = {"kernel_err": float((vit_linear(x, w, b).double() - ref).abs().max() / top),
                   "cublas_err": float((torch.nn.functional.linear(x, w, b).double() - ref)
                                       .abs().max() / top)}
            del ref
            row["kernel_ms"] = statistics.median(event_ms(lambda: vit_linear(x, w, b), args.reps))
            row["cublas_ms"] = statistics.median(
                event_ms(lambda: torch.nn.functional.linear(x, w, b), args.reps))
        row["bound_ms"] = 3 * 2.0 * M * N * K / 495e12 * 1e3
        res[f"linear_{name}"] = row
        del x, w, b

    # the whole network
    if args.weights:
        net = vit_sam.build_vit_sam(load_cellpose_weights(args.weights), dev)
    else:
        net = vit_sam.init_vit_sam(0).to(dev).eval()
    x = torch.rand(args.tiles, 256, 256, 3, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        net(x)
        res["forward_ms"] = event_ms(lambda: net(x), args.reps)
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t > 0:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    res["device_ms_total"] = sum(r[1] for r in rows)
    res["top_ops"] = [[n[:90], round(ms, 3), c] for n, ms, c in rows[:15]]
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
