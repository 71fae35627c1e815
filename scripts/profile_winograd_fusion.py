#!/usr/bin/env python3
"""Device time of the networks' forwards with the activations fused into the
Winograd kernel, against the same forwards with them as PyTorch passes.

    python3 scripts/profile_winograd_fusion.py [--tiles 576] [--frames 16] [--reps 3]

On one GPU: CPnet at cyto3's widths (random weights, BatchNorm statistics
drawn) on `--tiles` tiles of 224^2, and the StarDist U-Net of
`benchmark/data/unet_synthetic.pkl` on `--frames` frames of 1024^2.  Each
forward runs two ways without grad, in turns: fused (the BatchNorm, style
and ReLU as the kernel's input prologue in CPnet; the ReLU as its output
epilogue in StarDist) and unfused (`ops.winograd.winograd_conv3x3`
replaced by a stand-in that runs the activation as PyTorch passes,
`activate_input` or `torch.relu_`, around the plain kernel instance).  Prints, a forward: the device ms by kernel
(torch.profiler; the Winograd instances and the largest others), the peak
memory, and how far the outputs part (CPnet: max |a - b| / max |b|;
StarDist: bit for bit).  It imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_ms_by_kernel(torch, fn, reps: int) -> tuple:
    """({kernel name: device ms a call}, device ms a call) of `fn()` under
    torch.profiler, `reps` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = defaultdict(float)
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by[e.name] += e.device_time_total / 1e3 / reps
    return dict(by), sum(by.values())


def report(tag: str, by: dict, total: float, peak: float, top: int = 8) -> None:
    wino = sum(t for n, t in by.items() if "winograd_kernel" in n)
    print(f"{tag}: device {total:.3f} ms a forward, winograd_kernel {wino:.3f} ms, "
          f"peak {peak:.3f} GiB", flush=True)
    for name, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {t:9.3f} ms  {name[:110]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=576)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables, unet_state_from_jax
    from cell_image_analysis_tpu_torch.models import cellpose as cp
    from cell_image_analysis_tpu_torch.models.unet import StarDistUNet
    from cell_image_analysis_tpu_torch.ops import winograd

    if not torch.cuda.is_available():
        print("profile_winograd_fusion: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    model = cp.init_cpnet(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, cp._BC):
                c = m.bn_mean.shape[0]
                m.bn_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.bn_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.bn_weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bn_bias.copy_(torch.randn(c, generator=g) * 0.1)
    model = model.to(dev).eval().requires_grad_(False)
    tiles = torch.zeros((args.tiles, 224, 224, 2), device=dev)
    tiles[..., 0] = torch.rand((args.tiles, 224, 224), generator=g).to(dev)

    unet = StarDistUNet()
    unet.load_state_dict(unet_state_from_jax(load_unet_variables(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark", "data",
        "unet_synthetic.pkl"))))
    unet = unet.to(dev).requires_grad_(False)
    frames = torch.rand((args.frames, 1024, 1024, 1), generator=g).to(dev)

    fused_op = winograd.winograd_conv3x3

    def unfused_op(x, W, bias=None, *, in_scale=None, in_shift=None, out_relu=False):
        if in_scale is not None:
            x = winograd.activate_input(x, in_scale, in_shift)
        y = fused_op(x, W, bias)
        return torch.relu_(y) if out_relu else y

    for name, net, x in (("cpnet", model, tiles), ("stardist", unet, frames)):
        outs = {}
        for route in ("fused", "unfused", "unfused", "fused"):
            op = fused_op if route == "fused" else unfused_op

            def fwd():
                winograd.winograd_conv3x3 = op
                try:
                    with torch.no_grad():
                        return net(x)
                finally:
                    winograd.winograd_conv3x3 = fused_op

            torch.cuda.reset_peak_memory_stats(dev)
            by, total = device_ms_by_kernel(torch, fwd, args.reps)
            report(f"{name} {route}", by, total, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            outs[route] = fwd()
        a, b = outs["fused"], outs["unfused"]
        if name == "cpnet":
            rel = float((a - b).abs().max()) / float(b.abs().max())
            print(f"cpnet fused vs unfused: max |a - b| / max |b| = {rel:.3e}", flush=True)
        else:
            same = all(torch.equal(p, q) for p, q in zip(a, b))
            print(f"stardist fused vs unfused: bit for bit {same}", flush=True)
        del outs, a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
