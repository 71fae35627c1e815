#!/usr/bin/env python3
"""Time the port's U-Net training step on one GPU and show where it goes.

    python3 scripts/profile_torch_unet_training.py [--frames 8] [--size 256] [--steps 20]

Makes the dense synthetic training set of `scripts/make_unet_weights_torch.py`
(`train.unet_trainer.synthetic_training_set`, its host ground truth timed),
then times `unet_train_step` at full width (event-timed, median of
`--steps`) two ways in turns, twice each: the port's route (3x3 convs and
their data gradients through the Winograd kernel, `WinogradConv3x3Fn`) and
the plain route (every 3x3 conv `F.conv2d` under autograd: cuDNN fp32
forward and both gradients).  Then one profiled run of `--steps` steps on
the port's route: device time a step by group (the Winograd kernel; the
kernels under `aten::convolution_backward`, cuDNN's weight gradient;
those under the optimizer's step; the rest), the kernel launches a step
and the top kernels.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cell_image_analysis_tpu_torch.models.unet import init_unet
    from cell_image_analysis_tpu_torch.ops import winograd
    from cell_image_analysis_tpu_torch.train import unet_trainer as ut

    if not torch.cuda.is_available():
        print("profile_torch_unet_training: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    frames, labels = ut.synthetic_training_set(args.frames, args.size, dense=True)
    t0 = time.perf_counter()
    batch = ut.training_tensors(frames, labels, device="cuda")
    print(f"host ground truth of {args.frames} frames of {args.size}^2: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    real = winograd.winograd_conv3x3

    def plain_route(x, W, bias=None, **act):
        return winograd.winograd_conv3x3_plain(x, W, bias, **act)

    def timed_steps(route) -> float:
        winograd.winograd_conv3x3 = route
        try:
            model = init_unet(0, device="cuda")
            opt = ut.make_unet_optimizer(model, 3e-3)
            for _ in range(3):
                ut.unet_train_step(model, opt, batch)
            times = []
            for _ in range(args.steps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                ut.unet_train_step(model, opt, batch)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)
        finally:
            winograd.winograd_conv3x3 = real

    runs = {"winograd": [], "plain": []}
    for name in ("winograd", "plain", "plain", "winograd"):
        runs[name].append(timed_steps(real if name == "winograd" else plain_route))
    for name, ms in runs.items():
        print(f"{name} route: {', '.join(f'{m:.3f}' for m in ms)} ms a step "
              f"({', '.join(f'{args.frames / m * 1e3:.1f}' for m in ms)} images/s) "
              f"[{smi}]", flush=True)

    model = init_unet(0, device="cuda")
    opt = ut.make_unet_optimizer(model, 3e-3)
    for _ in range(3):
        ut.unet_train_step(model, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            ut.unet_train_step(model, opt, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.self_device_time_total > 0]
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    cpu_ops = {e.key: e for e in events if e.device_type == DeviceType.CPU}

    def under(prefix: str) -> float:
        """Device ms of the kernels that CPU ops named `prefix...` launched."""
        return sum(e.device_time_total for k, e in cpu_ops.items() if k.startswith(prefix)) / 1e3

    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {
        "winograd kernel (13 forward + 12 dx calls)": sum(
            e.self_device_time_total for e in kernels if "winograd_kernel" in e.key) / 1e3,
        "cuDNN weight gradient (aten::convolution_backward)": under("aten::convolution_backward"),
        "Adam (OptaxAdam.step)": under("Optimizer.step"),
    }
    groups["the rest"] = device_ms - sum(groups.values())
    print(f"profiled {args.steps} steps: device {device_ms / args.steps:.3f} ms a step (wall "
          f"{wall_ms / args.steps:.3f} ms under the profiler), "
          f"{launches / args.steps:.0f} kernel launches a step", flush=True)
    for name, t in groups.items():
        print(f"  {name}: {t / args.steps:.3f} ms a step", flush=True)
    print("top kernels by device time (ms a step, launches a step):", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:8.3f}  "
              f"{e.count / args.steps:6.1f}  {e.key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
