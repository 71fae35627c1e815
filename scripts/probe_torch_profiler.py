"""Which torch.profiler sessions see the card's activity, in one process.

    python3 scripts/probe_torch_profiler.py sum:1,wino:5,seg:20,wino:5

Each comma-separated item is one profiler session of `op` called n times
after one warm-up call (ops: `sum`, a 1M-element reduction; `mm`, a 2048^2
matmul; `seg`, the segment-sum kernel; `wino`, the Winograd kernel on a
(1, 512, 512, 32 -> 32) input; the last two build the port's kernels
first).  Prints, for each session, its event count and the device
microseconds of each event name that has any: a session without device
activity shows an empty dict.  Run it in a fresh process on the card, with
and without `TEARDOWN_CUPTI=0`, to see whether a sequence of sessions keeps
the device in view (chip_smoke.py takes all its profiler times in phase 2
for that reason).
"""

from __future__ import annotations

import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def session(fn, n: int) -> tuple:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = {e.key[:40]: round(e.self_device_time_total, 1) for e in prof.key_averages()
              if e.self_device_time_total > 0}
    return device, len(prof.events())


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_profiler: no CUDA device", file=sys.stderr)
        return 1
    plan = [(op, int(n)) for op, n in (item.split(":") for item in sys.argv[1].split(","))]
    x = torch.ones(1 << 20, device="cuda")
    a = torch.randn(2048, 2048, device="cuda")
    ops = {"sum": lambda: x.sum(), "mm": lambda: a @ a}
    if any(op in ("seg", "wino") for op, _ in plan):
        from cell_image_analysis_tpu_torch.ops.cuda import _build
        from cell_image_analysis_tpu_torch.ops.cuda.segsum import segment_sums_cuda
        from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
        from cell_image_analysis_tpu_torch.ops.winograd import pad_input, winograd_operands

        _build.build(verbose=False)
        _build.library()
        seg = torch.randint(0, 1000, (1 << 19,), device="cuda", dtype=torch.int32)
        data = torch.randint(0, 100, (1 << 19, 6), device="cuda", dtype=torch.int64)
        w, b = torch.randn(3, 3, 32, 32, device="cuda"), torch.randn(32, device="cuda")
        xw = pad_input(torch.relu(torch.randn(1, 512, 512, 32, device="cuda")))
        operands = winograd_operands(w, b)
        ops["seg"] = lambda: segment_sums_cuda(seg, data, 1000)
        ops["wino"] = lambda: winograd_conv3x3_cuda(xw, *operands)
    lines = []
    for i, (op, n) in enumerate(plan):
        device, n_events = session(ops[op], n)
        lines.append(f"{i}:{op}:{n} events {n_events} device {device}")
    print(f"[{sys.argv[1]}] TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')} :: "
          + " | ".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
