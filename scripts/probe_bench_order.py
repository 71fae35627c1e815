#!/usr/bin/env python3
"""Does the CAE train bench depend on what ran before it in its process?

    python3 scripts/probe_bench_order.py [--frames 8]

On one GPU, in one fresh process: `utils/bench.run_train_bench` first;
then the screening bench (`run_bench`, threshold, on `--frames` frames of
1024^2); the train bench again; again after `torch.cuda.empty_cache()`;
and again after `gc.collect()`.  Prints each JSON line with its cells/s,
the device's allocated and reserved memory, and the `nvidia-smi` name and
power limit.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    import torch

    from cell_image_analysis_tpu_torch.utils import bench

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def train(tag: str) -> None:
        report = {}
        line = bench.run_train_bench(device=dev, report=report)
        print(f"{tag}: {line}; {report['seconds']:.3f} s, {report['epochs']} epochs; allocated "
              f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB, reserved "
              f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.3f} GiB [{smi}]", flush=True)

    train("train bench, first in the process")
    frames = bench._make_frames(args.frames, 1024, 80)
    report = {}
    print(f"screening bench, threshold, {args.frames} frames: "
          f"{bench.run_bench(n_frames=args.frames, backend='threshold', device=dev, frames=frames, report=report)}; "
          f"peak {report['peak_gib']:.3f} GiB [{smi}]", flush=True)
    train("train bench, after the screening bench")
    torch.cuda.empty_cache()
    train("train bench, after torch.cuda.empty_cache()")
    del frames
    gc.collect()
    train("train bench, after gc.collect()")
    print(json.dumps({"gc_counts": gc.get_count(), "gc_objects": len(gc.get_objects())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
