#!/usr/bin/env python3
"""Train the port's Cellpose network (cyto3's CPnet, nbase 2-32-64-128-256)
on synthetic frames and write its weights for the benchmark.

The frames are `utils.synthetic.make_frame_instances` (the generator the
benchmark's traffic copies: short radius 9-16 px, aspect 1-1.8) with their
true instance labels, `--frames` of `--size`^2 from `default_rng(--seed)`;
the targets are the labels' heat-diffusion flows and cell masks;
`train.cellpose_trainer.fit_cpnet` runs `--steps` AdamW steps of
`--batch` random 224^2 crops with Cellpose's loss, on the card unless
`--device cpu`.  Writes a NumPy `.npz` of Cellpose's state-dict names (the
weights as float16, BatchNorm's statistics as float32; both readers take
them as float32) with the settings in its `meta`
(`io.artifacts.save_cellpose_weights`), which the benchmark's plain
reference reads without the port, after running the stored weights'
`CellposeBackend` on held-out 1024^2 frames (`default_rng(999)`, 80 cells):
it prints the share of planted cells matched at IoU >= 0.5.

    python scripts/make_cellpose_weights_torch.py [--steps 3000] [--out PATH]
"""

import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cell_image_analysis_tpu_torch.io.artifacts import (  # noqa: E402
    resolve_device,
    save_cellpose_weights,
)
from cell_image_analysis_tpu_torch.models.cellpose import cellpose_state_to_numpy  # noqa: E402
from cell_image_analysis_tpu_torch.models.segmentation import CellposeBackend  # noqa: E402
from cell_image_analysis_tpu_torch.train.cellpose_trainer import (  # noqa: E402
    fit_cpnet,
    self_check,
    synthetic_set,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--cells", type=int, default=20, help="cells a frame (80 a 1024^2 frame)")
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--check-frames", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join(REPO, "benchmark", "data",
                                                  "cellpose_synthetic.npz"))
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    images, labels, flows = synthetic_set(args.frames, args.size, args.cells, args.seed, device)
    print(f"{args.frames} frames of {args.size}^2, {int(labels.amax((1, 2)).sum())} cells "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t1 = time.perf_counter()
    model, log = fit_cpnet(images, labels, flows, steps=args.steps, batch=args.batch,
                           lr=args.lr, seed=args.seed, log_every=max(1, args.steps // 20))
    train_s = time.perf_counter() - t1
    # stored as float16 but for BatchNorm's statistics (a checkout of the
    # repository stays small); the self-check runs the stored weights
    arrays = {k: v if k.endswith(("running_mean", "running_var")) else v.astype(np.float16)
              for k, v in cellpose_state_to_numpy(model).items()}
    stored = CellposeBackend({k: v.astype(np.float32) for k, v in arrays.items()},
                             device=device)
    check = self_check(stored, n_frames=args.check_frames)
    print(f"self-check: {check['matched']} of {check['planted']} planted cells matched at "
          f"IoU >= 0.5 ({100 * check['share']:.2f}%), {check['masks']} masks", flush=True)
    meta = dict(steps=args.steps, batch=args.batch, lr=args.lr, frames=args.frames,
                size=args.size, cells=args.cells, seed=args.seed, train_seconds=round(train_s, 1),
                final_loss=log[-1][1], self_check=check,
                device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                command="python scripts/make_cellpose_weights_torch.py " + " ".join(
                    argv if argv is not None else sys.argv[1:]))
    save_cellpose_weights(args.out, arrays, meta)
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(json.dumps({"out": os.path.relpath(args.out, REPO), "sha256": digest, **meta}),
          flush=True)


if __name__ == "__main__":
    main()
