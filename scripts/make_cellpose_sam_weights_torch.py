#!/usr/bin/env python3
"""Train the port's Cellpose-SAM network (Cellpose 4's `cpsam` ViT-L at its
published widths) on synthetic frames and write its weights for the
benchmark.

The frames, flow targets and self-check are those of
`scripts/make_cellpose_weights_torch.py` (`train.cellpose_trainer`:
`synthetic_set`, `self_check`): `--frames` of `--size`^2 from
`default_rng(--seed)`, Cellpose's loss on random 256^2 crops.  Each of the
96 large matrices of the blocks is a seeded base (`models.vit_sam.
base_matrix` from `--base-seed`) plus a trained rank-`--rank` update
(`low_rank_`); everything else is trained whole.  TF32 is on while it
trains (the weights are what they are; the program and the reference run
them in float32).  Writes a NumPy `.npz` of Cellpose-SAM's state-dict
names, every array float16 and the large matrices as their factors
(`<name>.lowrank_a`, `.lowrank_b`) beside `lowrank.base_seed`, with the
settings in its `meta` (`io.artifacts.save_cellpose_weights`); reads the
file back through `io.artifacts.load_cellpose_weights` and runs its
`CellposeBackend` on held-out 1024^2 frames (`default_rng(999)`, 80
cells), printing the share of planted cells matched at IoU >= 0.5 and the
sha256 for `benchmark/configs/cellpose_sam.json`.  On the card unless
`--device cpu`; `--dim`, `--depth`, `--heads` and `--hidden` shrink the
network for a try on the CPU.

    python scripts/make_cellpose_sam_weights_torch.py [--steps 3000] [--rank 4] [--out PATH]
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
    LOW_RANK_SEED,
    load_cellpose_weights,
    resolve_device,
    save_cellpose_weights,
)
from cell_image_analysis_tpu_torch.models import vit_sam  # noqa: E402
from cell_image_analysis_tpu_torch.models.segmentation import CellposeBackend  # noqa: E402
from cell_image_analysis_tpu_torch.train.cellpose_trainer import (  # noqa: E402
    fit_cellpose,
    self_check,
    synthetic_set,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--base-seed", type=int, default=20250)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--cells", type=int, default=20, help="cells a frame (80 a 1024^2 frame)")
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--check-frames", type=int, default=4)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join(REPO, "benchmark", "data",
                                                  "cellpose_sam_synthetic.npz"))
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    t0 = time.perf_counter()
    images, labels, flows = synthetic_set(args.frames, args.size, args.cells, args.seed, device)
    print(f"{args.frames} frames of {args.size}^2, {int(labels.amax((1, 2)).sum())} cells "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    widths = dict(dim=args.dim, depth=args.depth, heads=args.heads, hidden=args.hidden)
    model = vit_sam.low_rank_(vit_sam.init_vit_sam(args.seed, **widths), args.rank,
                              args.base_seed, args.seed)
    t1 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        model, log = fit_cellpose(model, images, labels, flows, steps=args.steps,
                                  batch=args.batch, lr=args.lr, seed=args.seed,
                                  log_every=max(1, args.steps // 20))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    train_s = time.perf_counter() - t1
    arrays, _ = vit_sam.low_rank_state_to_numpy(model)
    arrays = {k: v.astype(np.float16) for k, v in arrays.items()}
    arrays[LOW_RANK_SEED] = np.asarray(args.base_seed, np.int64)
    meta = dict(steps=args.steps, batch=args.batch, lr=args.lr, rank=args.rank,
                base_seed=args.base_seed, frames=args.frames, size=args.size, cells=args.cells,
                seed=args.seed, widths=widths, train_seconds=round(train_s, 1),
                final_loss=log[-1][1],
                device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                command="python scripts/make_cellpose_sam_weights_torch.py " + " ".join(
                    argv if argv is not None else sys.argv[1:]))
    # the self-check runs the stored file, read back as the benchmark reads it
    save_cellpose_weights(args.out, arrays, meta)
    del model
    stored = CellposeBackend(load_cellpose_weights(args.out), device=device)
    check = self_check(stored, n_frames=args.check_frames)
    print(f"self-check: {check['matched']} of {check['planted']} planted cells matched at "
          f"IoU >= 0.5 ({100 * check['share']:.2f}%), {check['masks']} masks", flush=True)
    save_cellpose_weights(args.out, arrays, dict(meta, self_check=check))
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(json.dumps({"out": os.path.relpath(args.out, REPO), "sha256": digest,
                      "bytes": os.path.getsize(args.out), **meta, "self_check": check}),
          flush=True)


if __name__ == "__main__":
    main()
