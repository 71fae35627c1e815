#!/usr/bin/env python3
"""Train the port's StarDist U-Net on synthetic plates and write its weights.

Counterpart of `scripts/make_unet_weights.py`, with the same flags and
defaults (less the TPU ones) and the same frames: `np.random.default_rng(123)`,
`make_frame` with the threshold oracle's labels, or with `--dense` crowded
`make_frame_instances` plates with their true instance labels.  Trains
from the port's own init (`models.unet.init_unet`, seed 42) or
`--warm-start PKL`, one full-batch Adam step an epoch
(`train.unet_trainer.fit_unet`), on the card unless `--device cpu`, then
checks `predict_instances` on a fresh `default_rng(999)` frame and writes
the JAX package's U-Net payload ({'magic', 'params' in flax layout,
'meta'}), which both packages read (`cli screen --unet-weights PATH`).
The committed `assets/unet_synthetic.pkl` came from
`make_unet_weights.py --dense` (400 epochs, 8 frames of 256^2).

    python scripts/make_unet_weights_torch.py --dense [--epochs 400] [--device cpu]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cell_image_analysis_tpu_torch.io.artifacts import (  # noqa: E402
    load_unet_variables,
    resolve_device,
    save_unet_variables,
    unet_state_from_jax,
)
from cell_image_analysis_tpu_torch.train.unet_trainer import (  # noqa: E402
    fit_unet,
    self_check,
    synthetic_training_set,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dense", action="store_true",
                    help="crowded plates with true instance labels "
                         "(utils.synthetic.make_frame_instances) instead of sparse "
                         "threshold-oracle labels")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fg-d2", type=float, default=1.6,
                    help="dense-mode label footprint (normalized ellipse d2 cutoff)")
    ap.add_argument("--warm-start", default=None, metavar="PKL",
                    help="start from an existing U-Net payload and fine-tune")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join(REPO, "assets", "unet_synthetic_torch.pkl"))
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no GPU and no --device cpu
        ap.error(str(e))

    t0 = time.perf_counter()
    frames, labels = synthetic_training_set(args.frames, args.size, args.dense, args.fg_d2)
    print(f"training on {len(frames)} frames, "
          f"{sum(int(lab.max()) for lab in labels)} instances total", flush=True)
    init_state = None
    if args.warm_start:
        init_state = unet_state_from_jax(load_unet_variables(args.warm_start)["params"])
        print(f"warm-starting from {args.warm_start}", flush=True)
    model = fit_unet(frames, labels, epochs=args.epochs, lr=args.lr, verbose=True,
                     init_state=init_state, device=device)
    check = self_check(model, args.size, args.dense, args.fg_d2)
    print(f"self-check: {check['n_pred']} predicted vs {check['n_true']} true instances, "
          f"fg coverage {check['coverage']:.2f}", flush=True)
    save_unet_variables(args.out, model, {
        "epochs": args.epochs, "frames": args.frames, "size": args.size,
        "dense": bool(args.dense), "n_pred": check["n_pred"], "n_true": check["n_true"],
        "coverage": check["coverage"], "trained_by": "cell_image_analysis_tpu_torch"})
    print(f"wrote {args.out} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
