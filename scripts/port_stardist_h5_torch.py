#!/usr/bin/env python3
"""Convert a StarDist Keras `.h5` checkpoint into the port's U-Net weights.

Counterpart of `scripts/port_stardist_h5.py`: the offline path for a user
who holds the pretrained `2D_versatile_fluo` model that the reference
downloads at run time (`StarDist2D.from_pretrained("2D_versatile_fluo")`
leaves `weights_best.h5` in the model folder).  The conv (kernel, bias)
pairs go onto the port's `StarDistUNet` by shape-matched pairing in order
(`utils.port_weights`); a mismatch raises with the pairs made so far.  The
forward is checked on a random 256^2 frame (prob within [0, 1], n_rays
distances) on the card unless `--device cpu`, and the weights are written
as the JAX package's U-Net payload, which `cli screen --unet-weights`
reads.  Needs h5py.

    python scripts/port_stardist_h5_torch.py weights_best.h5 --out assets/unet_fluo.pkl
    python -m cell_image_analysis_tpu_torch.cli screen --unet-weights assets/unet_fluo.pkl ...
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cell_image_analysis_tpu_torch.io.artifacts import (  # noqa: E402
    resolve_device,
    save_unet_variables,
)
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet  # noqa: E402
from cell_image_analysis_tpu_torch.utils.port_weights import (  # noqa: E402
    load_keras_h5_weights,
    port_conv_weights,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("h5", help="Keras H5 weight file from a StarDist model folder "
                               "(e.g. 2D_versatile_fluo/weights_best.h5)")
    ap.add_argument("--out", default="assets/unet_ported.pkl")
    ap.add_argument("--n-rays", type=int, default=32)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--base-filters", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no GPU and no --device cpu
        ap.error(str(e))
    model = StarDistUNet(n_rays=args.n_rays, depth=args.depth, base_filters=args.base_filters)
    h5_layers = load_keras_h5_weights(args.h5)
    model.load_state_dict(port_conv_weights(model.state_dict(), h5_layers))
    model = model.to(device).eval()

    x = np.random.default_rng(0).uniform(0, 1, (1, 256, 256, 1)).astype(np.float32)
    with torch.no_grad():
        prob, dist = model.forward_train(torch.as_tensor(x, device=device))
    assert prob.ndim == 3 and dist.shape[-1] == args.n_rays
    pmin, pmax = float(prob.min()), float(prob.max())
    assert 0.0 <= pmin <= pmax <= 1.0, (pmin, pmax)
    print(f"ported {len(h5_layers)} H5 layers; prob range [{pmin:.4f}, {pmax:.4f}]")

    save_unet_variables(args.out, model, {
        "source_h5": os.path.abspath(args.h5), "ported": True, "n_rays": args.n_rays,
        "depth": args.depth, "base_filters": args.base_filters})
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
