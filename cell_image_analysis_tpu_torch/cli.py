"""Command-line entry point of the port.

  python -m cell_image_analysis_tpu_torch.cli screen --models DIR \
         --sample strain1=/path/a --sample strain2=/path/b --output OUT

Counterpart of `cell_image_analysis_tpu/cli.py`'s `screen` command, with
the screening constants as flags whose defaults are the reference values
(the training flags wait for `train`).  It runs on
the card; `--device cpu` runs it on the CPU.  Without a GPU and without
`--device cpu` it exits with an error.  `train` and `bench` are not ported
yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from datetime import datetime


def _apply_overrides(config, args):
    qc = dataclasses.replace(
        config.qc,
        min_area=args.min_area, max_area=args.max_area,
        max_eccentricity=args.max_eccentricity, border_margin=args.border_margin,
        min_mean_intensity=args.min_mean_intensity, min_std_intensity=args.min_std_intensity,
    )
    seg = dataclasses.replace(config.seg, backend=args.backend)
    det = dataclasses.replace(
        config.detector, nu_conservative=args.nu_conservative, nu_moderate=args.nu_moderate
    )
    return dataclasses.replace(config, qc=qc, seg=seg, detector=det)


def _add_common(p: argparse.ArgumentParser):
    # default: the StarDist stack; falls back to the bundled weights, then to
    # the threshold backend, with a console notice (see load_unet)
    p.add_argument("--backend", default="stardist", choices=["threshold", "stardist"],
                   help="segmentation backend (stardist uses the bundled weights "
                        "unless --unet-weights)")
    p.add_argument("--unet-weights", default=None, help="path to U-Net weights artifact")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    p.add_argument("--border-margin", type=int, default=10)
    p.add_argument("--min-area", type=int, default=200)
    p.add_argument("--max-area", type=int, default=8000)
    p.add_argument("--max-eccentricity", type=float, default=0.95)
    p.add_argument("--min-mean-intensity", type=float, default=0.5)
    p.add_argument("--min-std-intensity", type=float, default=0.1)
    p.add_argument("--nu-conservative", type=float, default=0.05)
    p.add_argument("--nu-moderate", type=float, default=0.10)


def add_screen_arguments(p: argparse.ArgumentParser):
    p.add_argument("--models", required=True, help="training output dir (artifact contract)")
    p.add_argument("--sample", action="append", default=[], metavar="NAME=FOLDER")
    p.add_argument("--output", default=None)
    p.add_argument("--no-figures", action="store_true",
                   help="write the CSVs and the report but not the three PNG figures "
                        "(they need matplotlib)")
    _add_common(p)


def load_unet(args):
    """The U-Net variables `--backend` / `--unet-weights` select, or None
    for the threshold backend."""
    from cell_image_analysis_tpu_torch.io.artifacts import (
        UNET_WEIGHTS_PATH,
        load_cae,
        load_unet_variables,
    )

    weights_path = args.unet_weights
    if not weights_path and args.backend == "stardist":
        if os.path.exists(UNET_WEIGHTS_PATH):
            print(f"--backend stardist without --unet-weights: using {UNET_WEIGHTS_PATH}")
            weights_path = UNET_WEIGHTS_PATH
        else:
            print("--backend stardist without --unet-weights and no bundled "
                  "weights found: falling back to the threshold backend")
    if not weights_path:
        return None
    try:
        return load_unet_variables(weights_path)
    except ValueError:
        return load_cae(weights_path)[1]  # a generic variables artifact


def parse_samples(parser: argparse.ArgumentParser, args) -> dict:
    samples = {}
    for s in args.sample:
        name, _, folder = s.partition("=")
        if not folder:
            parser.error(f"--sample must be NAME=FOLDER, got {s!r}")
        samples[name] = folder
    if not samples:
        parser.error("at least one --sample NAME=FOLDER is required")
    return samples


def run_screen(parser: argparse.ArgumentParser, args, unet_variables, default_suffix: str):
    """Screen `args.sample` with the models of `args.models`; returns
    (results, output dir)."""
    from cell_image_analysis_tpu_torch.config import PipelineConfig
    from cell_image_analysis_tpu_torch.io.artifacts import resolve_device
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening

    samples = parse_samples(parser, args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"{parser.prog}: error: {e} (--device cpu)\n")
    config = _apply_overrides(PipelineConfig(), args)
    stamp = datetime.now().strftime("%Y%m%d_%H%M")
    out = args.output or f"./results/{stamp}_{default_suffix}"
    screener = ProductionMutantScreening(args.models, config, unet_variables, device=device)
    results, _ = screener.screen_mutant_samples(samples, out, figures=not args.no_figures)
    return results, out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cell_image_analysis_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    add_screen_arguments(sub.add_parser("screen", help="mutant screening pipeline"))
    args = parser.parse_args(argv)

    results, out = run_screen(parser, args, load_unet(args), "improved_screening")
    print("\n=== SCREENING COMPLETED ===")
    print(f"Results saved to: {out}")
    print("\nQUICK SUMMARY:")
    print(f"{'Sample':<15} {'Conservative':<12} {'Moderate':<12}")
    print("-" * 40)
    for name, r in results.items():
        print(f"{name:<15} {r['conservative_anomaly_rate'] * 100:>8.1f}% "
              f"{r['moderate_anomaly_rate'] * 100:>10.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
