"""Command-line entry point of the port.

  python -m cell_image_analysis_tpu_torch.cli train INPUT_FOLDER --output OUT
  python -m cell_image_analysis_tpu_torch.cli screen --models DIR \
         --sample strain1=/path/a --sample strain2=/path/b --output OUT \
         [--backend cellpose|cellpose_sam --cellpose-weights PATH]
  python -m cell_image_analysis_tpu_torch.cli bench [--frames 8 --size 1024 \
         --cells-per-frame 80 --backend stardist]

Counterpart of `cell_image_analysis_tpu/cli.py`, with the constants as
flags whose defaults are the reference values.  `bench` prints one JSON
line (`utils.bench.run_bench`).  They run on the card; `--device cpu` runs
them on the CPU.
Without a GPU and without `--device cpu` they exit with an error (code 2).
`--mesh N` shards them over the first N GPUs (`parallel.mesh.make_mesh`),
or, with `--device cpu` or `--device cuda:K`, over N shards on that one
device (`virtual_mesh`).
`train` exits 1 when fewer than `--min-cells` cells pass QC.
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
    config = dataclasses.replace(config, qc=qc, seg=seg, detector=det)
    if hasattr(args, "epochs"):
        train = dataclasses.replace(config.train, epochs=args.epochs,
                                    batch_size=args.batch_size, min_cells=args.min_cells)
        config = dataclasses.replace(config, train=train)
    return config


def _add_common(p: argparse.ArgumentParser):
    # default: the StarDist stack; falls back to the bundled weights, then to
    # the threshold backend, with a console notice (see load_unet)
    p.add_argument("--backend", default="stardist", choices=["threshold", "stardist"],
                   help="segmentation backend (stardist uses the bundled weights "
                        "unless --unet-weights)")
    p.add_argument("--unet-weights", default=None, help="path to U-Net weights artifact")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over the first N GPUs, or over N shards of --device "
                        "(0 = one device)")
    p.add_argument("--border-margin", type=int, default=10)
    p.add_argument("--min-area", type=int, default=200)
    p.add_argument("--max-area", type=int, default=8000)
    p.add_argument("--max-eccentricity", type=float, default=0.95)
    p.add_argument("--min-mean-intensity", type=float, default=0.5)
    p.add_argument("--min-std-intensity", type=float, default=0.1)
    p.add_argument("--nu-conservative", type=float, default=0.05)
    p.add_argument("--nu-moderate", type=float, default=0.10)


def add_train_arguments(p: argparse.ArgumentParser):
    p.add_argument("input_folder")
    p.add_argument("--output", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--min-cells", type=int, default=500,
                   help="abort training below this many QC cells (reference: 500)")
    p.add_argument("--no-figures", action="store_true",
                   help="write the store, the CSVs and the reports but not the three PNG "
                        "figures (they need matplotlib)")
    _add_common(p)


def add_screen_arguments(p: argparse.ArgumentParser):
    p.add_argument("--models", required=True, help="training output dir (artifact contract)")
    p.add_argument("--sample", action="append", default=[], metavar="NAME=FOLDER")
    p.add_argument("--output", default=None)
    p.add_argument("--no-figures", action="store_true",
                   help="write the CSVs and the report but not the three PNG figures "
                        "(they need matplotlib)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="screen under torch.profiler: a Chrome trace with the port's spans, "
                        "and their summary as JSON, written into DIR")
    _add_common(p)
    # screening also runs the port's Cellpose backends, which JAX's cli has not
    backend = next(a for a in p._actions if a.dest == "backend")
    backend.choices = [*backend.choices, "cellpose", "cellpose_sam"]
    backend.help = ("segmentation backend (stardist uses the bundled weights unless "
                    "--unet-weights; cellpose and cellpose_sam need --cellpose-weights)")
    p.add_argument("--cellpose-weights", default=None, metavar="PATH",
                   help="Cellpose weights (.npz of Cellpose's state-dict names, "
                        "io.artifacts.save_cellpose_weights): CPnet's for --backend cellpose, "
                        "Cellpose-SAM's for --backend cellpose_sam")


def load_unet(args):
    """The network weights `--backend` selects: the U-Net variables of
    `--unet-weights` (or the bundled ones), the Cellpose weights of
    `--cellpose-weights`, or None for the threshold backend."""
    from cell_image_analysis_tpu_torch.io.artifacts import (
        UNET_WEIGHTS_PATH,
        load_cae,
        load_cellpose_weights,
        load_unet_variables,
    )

    if args.backend in ("cellpose", "cellpose_sam"):
        if not getattr(args, "cellpose_weights", None):
            raise SystemExit(f"--backend {args.backend} needs --cellpose-weights PATH")
        return load_cellpose_weights(args.cellpose_weights)
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


def _device(parser: argparse.ArgumentParser, args):
    """(device, mesh) of `--device` and `--mesh`; no GPU without `--device
    cpu` exits 2."""
    from cell_image_analysis_tpu_torch.io.artifacts import resolve_device
    from cell_image_analysis_tpu_torch.parallel.mesh import make_mesh, virtual_mesh

    try:
        device = resolve_device(args.device)
        if not getattr(args, "mesh", 0):
            return device, None
        if args.device is None:
            return None, make_mesh(args.mesh)
        return None, virtual_mesh(device, args.mesh)
    except (RuntimeError, ValueError) as e:
        parser.exit(2, f"{parser.prog}: error: {e} (--device cpu)\n")


def run_train(parser: argparse.ArgumentParser, args, unet_variables) -> int:
    """Train on `args.input_folder` into `args.output`; 0, or 1 below
    `--min-cells` cells."""
    from cell_image_analysis_tpu_torch.config import PipelineConfig
    from cell_image_analysis_tpu_torch.pipeline.training import ImprovedAnomalyDetectionTraining

    device, mesh = _device(parser, args)
    config = _apply_overrides(PipelineConfig(), args)
    out = args.output or f"./output/{datetime.now().strftime('%Y%m%d_%H%M')}"
    trainer = ImprovedAnomalyDetectionTraining(out, config, unet_variables, device=device,
                                               mesh=mesh)
    return 0 if trainer.run(args.input_folder, figures=not args.no_figures) else 1


def run_screen(parser: argparse.ArgumentParser, args, unet_variables, default_suffix: str):
    """Screen `args.sample` with the models of `args.models`; returns
    (results, output dir).  With `--trace-dir` the screening runs under
    `utils.profiler.trace`, and `summary_<pid>.json` (the spans and
    counters) goes beside the trace."""
    from cell_image_analysis_tpu_torch.config import PipelineConfig
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu_torch.utils import profiler

    samples = parse_samples(parser, args)
    device, mesh = _device(parser, args)
    config = _apply_overrides(PipelineConfig(), args)
    stamp = datetime.now().strftime("%Y%m%d_%H%M")
    out = args.output or f"./results/{stamp}_{default_suffix}"
    screener = ProductionMutantScreening(args.models, config, unet_variables, device=device,
                                         mesh=mesh)
    trace_dir = getattr(args, "trace_dir", None)
    if trace_dir:
        profiler.reset()
    with profiler.trace(trace_dir):
        results, _ = screener.screen_mutant_samples(samples, out, figures=not args.no_figures)
    if trace_dir:
        path = os.path.join(trace_dir, f"summary_{os.getpid()}.json")
        profiler.write_summary(path)
        print(f"Trace and span summary written to: {trace_dir}")
    return results, out


def add_bench_arguments(p: argparse.ArgumentParser):
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--cells-per-frame", type=int, default=80)
    p.add_argument("--backend", default="stardist", choices=["threshold", "stardist"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")


def run_bench(parser: argparse.ArgumentParser, args) -> int:
    """One JSON line on stdout; the device and what `vs_baseline` compares
    with on stderr."""
    from cell_image_analysis_tpu_torch.utils.bench import BASELINE_NOTE, run_bench as bench

    device, _ = _device(parser, args)
    print(bench(n_frames=args.frames, size=args.size, n_cells=args.cells_per_frame,
                backend=args.backend, device=device))
    print(f"device: {device}; {BASELINE_NOTE}", file=sys.stderr)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cell_image_analysis_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    add_train_arguments(sub.add_parser("train", help="CAE training pipeline"))
    add_screen_arguments(sub.add_parser("screen", help="mutant screening pipeline"))
    add_bench_arguments(sub.add_parser("bench", help="throughput benchmark (one JSON line)"))
    args = parser.parse_args(argv)
    if args.command == "bench":
        return run_bench(parser, args)
    if args.command == "train":
        return run_train(parser, args, load_unet(args))

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
