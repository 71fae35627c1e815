#!/usr/bin/env python
"""Ensemble screening entry point of the PyTorch port.

The same screening pipeline with the ensemble combiner as the headline:
per-sample ensemble anomaly rates (majority vote of the reconstruction-error
threshold, the conservative SVM and the moderate SVM) printed beside the
individual detectors.  As `improved_detection_v2.py`, it screens with the
threshold backend (it loads no U-Net).

Usage: `python improved_detection_v2_torch.py --models DIR --sample
name=folder ...` (every `cli screen` flag), or edit the defaults below.
"""

import sys
from datetime import datetime


def main():
    model_dir = "/path/to/your/models/"
    test_folders = {
        "sample_strain_1": "/path/to/your/test/images/strain1/",
    }
    output_dir = f"./results/{datetime.now().strftime('%Y%m%d_%H%M')}_v2_screening"

    argv = sys.argv[1:]
    if not argv:
        argv = ["--models", model_dir, "--output", output_dir]
        for name, folder in test_folders.items():
            argv += ["--sample", f"{name}={folder}"]

    import argparse

    from cell_image_analysis_tpu_torch.cli import add_screen_arguments, run_screen

    parser = argparse.ArgumentParser(prog="improved_detection_v2_torch")
    add_screen_arguments(parser)
    args = parser.parse_args(argv)
    results, out = run_screen(parser, args, None, "v2_screening")

    print("\n=== ENSEMBLE SCREENING COMPLETED ===")
    print(f"Results saved to: {out}\n")
    print(f"{'Sample':<20} {'Ensemble':<10} {'Conservative':<13} {'Moderate':<10}")
    print("-" * 56)
    for name, r in results.items():
        print(f"{name:<20} {r['ensemble_anomaly_rate']*100:>7.1f}%  "
              f"{r['conservative_anomaly_rate']*100:>10.1f}%  "
              f"{r['moderate_anomaly_rate']*100:>7.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
