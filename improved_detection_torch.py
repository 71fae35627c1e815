#!/usr/bin/env python
"""Screening entry point of the PyTorch port, reference-style.

Edit the model directory and the sample folders in main() and run `python
improved_detection_torch.py`, or pass arguments: `python
improved_detection_torch.py --models DIR --sample name=folder ...` takes
every flag of `python -m cell_image_analysis_tpu_torch.cli screen`
(`--device cpu` runs on the CPU; the default is the GPU).
"""

import sys
from datetime import datetime


def main():
    # edit here, or pass command-line arguments
    model_dir = "/path/to/your/models/"
    test_folders = {
        "sample_strain_1": "/path/to/your/test/images/strain1/",
        "sample_strain_2": "/path/to/your/test/images/strain2/",
    }
    output_dir = f"./results/{datetime.now().strftime('%Y%m%d_%H%M')}_improved_screening"

    from cell_image_analysis_tpu_torch.cli import main as cli_main

    if len(sys.argv) > 1:
        return cli_main(["screen", *sys.argv[1:]])
    args = ["screen", "--models", model_dir, "--output", output_dir]
    for name, folder in test_folders.items():
        args += ["--sample", f"{name}={folder}"]
    return cli_main(args)


if __name__ == "__main__":
    sys.exit(main())
