#!/usr/bin/env python
"""Training entry point of the PyTorch port, reference-style.

Edit the two paths in main() and run `python
CAE_improved_modeltrain_torch.py`, or pass arguments: `python
CAE_improved_modeltrain_torch.py FOLDER [--output DIR ...]` takes every
flag of `python -m cell_image_analysis_tpu_torch.cli train` (`--device
cpu` runs on the CPU; the default is the GPU).
"""

import sys
from datetime import datetime


def main():
    # edit here, or pass command-line arguments
    folder_path = "/path/to/your/training/images/"
    output_dir = f"./output/{datetime.now().strftime('%Y%m%d_%H%M')}"

    from cell_image_analysis_tpu_torch.cli import main as cli_main

    if len(sys.argv) > 1:
        return cli_main(["train", *sys.argv[1:]])
    return cli_main(["train", folder_path, "--output", output_dir])


if __name__ == "__main__":
    sys.exit(main())
