#!/usr/bin/env python
"""Plate-scale bench row of the PyTorch port: 2048^2 frames through the
fused StarDist path on one GPU (the counterpart of `scripts/bench_2048.py`).

    python scripts/bench_2048_torch.py [n_frames] [frame_batch] [--device cpu]

12 synthetic frames of 2048^2 (seed 7, 320 cells a frame, `make_frame_instances`)
by default, in pipelined batches of 2, two warm-ups, best of 2 timed runs,
at `utils/bench.plate_settings(2048)`: the StarDist capacities scaled with
the frame's area, the scaled backend's exact twin as the overflow fallback.
Prints one JSON line, `screening_cells_per_sec_per_chip_stardist_2048` with
JAX's keys; the device, the settings, the batches that fell back and the
device memory go to stderr.  It runs on the GPU, and exits 2 without one
unless `--device cpu` is given (slow at this size).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cell_image_analysis_tpu_torch.utils.bench import plate_row_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(plate_row_main(2048))
