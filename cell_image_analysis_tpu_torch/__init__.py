"""PyTorch + CUDA port of the cell-screening framework, for NVIDIA Hopper.

The JAX package `cell_image_analysis_tpu` is the reference; every public
function here mirrors the module path and name of its JAX counterpart and
keeps its layouts (NHWC images, HWIO kernels at the converters, (C, cap,
cap) crops), so the two can be compared on the same inputs.

The stages that the JAX package runs through Pallas kernels go through
hand-written CUDA kernels (`csrc/`, built by `ops/cuda/_build.py`):

- every 3x3 conv of the StarDist U-Net -> `csrc/winograd_conv3x3.cu`;
- the run- and pixel-moment segment sums of stage A -> `csrc/segment_sum.cu`;
- the CLAHE of a size bucket of cell crops -> `csrc/clahe_cells.cu`;
- the connected components of the threshold backend's label maps, the
  compaction to 1..K included -> `csrc/cc_tile_labels.cu`.

Each kernel's wrapper launches it for CUDA tensors and runs its plain
PyTorch version for CPU tensors; the CPU tests hold the plain versions
against the JAX package.

Device policy: the entry points that own tensors
(`models.segmentation.StarDistBackend`, `io.artifacts.load_scoring_params`
and `scoring_params_from_numpy`) put them on the card unless the caller
passes `device="cpu"`; without a card and without that argument they
raise.  Every other function runs where its input tensors live.

The port imports nothing of the JAX package: its settings
(`config.SegConfig`) and synthetic frames (`utils.synthetic`) are its own
copies.

Importing the package turns TF32 off for matmuls and cuDNN convolutions:
TF32 keeps ~10 mantissa bits, the same hazard that a single bf16 pass is
on a TPU, and the screening parity contract needs float32 numerics.  (The
Winograd kernel uses the TF32 tensor cores only as 3xTF32, hi/lo halves of
both operands, which keeps float32-level accuracy.)
Submodules are imported lazily.
"""

from __future__ import annotations

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_SUBMODULES = ("io", "ops", "models", "pipeline", "utils")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
