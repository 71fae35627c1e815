"""PyTorch + CUDA port of the cell-screening framework, for NVIDIA Hopper.

The JAX package `cell_image_analysis_tpu` is the reference; every public
function here mirrors the module path and name of its JAX counterpart and
keeps its layouts (NHWC images, HWIO kernels at the converters, (C, cap,
cap) crops), so the two can be compared on the same inputs.

The stages that the JAX package runs through Pallas kernels go through
hand-written CUDA kernels (`csrc/`, built by `ops/cuda/_build.py`):

- every 3x3 conv of the StarDist U-Net -> `csrc/winograd_conv3x3.cu`;
- the run-moment segment sums of stage A -> `csrc/segment_sum.cu`;
- the per-cell CLAHE core -> `csrc/clahe_core.cu`.

Each kernel's wrapper launches it for CUDA tensors and runs its plain
PyTorch version for CPU tensors; the CPU tests hold the plain versions
against the JAX package.

Device policy: nothing picks a device implicitly.  The entry points that
own tensors (`models.segmentation.StarDistBackend`,
`io.artifacts.load_scoring_params`) take a `device` argument; every other
function runs where its input tensors live.

Importing the package turns TF32 off for matmuls and cuDNN convolutions:
TF32 keeps ~10 mantissa bits, the same hazard that a single bf16 pass is
on a TPU, and the screening parity contract needs float32 numerics.
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
