"""Segmentation backends, each a directory found by the name in a
configuration's `segmentation.backend`: `BACKENDS/<backend>/` holds

- `system.py`: `build(seg, weights, device)`, the port's backend object
  (with its `exact_twin()` and routing flags), over the weight files;
- `reference.py`: `load(seg, weights, device)`, the reference's state, and
  `labels(state, seg_channel, seg)`, one frame's int32 label map, in plain
  PyTorch, NumPy and SciPy, nothing of the port;
- `counts.py`: `frame_flops(size, seg)`, the network's direct FLOPs of one
  frame (for `mfu`), and `conv3x3_layers(size, seg)`, the (name, h, w, ci,
  co) of the frame's 3x3 convolutions that run through the port's Winograd
  kernel; nothing of the port.

`seg` is the configuration's `segmentation` with the cell's overrides;
`weights` maps each weight key other than `scoring` to its file, whose
sha256 has been checked.  The modules are loaded by file path, as the
metrics are, so a new backend is new files and no edit.
"""

from __future__ import annotations

import importlib.util
import os

BACKENDS = os.path.dirname(os.path.abspath(__file__))


def directory(backend: str) -> str:
    """BACKENDS/<backend>; stops the run (SystemExit) where there is none."""
    path = os.path.join(BACKENDS, backend)
    if not os.path.isdir(path):
        raise SystemExit(f"segmentation backend {backend!r}: no directory "
                         f"benchmark/backends/{backend}/ (looked in {path})")
    return path


def module(backend: str, name: str):
    """The module `name` (system, reference or counts) of `backend`."""
    path = os.path.join(directory(backend), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_backend_{backend}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
