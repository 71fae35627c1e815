"""Training checkpoint and resume.

Counterpart of `cell_image_analysis_tpu/train/checkpoint.py`: the whole
training state — the model's and the optimizer's state dicts, the best
weights, the callback counters, the history, numpy's permutation rng state
and the state of the CPU `torch.Generator` that draws the augmentation
(`train.trainer`; a checkpoint holding a CUDA generator's state, as the
trainer wrote before it drew on the CPU, does not resume) — is written after every
epoch, with tensors as numpy arrays, and `fit_cae(..., checkpoint_dir=...,
resume=True)` continues where it stopped.  The write is atomic (a
temporary file, then `os.replace`).  `load_checkpoint` uses `pickle.load`:
only load checkpoints you trust.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

CHECKPOINT_FILE = "train_checkpoint.pkl"


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree: Any) -> Any:
    """numpy arrays back to CPU tensors (the model's and the optimizer's
    `load_state_dict` move them to the parameters' device)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_checkpoint(checkpoint_dir: str, state: dict) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, CHECKPOINT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(state), f)
    os.replace(tmp, path)  # atomic: a crash mid-write never corrupts the file


def load_checkpoint(checkpoint_dir: str) -> Optional[dict]:
    path = os.path.join(checkpoint_dir, CHECKPOINT_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        state = pickle.load(f)
    for key in ("model", "optimizer", "best_model", "generator_state"):
        state[key] = _to_torch(state[key])
    return state
