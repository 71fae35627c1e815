"""Weights and scoring state carried over from the JAX package, without JAX.

- `load_unet_variables` reads the committed StarDist U-Net weights
  (`assets/unet_synthetic.pkl`: a dict of numpy arrays in flax HWIO layout)
  and checks their magic, as `utils/bench.load_synthetic_unet_variables`
  does on the JAX side.
- `unet_state_from_jax` / `cae_state_from_jax` map flax variables onto the
  port's `nn.Module` state dicts (HWIO -> OIHW).
- `load_scoring_params` reads `assets/scoring_synthetic.npz`
  (scripts/make_torch_port_assets.py) into a `ScoringParams` of tensors.

Like the JAX package, `load_unet_variables` uses `pickle.load`, which runs
code from the file: only load files you trust.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
UNET_WEIGHTS_PATH = os.path.join(_REPO_ROOT, "assets", "unet_synthetic.pkl")
SCORING_PARAMS_PATH = os.path.join(_REPO_ROOT, "assets", "scoring_synthetic.npz")
_UNET_MAGIC = "cell_image_analysis_tpu/unet-synthetic-v1"


def load_unet_variables(path: str | None = None) -> dict:
    """`{'params': {'Conv_i': {'kernel': HWIO, 'bias': (Co,)}}}` as numpy."""
    path = path or UNET_WEIGHTS_PATH
    with open(path, "rb") as f:
        payload = pickle.load(f)
    magic = payload.get("magic", "") if isinstance(payload, dict) else ""
    if magic != _UNET_MAGIC:
        raise ValueError(f"{path}: unexpected payload")
    return {"params": {name: {k: np.asarray(v, np.float32) for k, v in layer.items()}
                       for name, layer in payload["params"].items()}}


def _hwio_to_oihw(kernel) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def unet_state_from_jax(params: dict) -> dict:
    """Flax StarDistUNet params (Conv_0..Conv_14, HWIO) -> the state dict of
    `models.unet.StarDistUNet` (`convs.Conv_i.weight` OIHW, `.bias`)."""
    params = params.get("params", params)
    state = {}
    for name, layer in params.items():
        state[f"convs.{name}.weight"] = _hwio_to_oihw(layer["kernel"])
        state[f"convs.{name}.bias"] = torch.tensor(np.asarray(layer["bias"], np.float32))
    return state


def cae_state_from_jax(variables: dict) -> dict:
    """Flax CAE variables {'params', 'batch_stats'} -> the state dict of
    `models.cae.CAE` (`convs.i` OIHW kernels, `bns.i` scale/bias/mean/var)."""
    state = {}
    for name, layer in variables["params"].items():
        kind, idx = name.split("_")
        if kind == "Conv":
            state[f"convs.{idx}.weight"] = _hwio_to_oihw(layer["kernel"])
            state[f"convs.{idx}.bias"] = torch.tensor(np.asarray(layer["bias"], np.float32))
        else:
            state[f"bns.{idx}.weight"] = torch.tensor(np.asarray(layer["scale"], np.float32))
            state[f"bns.{idx}.bias"] = torch.tensor(np.asarray(layer["bias"], np.float32))
    for name, stats in variables["batch_stats"].items():
        idx = name.split("_")[1]
        state[f"bns.{idx}.running_mean"] = torch.tensor(np.asarray(stats["mean"], np.float32))
        state[f"bns.{idx}.running_var"] = torch.tensor(np.asarray(stats["var"], np.float32))
    return state


def _nest_cae(arrays: dict) -> dict:
    """`cae/<collection>/<layer>/<leaf>` entries -> nested flax-style dict."""
    out: dict = {}
    for key, v in arrays.items():
        _, coll, layer, leaf = key.split("/")
        out.setdefault(coll, {}).setdefault(layer, {})[leaf] = v
    return out


def scoring_params_from_numpy(arrays: dict, device=None):
    """Named numpy arrays (the layout scripts/make_torch_port_assets.py
    writes) -> `(CAE module, ScoringParams)` on `device`."""
    from cell_image_analysis_tpu_torch.models.cae import CAE
    from cell_image_analysis_tpu_torch.models.svm import SVMParams
    from cell_image_analysis_tpu_torch.pipeline.scoring import ScoringParams

    device = torch.device(device or "cpu")

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name], np.float32), device=device)

    def svm(name):
        return SVMParams(*(t(f"svm_{name}/{f}") for f in SVMParams._fields))

    model = CAE()
    model.load_state_dict(cae_state_from_jax(_nest_cae(
        {k: v for k, v in arrays.items() if k.startswith("cae/")})))
    model = model.to(device).eval()
    params = ScoringParams(
        scaler_center=t("scaler_center"),
        scaler_scale=t("scaler_scale"),
        pca_mean=t("pca_mean"),
        pca_components=t("pca_components"),
        svm_conservative=svm("conservative"),
        svm_moderate=svm("moderate"),
        ensemble_mse_threshold=t("ensemble_mse_threshold"),
        fft_scaler_center=t("fft_scaler_center"),
        fft_scaler_scale=t("fft_scaler_scale"),
        svm_fft=svm("fft"),
    )
    return model, params


def load_scoring_params(path: str | None = None, device=None):
    """`(CAE module, ScoringParams)` from the committed scoring npz."""
    with np.load(path or SCORING_PARAMS_PATH) as z:
        arrays = {k: z[k] for k in z.files}
    return scoring_params_from_numpy(arrays, device=device)
