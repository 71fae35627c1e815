"""Weights and scoring state carried over from the JAX package, without JAX.

- `load_screening_artifacts` reads the store that the JAX package's
  training writes (`best_autoencoder.keras`, `scaler.pkl`, `pca.pkl`,
  `detector_conservative.pkl`, `detector_moderate.pkl`, and the optional
  `ensemble.json`, `fft_scaler.pkl`, `detector_fft.pkl`);
  `build_scoring_params` turns it into `(CAE module, ScoringParams)`.  The
  `.pkl` files pickle classes of the JAX package: `_StoreUnpickler` maps
  those class paths onto the port's copies, lets numpy's array
  reconstructors through and refuses every other global.  Genuine Keras
  models and sklearn pickles (the JAX package's `io/keras_interop`) are not
  read yet and raise `NotImplementedError`.
- `load_unet_variables` reads the committed StarDist U-Net weights
  (`assets/unet_synthetic.pkl`: a dict of numpy arrays in flax HWIO layout)
  and checks their magic, as `utils/bench.load_synthetic_unet_variables`
  does on the JAX side.
- `unet_state_from_jax` / `cae_state_from_jax` map flax variables onto the
  port's `nn.Module` state dicts (HWIO -> OIHW).
- `load_scoring_params` reads `assets/scoring_synthetic.npz`
  (scripts/make_torch_port_assets.py) into a `ScoringParams` of tensors,
  on the card unless the caller passes `device="cpu"`.

`load_unet_variables` uses `pickle.load`, which runs code from the file:
only load files you trust.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
UNET_WEIGHTS_PATH = os.path.join(_REPO_ROOT, "assets", "unet_synthetic.pkl")
SCORING_PARAMS_PATH = os.path.join(_REPO_ROOT, "assets", "scoring_synthetic.npz")
_UNET_MAGIC = "cell_image_analysis_tpu/unet-synthetic-v1"
_CAE_MAGIC = "cell_image_analysis_tpu/cae-v1"
_KERAS_INTEROP = ("reading it is the JAX package's io/keras_interop, which "
                  "cell_image_analysis_tpu_torch has not ported yet")


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None.  A CUDA device on a machine
    without one raises: nothing runs on the CPU unless the caller asks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


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
    writes) -> `(CAE module, ScoringParams)` on `device` (default: the card)."""
    from cell_image_analysis_tpu_torch.models.cae import CAE
    from cell_image_analysis_tpu_torch.models.svm import SVMParams
    from cell_image_analysis_tpu_torch.pipeline.scoring import ScoringParams

    device = resolve_device(device)

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


# ------------------------------------------------- the training store --

_ESTIMATORS = {
    ("cell_image_analysis_tpu.models.scaler", "RobustScaler"):
        ("cell_image_analysis_tpu_torch.models.scaler", "RobustScaler"),
    ("cell_image_analysis_tpu.models.pca", "PCA"):
        ("cell_image_analysis_tpu_torch.models.pca", "PCA"),
    ("cell_image_analysis_tpu.models.svm", "OneClassSVM"):
        ("cell_image_analysis_tpu_torch.models.svm", "OneClassSVM"),
    ("cell_image_analysis_tpu.models.ensemble", "EnsembleDetector"):
        ("cell_image_analysis_tpu_torch.models.ensemble", "EnsembleDetector"),
}
# what a numpy array, scalar or dtype pickles through, under either
# spelling of numpy's core package
_NUMPY_GLOBALS = {(mod, name)
                  for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
                  for name in ("_reconstruct", "scalar")}
_NUMPY_GLOBALS |= {("numpy", "ndarray"), ("numpy", "dtype"),
                   # protocol 5 rebuilds an array from an out-of-band buffer
                   ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer")}
# protocols 0 and 1 rebuild an object through `_reconstructor(cls, object,
# None)` and an array's bytes through `_codecs.encode`, under Python 2's
# module names
_PLAIN_GLOBALS = {("copyreg", "_reconstructor"), ("copy_reg", "_reconstructor"),
                  ("builtins", "object"), ("__builtin__", "object"), ("_codecs", "encode")}


class _StoreUnpickler(pickle.Unpickler):
    """Reads the store's pickles without importing the JAX package."""

    def find_class(self, module: str, name: str):
        import importlib

        if (module, name) in _ESTIMATORS:
            module, name = _ESTIMATORS[(module, name)]
            return getattr(importlib.import_module(module), name)
        if (module, name) in _NUMPY_GLOBALS | _PLAIN_GLOBALS:
            return super().find_class(module, name)
        if module.split(".")[0] == "sklearn":
            raise NotImplementedError(f"an sklearn pickle ({module}.{name}): {_KERAS_INTEROP}")
        raise pickle.UnpicklingError(
            f"refusing to load the global {module}.{name}: the store holds only "
            "numpy arrays and the fitted scaler, PCA, SVM and ensemble classes")


def _load_store_pickle(path: str):
    with open(path, "rb") as f:
        return _StoreUnpickler(f).load()


def _is_keras_file(path: str) -> bool:
    """A zip (`.keras`) or an HDF5 (`.h5`) file."""
    with open(path, "rb") as f:
        magic = f.read(4)
    return magic[:2] == b"PK" or magic == b"\x89HDF"


def load_cae(path: str):
    """`(CAE module on the CPU, numpy variables)` from a model file of the
    store: a pickle of `{'magic', 'arch', 'variables'}` with numpy leaves."""
    from cell_image_analysis_tpu_torch.models.cae import CAE

    if _is_keras_file(path):
        raise NotImplementedError(f"{path} is a Keras model file: {_KERAS_INTEROP}")
    payload = _load_store_pickle(path)
    if not isinstance(payload, dict) or payload.get("magic") != _CAE_MAGIC:
        raise ValueError(f"{path}: not a {_CAE_MAGIC} artifact")
    arch = payload["arch"]
    model = CAE(encoder_filters=tuple(arch["encoder_filters"]),
                decoder_filters=tuple(arch["decoder_filters"]),
                bn_epsilon=arch["bn_epsilon"])
    variables = payload["variables"]
    model.load_state_dict(cae_state_from_jax(variables))
    return model.eval(), variables


def load_screening_artifacts(model_dir: str):
    """Everything screening needs from a model directory.  Returns
    (model, variables, scaler, pca, detectors, ensemble) as the JAX
    package's function does, with the port's classes."""
    from cell_image_analysis_tpu_torch import config as C
    from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector

    model, variables = load_cae(os.path.join(model_dir, C.ARTIFACT_BEST_AUTOENCODER))

    def est(name):
        return _load_store_pickle(os.path.join(model_dir, name))

    scaler = est(C.ARTIFACT_SCALER)
    pca = est(C.ARTIFACT_PCA)
    detectors = {"Conservative": est(C.ARTIFACT_DETECTOR_CONSERVATIVE),
                 "Moderate": est(C.ARTIFACT_DETECTOR_MODERATE)}
    ensemble = None
    ens_path = os.path.join(model_dir, "ensemble.json")
    if os.path.exists(ens_path):
        with open(ens_path) as f:
            d = json.load(f)
        ensemble = EnsembleDetector(mse_threshold=d["mse_threshold"], min_votes=d["min_votes"])
    if os.path.exists(os.path.join(model_dir, "detector_fft.pkl")):
        detectors["FFT"] = est("detector_fft.pkl")
        detectors["FFT_scaler"] = est("fft_scaler.pkl")
    return model, variables, scaler, pca, detectors, ensemble


def null_svm_params(dim: int):
    """An SVM that always answers +1 / normal (decision == +1): stands in
    for the FFT detector when the store predates it."""
    from cell_image_analysis_tpu_torch.models.svm import SVMParams

    return SVMParams(support_vectors=torch.zeros((1, dim)), dual_coef=torch.zeros((1,)),
                     rho=torch.tensor(-1.0), gamma=torch.tensor(1.0))


def build_scoring_params(model, variables, scaler, pca, detectors, ensemble,
                         fft_dim: int = 16 + 8 + 3, device=None):
    """`(CAE module, ScoringParams)` on `device` (default: the card) from
    the loaded artifacts.  `variables` is taken for the JAX signature's
    sake: the module already holds them."""
    from cell_image_analysis_tpu_torch.models.svm import SVMParams
    from cell_image_analysis_tpu_torch.pipeline.scoring import ScoringParams

    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def svm(p):
        return SVMParams(*(x.to(device) for x in p))

    thresh = ensemble.mse_threshold if ensemble is not None else np.inf
    if "FFT" in detectors:
        fft_svm = detectors["FFT"].params
        fft_center, fft_scale = t(detectors["FFT_scaler"].center_), t(detectors["FFT_scaler"].scale_)
    else:
        fft_svm = null_svm_params(fft_dim)
        fft_center, fft_scale = t(np.zeros(fft_dim)), t(np.ones(fft_dim))
    params = ScoringParams(
        scaler_center=t(scaler.center_),
        scaler_scale=t(scaler.scale_),
        pca_mean=t(pca.mean_),
        pca_components=t(pca.components_),
        svm_conservative=svm(detectors["Conservative"].params),
        svm_moderate=svm(detectors["Moderate"].params),
        ensemble_mse_threshold=t(thresh),
        fft_scaler_center=fft_center,
        fft_scaler_scale=fft_scale,
        svm_fft=svm(fft_svm),
    )
    return model.to(device).eval(), params
