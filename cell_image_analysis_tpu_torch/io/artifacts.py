"""The artifact store and the weights carried between the packages, without JAX.

- `save_training_artifacts` writes the store that training leaves
  (`best_autoencoder.keras`, `final_autoencoder.keras`, `encoder.keras`,
  `scaler.pkl`, `pca.pkl`, `detector_conservative.pkl`,
  `detector_moderate.pkl`, `ensemble.json`, `fft_scaler.pkl`,
  `detector_fft.pkl`) under the JAX package's file names and formats: a
  model file is a pickle of `{'magic', 'arch', 'variables'}` with the CAE's
  variables as numpy in flax's layout (`save_cae`, through
  `cae_state_to_jax`).  The `.pkl` files pickle the port's own estimator
  classes, whose module paths differ from the JAX package's, so the JAX
  screener cannot read a store that the port trained.
- `load_screening_artifacts` reads a store written by either package;
  `build_scoring_params` turns it into `(CAE module, ScoringParams)`.
  `_StoreUnpickler` maps the JAX package's class paths onto the port's
  classes, takes the port's own, lets numpy's array reconstructors through,
  lets sklearn's classes through when the file is an sklearn pickle, and
  refuses every other global.  The reference's own files, genuine Keras
  models and sklearn pickles, are converted by `io.keras_interop` (which
  raises ImportError naming keras or sklearn where it is missing).
- `load_unet_variables` reads StarDist U-Net weights (the committed
  `assets/unet_synthetic.pkl`, or what `save_unet_variables` writes: a
  dict of numpy arrays in flax HWIO layout) and checks their magic, as
  `utils/bench.load_synthetic_unet_variables` does on the JAX side;
  `save_unet_variables` writes a U-Net module in that payload, plain
  numpy only, so the JAX package reads what the port trains.
- `unet_state_from_jax` / `cae_state_from_jax` map flax variables onto the
  port's `nn.Module` state dicts (HWIO -> OIHW); `unet_params_to_jax` and
  `cae_state_to_jax` are their inverses.
- `load_cellpose_weights` / `save_cellpose_weights` read and write Cellpose
  `CPnet` or Cellpose-SAM weights as a NumPy `.npz` of Cellpose's
  state-dict names (`models.cellpose.cellpose_key_map`; Cellpose-SAM's
  large matrices as seeded bases plus low-rank factors, `models.vit_sam`)
  with a JSON `meta` entry; no pickle.
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


LOW_RANK_SEED = "lowrank.base_seed"


def load_cellpose_weights(path: str) -> dict:
    """The Cellpose-named arrays of a `save_cellpose_weights` file as
    float32 (`meta` left out): CPnet's, or Cellpose-SAM's, whose large
    matrices a file may hold as factors `<name>.lowrank_a` / `.lowrank_b`
    beside `lowrank.base_seed`, merged here into dense float32 matrices
    (`models.vit_sam.base_matrix` + A @ B, on the CPU); ValueError where it
    holds neither network."""
    from cell_image_analysis_tpu_torch.models import vit_sam

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k].astype(np.float32) for k in z.files
                  if k not in ("meta", LOW_RANK_SEED) and not k.endswith(".lowrank_b")}
        for key in [k for k in arrays if k.endswith(".lowrank_a")]:
            name = key[:-len(".lowrank_a")]
            a, b = arrays.pop(key), z[f"{name}.lowrank_b"].astype(np.float32)
            base = vit_sam.base_matrix(name, (a.shape[0], b.shape[1]), int(z[LOW_RANK_SEED]))
            arrays[name] = vit_sam.merge_low_rank(base, a, b).numpy()
    if not (vit_sam.is_vit_state(arrays)
            or "downsample.down.res_down_0.proj.1.weight" in arrays):
        raise ValueError(f"{path}: not a Cellpose CPnet or Cellpose-SAM weight file")
    return arrays


def save_cellpose_weights(path: str, arrays: dict, meta: dict | None = None) -> None:
    """Writes Cellpose-named arrays (float32 or float16, as given) and
    `meta` (as JSON) into an `.npz`; readers take them as float32."""
    np.savez(path, meta=np.asarray(json.dumps(meta or {}, sort_keys=True)),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _host(t) -> np.ndarray:
    """A float32 numpy copy (never a view of a module's live parameters)."""
    return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                    np.float32)


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


def unet_params_to_jax(state: dict) -> dict:
    """The inverse of `unet_state_from_jax`: a `models.unet.StarDistUNet`
    state dict -> flax params {'Conv_i': {'kernel' HWIO, 'bias'}} as
    float32 numpy."""
    params: dict = {}
    for key, t in state.items():
        _, name, leaf = key.split(".")
        a = _host(t)
        params.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = (
            np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if leaf == "weight" else a)
    return params


def save_unet_variables(path: str, model, meta: dict | None = None) -> None:
    """Write `model` (a `StarDistUNet`) as the JAX package's U-Net payload
    {'magic', 'params' (flax layout, numpy), 'meta'}, which
    `load_unet_variables` and the JAX package's
    `utils/bench.load_synthetic_unet_variables` both read."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _save_pickle(path, {"magic": _UNET_MAGIC, "params": unet_params_to_jax(model.state_dict()),
                        "meta": dict(meta or {})})


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


def cae_state_to_jax(state: dict) -> dict:
    """The inverse of `cae_state_from_jax`: a `models.cae.CAE` state dict ->
    flax variables {'params': {'Conv_i': {'kernel' HWIO, 'bias'},
    'BatchNorm_i': {'scale', 'bias'}}, 'batch_stats': {'BatchNorm_i':
    {'mean', 'var'}}} as float32 numpy."""
    params: dict = {}
    stats: dict = {}
    for key, t in state.items():
        kind, idx, leaf = key.split(".")
        a = _host(t)
        if kind == "convs":
            layer = params.setdefault(f"Conv_{idx}", {})
            layer["kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if leaf == "weight" else a)
        elif leaf in ("running_mean", "running_var"):
            stats.setdefault(f"BatchNorm_{idx}", {})[leaf[len("running_"):]] = a
        else:
            params.setdefault(f"BatchNorm_{idx}", {})["scale" if leaf == "weight" else "bias"] = a
    return {"params": params, "batch_stats": stats}


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

_ESTIMATORS = {  # the JAX package's classes -> the port's (the port's own map to themselves)
    ("cell_image_analysis_tpu.models.scaler", "RobustScaler"):
        ("cell_image_analysis_tpu_torch.models.scaler", "RobustScaler"),
    ("cell_image_analysis_tpu.models.pca", "PCA"):
        ("cell_image_analysis_tpu_torch.models.pca", "PCA"),
    ("cell_image_analysis_tpu.models.svm", "OneClassSVM"):
        ("cell_image_analysis_tpu_torch.models.svm", "OneClassSVM"),
    ("cell_image_analysis_tpu.models.ensemble", "EnsembleDetector"):
        ("cell_image_analysis_tpu_torch.models.ensemble", "EnsembleDetector"),
}
_ESTIMATORS.update({target: target for target in list(_ESTIMATORS.values())})
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
    """Reads the store's pickles without importing the JAX package.  An
    sklearn pickle (the reference's store) gets sklearn's classes, which
    `io.keras_interop.convert_estimator` then turns into the port's."""

    def find_class(self, module: str, name: str):
        import importlib

        if (module, name) in _ESTIMATORS:
            module, name = _ESTIMATORS[(module, name)]
            return getattr(importlib.import_module(module), name)
        if (module, name) in _NUMPY_GLOBALS | _PLAIN_GLOBALS:
            return super().find_class(module, name)
        if module.split(".")[0] == "sklearn":
            from cell_image_analysis_tpu_torch.io.keras_interop import require_sklearn

            require_sklearn(f"{module}.{name}")
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to load the global {module}.{name}: the store holds only "
            "numpy arrays and the fitted scaler, PCA, SVM and ensemble classes")


def _save_pickle(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def save_cae(path: str, model, state: dict) -> None:
    """A model file of the store: the JAX package's magic and arch, and the
    state dict `state` of `model` as flax-layout numpy variables."""
    _save_pickle(path, {
        "magic": _CAE_MAGIC,
        "arch": {
            "encoder_filters": tuple(model.encoder_filters),
            "decoder_filters": tuple(model.decoder_filters),
            "bn_momentum": model.bn_momentum,
            "bn_epsilon": model.bn_epsilon,
        },
        "variables": cae_state_to_jax(state),
    })


def save_training_artifacts(output_dir: str, model, best_state: dict, final_state: dict,
                            scaler, pca, detectors: dict, ensemble=None, fft_scaler=None,
                            fft_detector=None) -> None:
    """Write the store into `output_dir`, with the JAX package's file names
    (`encoder.keras` holds the best weights: the encoder is the first half
    of the module)."""
    from cell_image_analysis_tpu_torch import config as C

    os.makedirs(output_dir, exist_ok=True)
    save_cae(os.path.join(output_dir, C.ARTIFACT_BEST_AUTOENCODER), model, best_state)
    save_cae(os.path.join(output_dir, C.ARTIFACT_FINAL_AUTOENCODER), model, final_state)
    save_cae(os.path.join(output_dir, C.ARTIFACT_ENCODER), model, best_state)
    _save_pickle(os.path.join(output_dir, C.ARTIFACT_SCALER), scaler)
    _save_pickle(os.path.join(output_dir, C.ARTIFACT_PCA), pca)
    for name, det in detectors.items():
        _save_pickle(os.path.join(output_dir, f"detector_{name.lower()}.pkl"), det)
    if ensemble is not None:
        with open(os.path.join(output_dir, "ensemble.json"), "w") as f:
            json.dump({"mse_threshold": ensemble.mse_threshold, "min_votes": ensemble.min_votes}, f)
    if fft_scaler is not None and fft_detector is not None:
        _save_pickle(os.path.join(output_dir, "fft_scaler.pkl"), fft_scaler)
        _save_pickle(os.path.join(output_dir, "detector_fft.pkl"), fft_detector)


def _load_store_pickle(path: str):
    """A store pickle; an sklearn estimator comes back as the port's class."""
    from cell_image_analysis_tpu_torch.io.keras_interop import convert_estimator

    with open(path, "rb") as f:
        return convert_estimator(_StoreUnpickler(f).load())


def _is_keras_file(path: str) -> bool:
    """A zip (`.keras`) or an HDF5 (`.h5`) file."""
    with open(path, "rb") as f:
        magic = f.read(4)
    return magic[:2] == b"PK" or magic == b"\x89HDF"


def load_cae(path: str):
    """`(CAE module on the CPU, numpy variables)` from a model file of the
    store: a pickle of `{'magic', 'arch', 'variables'}` with numpy leaves,
    or a genuine Keras `.keras` / `.h5` model (`io.keras_interop.load_keras_cae`)."""
    from cell_image_analysis_tpu_torch.models.cae import CAE

    if _is_keras_file(path):
        from cell_image_analysis_tpu_torch.io.keras_interop import load_keras_cae

        return load_keras_cae(path)
    payload = _load_store_pickle(path)
    if not isinstance(payload, dict) or payload.get("magic") != _CAE_MAGIC:
        raise ValueError(f"{path}: not a {_CAE_MAGIC} artifact")
    arch = payload["arch"]
    model = CAE(encoder_filters=tuple(arch["encoder_filters"]),
                decoder_filters=tuple(arch["decoder_filters"]),
                bn_epsilon=arch["bn_epsilon"], bn_momentum=arch.get("bn_momentum", 0.99))
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
