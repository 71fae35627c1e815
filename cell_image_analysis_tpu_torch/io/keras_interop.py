"""The reference's own model files: genuine Keras models and sklearn pickles.

Counterpart of `cell_image_analysis_tpu/io/keras_interop.py`.  A model
directory written by the reference holds Keras models
(`best_autoencoder.keras`, `encoder.keras`, from `Model.save`) and sklearn
pickles (`scaler.pkl`, `pca.pkl`, `detector_*.pkl`).  This module turns
them into the port's forms, and back:

- `build_keras_cae` and `build_keras_stardist_unet`: Keras twins of the
  CAE and of the StarDist U-Net, layers created in the order of the port's
  (and flax's) modules, so that weights pair in order;
- `cae_state_from_keras` / `load_keras_cae` / `export_keras_cae`: a Keras
  CAE to the port's `models.cae.CAE` state dict and back (Keras and flax
  share the HWIO kernel layout; the port's modules hold OIHW);
- `unet_state_from_keras` / `keras_unet_from_state`: the same for the U-Net;
- `convert_sklearn_scaler`, `_pca`, `_ocsvm` and `convert_estimator`: a
  fitted sklearn `RobustScaler`, `PCA` or RBF `OneClassSVM` to the port's
  `models.scaler`, `models.pca` and `models.svm` classes (libsvm's
  decision function is sum_i alpha_i k(x, sv_i) - rho, the port's form).

`io.artifacts.load_cae` and the store's unpickler come here for such
files, so `cli screen --models DIR` screens a reference-trained directory.
Keras is imported only inside the functions that need it; sklearn is never
imported here (reading an sklearn pickle imports its classes by name).
Where either is missing, the function that needs it raises ImportError
naming it.
"""

from __future__ import annotations

import importlib.util
import re

import numpy as np


def require_keras():
    """The `keras` module, or ImportError naming it."""
    try:
        import keras
    except ImportError as e:
        raise ImportError("reading or writing a Keras model file needs the keras package "
                          "(with a backend such as tensorflow)") from e
    return keras


def require_sklearn(what: str = "an sklearn estimator") -> None:
    """ImportError naming scikit-learn unless it is installed."""
    if importlib.util.find_spec("sklearn") is None:
        raise ImportError(f"reading {what} needs the scikit-learn package (sklearn)")


def natural_key(name: str):
    """Sort key that orders embedded integers numerically (Conv_2 < Conv_10)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


# ------------------------------------------------------------ Keras twins --

def build_keras_cae(input_size: int = 64, encoder_filters=(32, 64, 32),
                    decoder_filters=(32, 64, 32)):
    """The reference CAE as a Keras model pair (autoencoder, encoder) over
    shared layers."""
    keras = require_keras()
    from keras import layers

    inp = layers.Input((input_size, input_size, 1))
    x = inp
    for f in encoder_filters:
        x = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(x)
        x = layers.BatchNormalization()(x)
        x = layers.MaxPooling2D((2, 2), padding="same")(x)
    encoded = x
    for f in decoder_filters:
        x = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(x)
        x = layers.BatchNormalization()(x)
        x = layers.UpSampling2D((2, 2))(x)
    decoded = layers.Conv2D(1, (3, 3), activation="sigmoid", padding="same")(x)
    return keras.Model(inp, decoded), keras.Model(inp, encoded)


def build_keras_stardist_unet(n_rays: int = 32, depth: int = 3, base_filters: int = 32,
                              head_filters: int = 128, grid=(2, 2), input_size: int = 256):
    """Keras twin of `models.unet.StarDistUNet` (prob and dist heads over the
    whole grid)."""
    import math

    keras = require_keras()
    from keras import layers

    inp = layers.Input((input_size, input_size, 1))
    h, skips = inp, []
    for lvl in range(depth):
        f = base_filters * (2 ** lvl)
        h = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(h)
        h = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(h)
        skips.append(h)
        h = layers.MaxPooling2D((2, 2), padding="same")(h)
    f = base_filters * (2 ** depth)
    h = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(h)
    h = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(h)
    for lvl in reversed(range(int(math.log2(grid[0])), depth)):
        f = base_filters * (2 ** lvl)
        h = layers.UpSampling2D((2, 2))(h)
        h = layers.Concatenate()([h, skips[lvl]])
        h = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(h)
        h = layers.Conv2D(f, (3, 3), activation="relu", padding="same")(h)
    feat = layers.Conv2D(head_filters, (3, 3), activation="relu", padding="same")(h)
    prob = layers.Conv2D(1, (1, 1), activation="sigmoid")(feat)
    dist = layers.Conv2D(n_rays, (1, 1), activation="softplus")(feat)
    return keras.Model(inp, [prob, dist])


def _layers(model, cls_name: str) -> list:
    return [layer for layer in model.layers if type(layer).__name__ == cls_name]


def _conv_params(model) -> dict:
    """{'Conv_i': {'kernel' HWIO, 'bias'}} of a Keras model's Conv2D layers,
    in creation order."""
    params = {}
    for i, layer in enumerate(_layers(model, "Conv2D")):
        w = layer.get_weights()
        params[f"Conv_{i}"] = {
            "kernel": np.asarray(w[0], np.float32),
            "bias": (np.asarray(w[1], np.float32) if len(w) > 1
                     else np.zeros((w[0].shape[-1],), np.float32))}
    return params


# ----------------------------------------------------------- the CAE --

def cae_variables_from_keras(autoencoder) -> dict:
    """A Keras CAE -> flax-layout numpy variables {'params', 'batch_stats'}:
    Conv2D k <-> Conv_k, BatchNormalization k <-> BatchNorm_k."""
    params = _conv_params(autoencoder)
    stats = {}
    for i, layer in enumerate(_layers(autoencoder, "BatchNormalization")):
        gamma, beta, mean, var = (np.asarray(a, np.float32) for a in layer.get_weights())
        params[f"BatchNorm_{i}"] = {"scale": gamma, "bias": beta}
        stats[f"BatchNorm_{i}"] = {"mean": mean, "var": var}
    return {"params": params, "batch_stats": stats}


def cae_state_from_keras(autoencoder) -> dict:
    """A Keras CAE -> the state dict of `models.cae.CAE`."""
    from cell_image_analysis_tpu_torch.io.artifacts import cae_state_from_jax

    return cae_state_from_jax(cae_variables_from_keras(autoencoder))


def load_keras_cae(path: str):
    """A genuine Keras `.keras` / `.h5` autoencoder -> (CAE module on the
    CPU in eval mode, flax-layout numpy variables), as `io.artifacts.load_cae`
    returns for the store's own files.  The filters come from the file; the
    BatchNorm epsilon and momentum from its layers."""
    keras = require_keras()
    from cell_image_analysis_tpu_torch.io.artifacts import cae_state_from_jax
    from cell_image_analysis_tpu_torch.models.cae import CAE

    km = keras.models.load_model(path, compile=False)
    variables = cae_variables_from_keras(km)
    bns = _layers(km, "BatchNormalization")
    n_enc = len(bns) // 2
    convs = sorted((k for k in variables["params"] if k.startswith("Conv_")), key=natural_key)
    filters = [int(variables["params"][k]["kernel"].shape[-1]) for k in convs]
    model = CAE(encoder_filters=tuple(filters[:n_enc]), decoder_filters=tuple(filters[n_enc:-1]),
                bn_epsilon=float(bns[0].epsilon), bn_momentum=float(bns[0].momentum))
    model.load_state_dict(cae_state_from_jax(variables))
    return model.eval(), variables


def export_keras_cae(model, path: str) -> None:
    """Write the port's CAE `model` as a genuine Keras `.keras` file that the
    reference's `keras.models.load_model` reads."""
    from cell_image_analysis_tpu_torch.io.artifacts import cae_state_to_jax

    variables = cae_state_to_jax(model.state_dict())
    autoencoder, _ = build_keras_cae(encoder_filters=tuple(model.encoder_filters),
                                     decoder_filters=tuple(model.decoder_filters))
    for i, layer in enumerate(_layers(autoencoder, "Conv2D")):
        p = variables["params"][f"Conv_{i}"]
        layer.set_weights([p["kernel"], p["bias"]])
    for i, layer in enumerate(_layers(autoencoder, "BatchNormalization")):
        p = variables["params"][f"BatchNorm_{i}"]
        s = variables["batch_stats"][f"BatchNorm_{i}"]
        layer.set_weights([p["scale"], p["bias"], s["mean"], s["var"]])
    autoencoder.save(path)


# ----------------------------------------------------------- the U-Net --

def unet_state_from_keras(model) -> dict:
    """A StarDist-architecture Keras U-Net (convs only) -> the state dict of
    `models.unet.StarDistUNet`."""
    from cell_image_analysis_tpu_torch.io.artifacts import unet_state_from_jax

    return unet_state_from_jax(_conv_params(model))


def keras_unet_from_state(state: dict, input_size: int = 256, **arch):
    """The Keras twin U-Net with the weights of a `StarDistUNet` state dict."""
    from cell_image_analysis_tpu_torch.io.artifacts import unet_params_to_jax

    km = build_keras_stardist_unet(input_size=input_size, **arch)
    convs = _layers(km, "Conv2D")
    params = unet_params_to_jax(state)
    names = sorted(params, key=natural_key)
    if len(names) != len(convs):
        raise ValueError(f"layer count mismatch: the state has {len(names)} convs, "
                         f"the Keras twin {len(convs)}")
    for name, layer in zip(names, convs):
        layer.set_weights([params[name]["kernel"], params[name]["bias"]])
    return km


# ------------------------------------------------------ sklearn estimators --

def convert_sklearn_scaler(sk):
    """sklearn `RobustScaler` -> `models.scaler.RobustScaler`."""
    from cell_image_analysis_tpu_torch.models.scaler import RobustScaler

    return RobustScaler(center_=np.asarray(sk.center_, np.float32),
                        scale_=np.asarray(sk.scale_, np.float32))


def convert_sklearn_pca(sk):
    """sklearn `PCA` -> `models.pca.PCA`."""
    from cell_image_analysis_tpu_torch.models.pca import PCA

    return PCA(n_components=int(sk.n_components_),
               mean_=np.asarray(sk.mean_, np.float32),
               components_=np.asarray(sk.components_, np.float32),
               explained_variance_=np.asarray(sk.explained_variance_, np.float32),
               explained_variance_ratio_=np.asarray(sk.explained_variance_ratio_, np.float32))


def convert_sklearn_ocsvm(sk):
    """A fitted RBF sklearn `OneClassSVM` -> `models.svm.OneClassSVM`
    (dual_coef_ = alpha, intercept_ = -rho: libsvm's convention is the
    port's, so the parameters copy)."""
    from cell_image_analysis_tpu_torch.models.svm import OneClassSVM

    if getattr(sk, "kernel", "rbf") != "rbf":
        raise ValueError(f"only an rbf OneClassSVM is supported, got {sk.kernel!r}")
    gamma = float(getattr(sk, "_gamma", getattr(sk, "gamma_", 0.0)))
    if gamma == 0.0:
        raise ValueError("could not recover the fitted gamma from the sklearn model")
    return OneClassSVM(nu=float(getattr(sk, "nu", 0.5)), gamma_=gamma,
                       support_vectors_=np.asarray(sk.support_vectors_, np.float32),
                       dual_coef_=np.asarray(sk.dual_coef_, np.float32).reshape(-1),
                       intercept_=float(np.asarray(sk.intercept_).reshape(-1)[0]))


_CONVERTERS = {"RobustScaler": convert_sklearn_scaler, "PCA": convert_sklearn_pca,
               "OneClassSVM": convert_sklearn_ocsvm}


def convert_estimator(obj):
    """An sklearn estimator -> the port's class; anything else unchanged."""
    if not (type(obj).__module__ or "").startswith("sklearn"):
        return obj
    name = type(obj).__name__
    if name not in _CONVERTERS:
        raise ValueError(f"unsupported sklearn artifact: {name}")
    return _CONVERTERS[name](obj)
