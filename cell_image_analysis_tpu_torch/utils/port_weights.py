"""Keras HDF5 weights -> the port's StarDist U-Net.

Counterpart of `cell_image_analysis_tpu/utils/port_weights.py`.  The
reference downloads the pretrained StarDist `2D_versatile_fluo` at run
time; a user who holds its `weights_best.h5` converts it here instead
(`scripts/port_stardist_h5_torch.py`).  Keras stores conv kernels in HWIO,
the port's modules hold OIHW.  The h5 layers are paired with the port's
`Conv_0` .. `Conv_14` in order, each with the first unused h5 conv layer of
the same kernel shape; any mismatch raises with the pairs made so far.
`h5py` is imported only inside the functions that read or write a file.
"""

from __future__ import annotations

import numpy as np

from cell_image_analysis_tpu_torch.io.keras_interop import natural_key


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing a Keras .h5 weights file needs the h5py "
                          "package") from e
    return h5py


def load_keras_h5_weights(path: str) -> list[tuple[str, list[np.ndarray]]]:
    """A Keras HDF5 weights file (or whole-model file: its `model_weights`)
    -> [(layer_name, [arrays...])] in stored layer order."""
    out: list[tuple[str, list[np.ndarray]]] = []
    with _h5py().File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = root.attrs.get("layer_names")
        if names is None:
            # no creation-order attribute: group names in natural order (h5py
            # iterates alphabetically, which puts conv2d_10 before conv2d_2)
            names = sorted(root.keys(), key=natural_key)
        for raw in names:
            name = raw.decode() if isinstance(raw, bytes) else str(raw)
            g = root[name]
            arrays = [np.array(g[wn.decode() if isinstance(wn, bytes) else str(wn)])
                      for wn in g.attrs.get("weight_names", [])]
            if not arrays:  # any datasets below this group, in stored order
                def collect(group, acc):
                    for k in group:
                        item = group[k]
                        if hasattr(item, "shape"):
                            acc.append(np.array(item))
                        else:
                            collect(item, acc)
                collect(g, arrays)
            if arrays:
                out.append((name, arrays))
    return out


def _conv_names(state: dict) -> list[str]:
    """The U-Net's conv layers (`convs.<name>.weight`) in creation order."""
    names = [k.split(".")[1] for k in state if k.endswith(".weight")]
    return sorted(names, key=natural_key)


def port_conv_weights(state: dict, h5_layers: list[tuple[str, list[np.ndarray]]]) -> dict:
    """A new `StarDistUNet` state dict with the h5 conv (kernel, bias) pairs
    put onto `state`'s layers by shape-matched pairing in order."""
    import torch

    from cell_image_analysis_tpu_torch.io.artifacts import _hwio_to_oihw

    targets = _conv_names(state)
    sources = [(name, arrs) for name, arrs in h5_layers if arrs and arrs[0].ndim == 4]
    if len(sources) < len(targets):
        raise ValueError(f"H5 file has {len(sources)} conv layers; model needs {len(targets)}")
    new = {k: v.clone() for k, v in state.items()}
    used = [False] * len(sources)
    report = []
    for tname in targets:
        co, ci, kh, kw = state[f"convs.{tname}.weight"].shape
        kshape = (kh, kw, ci, co)
        match = next((i for i, (_, arrs) in enumerate(sources)
                      if not used[i] and tuple(arrs[0].shape) == kshape), None)
        if match is None:
            raise ValueError(f"no unused H5 conv layer with kernel shape {kshape} for "
                             f"{tname}; assignments so far: {report}")
        used[match] = True
        sname, arrs = sources[match]
        report.append((tname, sname))
        new[f"convs.{tname}.weight"] = _hwio_to_oihw(arrs[0])
        if len(arrs) > 1:
            new[f"convs.{tname}.bias"] = torch.tensor(np.asarray(arrs[1], np.float32))
    return new


def save_keras_style_h5(path: str, state: dict) -> None:
    """Write a minimal Keras-style HDF5 weights file (HWIO kernels, layer
    names in creation order) from a `StarDistUNet` state dict."""
    from cell_image_analysis_tpu_torch.io.artifacts import unet_params_to_jax

    params = unet_params_to_jax(state)
    names = sorted(params, key=natural_key)
    with _h5py().File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names], dtype="S64")
        for name in names:
            g = f.create_group(name)
            wn = []
            for key in ("kernel", "bias"):
                ds = f"{name}/{key}:0"
                g.create_dataset(ds, data=params[name][key])
                wn.append(ds.encode())
            g.attrs["weight_names"] = np.array(wn, dtype="S128")
