"""The reference's networks in plain PyTorch: the StarDist U-Net and the CAE.

Both read the weight files themselves (the U-Net pickle's flax layout,
HWIO kernels; the scoring npz's `cae/...` arrays) and run `F.conv2d` in
NCHW, so no kernel of the program runs here.  The precision is the
caller's: float32 with TF32 off for the reference (the configuration's),
TF32 on for the control (`tf32`).
"""

from __future__ import annotations

import contextlib
import hashlib
import pickle

import numpy as np
import torch
import torch.nn.functional as F


def checked_bytes(path: str, sha256: str) -> bytes:
    """The file's bytes; raises if their sha256 is not `sha256`."""
    with open(path, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise ValueError(f"{path}: sha256 {got}, expected {sha256}")
    return data


def checked_weights(weights: dict, root: str) -> dict:
    """{key: path under `root`} of each key of a configuration's `weights`
    that has a `<key>_sha256` beside it, each file's sha256 checked."""
    paths = {}
    for key, rel in weights.items():
        if f"{key}_sha256" in weights:
            paths[key] = f"{root}/{rel}"
            checked_bytes(paths[key], weights[f"{key}_sha256"])
    return paths


def load_unet(path: str, device) -> dict:
    """{'Conv_i': (OIHW weight, bias)} float32 tensors on `device`, from a
    U-Net pickle whose sha256 the caller has checked (`checked_weights`)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    out = {}
    for name, layer in payload["params"].items():
        k = np.asarray(layer["kernel"], np.float32).transpose(3, 2, 0, 1)
        out[name] = (torch.tensor(np.ascontiguousarray(k), device=device),
                     torch.tensor(np.asarray(layer["bias"], np.float32), device=device))
    return out


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for convolutions and matmuls inside the block, as `enabled`."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _conv(h: torch.Tensor, layer: tuple) -> torch.Tensor:
    w, b = layer
    return F.conv2d(h, w, b, padding=w.shape[-1] // 2)


@torch.no_grad()
def unet_forward(x: torch.Tensor, params: dict, depth: int) -> tuple:
    """x (B, 1, H, W), sides multiples of 2**depth -> (prob (B, H/2, W/2),
    feat (B, head, H/2, W/2)).  Two 3x3 convs + ReLU a level, 2x2 max
    pools, nearest 2x upsampling beside the skip (upsampled first), the
    decoder up to the grid's level, a 3x3 head conv + ReLU and a sigmoid
    1x1 probability head."""
    def block(h, i):
        h = torch.relu(_conv(h, params[f"Conv_{i}"]))
        return torch.relu(_conv(h, params[f"Conv_{i + 1}"]))

    skips, h, i = [], x, 0
    for _ in range(depth):
        h = block(h, i)
        skips.append(h)
        h = F.max_pool2d(h, 2)
        i += 2
    h = block(h, i)
    i += 2
    for lvl in reversed(range(1, depth)):
        skip = skips[lvl]
        up = F.interpolate(h, scale_factor=2, mode="nearest")[..., :skip.shape[2], :skip.shape[3]]
        h = block(torch.cat([up, skip], dim=1), i)
        i += 2
    feat = torch.relu(_conv(h, params[f"Conv_{i}"]))
    prob = torch.sigmoid(_conv(feat, params[f"Conv_{i + 1}"]))[:, 0]
    return prob, feat, params[f"Conv_{i + 2}"]


def dist_head(feat_rows: torch.Tensor, layer: tuple) -> torch.Tensor:
    """The ray distances of gathered feature rows (N, head): softplus of
    the 1x1 dist head."""
    w, b = layer
    return F.softplus(feat_rows @ w[:, :, 0, 0].t() + b)


def load_scoring(path: str) -> dict:
    """The scoring npz's arrays (numpy), from a file whose sha256 the
    caller has checked (`checked_weights`)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class CAE:
    """The CAE's eval-mode forward from the npz's `cae/` arrays: encoder
    3 x [3x3 conv, ReLU, BatchNorm, 2x2 max pool], decoder 3 x [3x3 conv,
    ReLU, BatchNorm, nearest 2x upsample], a 3x3 conv and a sigmoid.
    BatchNorm in inference form with eps 1e-3 (Keras)."""

    def __init__(self, arrays: dict, device):
        def t(key):
            return torch.tensor(np.asarray(arrays[key], np.float32), device=device)

        n = sum(1 for k in arrays if k.startswith("cae/params/Conv_") and k.endswith("/kernel"))
        self.convs = [(t(f"cae/params/Conv_{i}/kernel").permute(3, 2, 0, 1).contiguous(),
                       t(f"cae/params/Conv_{i}/bias")) for i in range(n)]
        self.bns = [(t(f"cae/params/BatchNorm_{i}/scale"), t(f"cae/params/BatchNorm_{i}/bias"),
                     t(f"cae/batch_stats/BatchNorm_{i}/mean"),
                     t(f"cae/batch_stats/BatchNorm_{i}/var")) for i in range(n - 1)]
        self.n_enc = (n - 1) // 2

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> tuple:
        """x (B, 1, 64, 64) -> (reconstruction (B, 1, 64, 64), encoded
        features (B, 2048) flattened in (row, column, channel) order)."""
        h, enc = x, None
        for i, (scale, bias, mean, var) in enumerate(self.bns):
            h = torch.relu(_conv(h, self.convs[i]))
            h = ((h - mean[:, None, None]) * (torch.rsqrt(var + 1e-3) * scale)[:, None, None]
                 + bias[:, None, None])
            if i < self.n_enc:
                h = F.max_pool2d(h, 2)
            else:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            if i == self.n_enc - 1:
                enc = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return torch.sigmoid(_conv(h, self.convs[-1])), enc
