"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages read the same committed assets: the U-Net weights
(assets/unet_synthetic.pkl) and the scoring parameters
(assets/scoring_synthetic.npz).  Inputs are made with numpy from a seed and
handed to both sides as arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cell_image_analysis_tpu.config import SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import SCORING_PARAMS_PATH

# the screening bench's StarDist settings (utils/bench.py _batch_pipeline)
BENCH_SEG = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
BENCH_STAGE_A = dict(label_capacity=128, cell_capacity=128, rcap=32)


def scoring_arrays() -> dict:
    with np.load(SCORING_PARAMS_PATH) as z:
        return {k: z[k] for k in z.files}


def jax_scoring():
    """(flax CAE, JAX ScoringParams) built from the committed npz."""
    import jax.numpy as jnp

    from cell_image_analysis_tpu.models.cae import CAE
    from cell_image_analysis_tpu.models.svm import SVMParams
    from cell_image_analysis_tpu.pipeline.scoring import ScoringParams

    a = scoring_arrays()
    cae: dict = {}
    for key, v in a.items():
        if key.startswith("cae/"):
            _, coll, layer, leaf = key.split("/")
            cae.setdefault(coll, {}).setdefault(layer, {})[leaf] = jnp.asarray(v)

    def svm(name):
        return SVMParams(*(jnp.asarray(a[f"svm_{name}/{f}"]) for f in SVMParams._fields))

    params = ScoringParams(
        cae_variables=cae,
        scaler_center=jnp.asarray(a["scaler_center"]),
        scaler_scale=jnp.asarray(a["scaler_scale"]),
        pca_mean=jnp.asarray(a["pca_mean"]),
        pca_components=jnp.asarray(a["pca_components"]),
        svm_conservative=svm("conservative"),
        svm_moderate=svm("moderate"),
        ensemble_mse_threshold=jnp.asarray(a["ensemble_mse_threshold"]),
        fft_scaler_center=jnp.asarray(a["fft_scaler_center"]),
        fft_scaler_scale=jnp.asarray(a["fft_scaler_scale"]),
        svm_fft=svm("fft"),
    )
    return CAE(), params


def padded_crops(rng, sizes, cap, scale=3000.0, garbage=1e9):
    """(C, cap, cap) integer-valued crops of the given (h, w) sizes, with
    garbage in the padding (it must not affect any result)."""
    crops = np.full((len(sizes), cap, cap), garbage, np.float32)
    for i, (h, w) in enumerate(sizes):
        crops[i, :h, :w] = np.round(rng.uniform(size=(h, w)) * scale)
    hs = np.array([s[0] for s in sizes], np.int32)
    ws = np.array([s[1] for s in sizes], np.int32)
    return crops, hs, ws


def torch_threads() -> None:
    """The suite runs under several xdist workers: one thread each."""
    torch.set_num_threads(1)


def unblock_filter(Ub: torch.Tensor) -> torch.Tensor:
    """`ops.winograd.kernel_filter_layout` undone: (Co_p/32, Ci_p/8, 16, 2,
    32, 4) -> (16, Ci_p, Co_p)."""
    cb, ch = Ub.shape[:2]
    return Ub.permute(2, 1, 3, 5, 0, 4).reshape(16, 8 * ch, 32 * cb)


def winograd_kernel_emulation(xp: torch.Tensor, U_hi: torch.Tensor, U_lo: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """The arithmetic of `csrc/winograd_conv3x3.cu` in float32 torch on the
    CPU, on the launcher's operands (`ops.winograd.pad_input`,
    `winograd_operands`): the input transform V = B^T d B with the kernel's
    adds, V split into TF32 halves, the three products lo*hi + hi*lo +
    hi*hi summed over Ci in float32, and the inverse transform plus bias,
    as the kernel's two warpgroups form it: the partial Y of position rows
    0-1 plus that of rows 2-3.  TF32 products are exact in float32, so only
    the order of the sums over Ci differs from the tensor cores."""
    from cell_image_analysis_tpu_torch.ops.winograd import tf32_split

    B, H, W, ci = xp.shape
    co = bias.shape[0]
    d = F.pad(xp, (0, 0, 1, 1, 1, 1)).unfold(1, 4, 2).unfold(2, 4, 2)  # (B, H/2, W/2, ci, 4, 4)
    rt = torch.stack([d[..., 0, :] - d[..., 2, :], d[..., 1, :] + d[..., 2, :],
                      d[..., 2, :] - d[..., 1, :], d[..., 1, :] - d[..., 3, :]], dim=-2)
    V = torch.stack([rt[..., 0] - rt[..., 2], rt[..., 1] + rt[..., 2],
                     rt[..., 2] - rt[..., 1], rt[..., 1] - rt[..., 3]], dim=-1)
    V = V.reshape(-1, ci, 16).permute(2, 0, 1)                             # (16, tiles, ci)
    V_hi, V_lo = tf32_split(V)
    U_hi, U_lo = unblock_filter(U_hi)[..., :co], unblock_filter(U_lo)[..., :co]
    M = V_lo @ U_hi + V_hi @ U_lo + V_hi @ U_hi                            # (16, tiles, co)
    m = M.permute(1, 2, 0).reshape(B, H // 2, W // 2, co, 4, 4)

    def partial(c0, c1):  # A^T's columns for the rows a with c0[a], c1[a] in output rows 0, 1
        g0 = sum(c * m[..., a, :] for a, c in enumerate(c0) if c)
        g1 = sum(c * m[..., a, :] for a, c in enumerate(c1) if c)
        return torch.stack([torch.stack([g[..., 0] + g[..., 1] + g[..., 2],
                                         g[..., 1] - g[..., 2] - g[..., 3]], dim=-1)
                            for g in (g0, g1)], dim=-2)                   # (..., co, 2, 2)

    y = partial((1, 1, 0, 0), (0, 1, 0, 0)) + partial((0, 0, 1, 0), (0, 0, -1, -1))
    y = y + bias[:, None, None]
    return y.permute(0, 1, 4, 2, 5, 3).reshape(B, H, W, co)


def winograd_3xtf32(x: torch.Tensor, W: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """What the CUDA route of `ops.winograd.winograd_conv3x3` computes, on
    the CPU: the wrapper's padding and operands, the kernel's arithmetic."""
    from cell_image_analysis_tpu_torch.ops.winograd import pad_input, winograd_operands

    h, w = x.shape[1:3]
    return winograd_kernel_emulation(pad_input(x), *winograd_operands(W, bias))[:, :h, :w]
