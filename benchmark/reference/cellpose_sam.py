"""The plain reference of Cellpose-SAM's segmentation (Cellpose 4's `cpsam`),
one frame at a time, in plain PyTorch, NumPy and SciPy.  Nothing of the
program is imported.

Written from MouseLand/cellpose 4 (`vit_sam.Transformer.forward`) and
facebookresearch/segment-anything (`modeling/image_encoder.py`: `PatchEmbed`,
`Block`, `Attention`, `get_rel_pos`, `add_decomposed_rel_pos`; `common.py`:
`MLPBlock`, `LayerNorm2d`), with every block's window 0 (global attention):

- the network on tiles (B, 3, 256, 256), NCHW as SAM runs it: the patch
  embedding `F.conv2d` (k 8, s 8) plus the position embedding; each block
  x + proj(attention(LN1 x)), x + lin2(GELU(lin1(LN2 x))) (LayerNorm eps
  1e-6, erf GELU); the attention materialised, (q scale) k^T, SAM's
  decomposed relative position added (the tables resized to 63 rows by
  linear interpolation at every forward, the bias from the unscaled q),
  softmax, times v; the neck (1x1 conv, LayerNorm2d, 3x3 conv pad 1,
  LayerNorm2d, as SAM's formula), the 1x1 readout and
  `F.conv_transpose2d` with the identity W2; float32 with both TF32 flags
  off unless the control asks;
- the tiles: normalize99 into channel 0, channels 1-2 zeros, then Cellpose
  3's padding, tiles (256^2 at 10% overlap), taper blend and crop, and the
  dynamics (`compute_masks`), from `reference/cellpose.py` by import.

The weights: the file's arrays as float32; each large matrix stored as
factors `<name>.lowrank_a` (co, r) and `<name>.lowrank_b` (r, ci) is
rebuilt as randn((co, ci)) * 0.02 from `torch.Generator().manual_seed(
base_seed + 4 x block + [qkv, proj, lin1, lin2].index(part))` on the CPU,
plus A @ B on the CPU.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.cellpose import (
    average_tiles,
    compute_masks,
    make_tiles,
    normalize99,
    pad_image_nd,
)

PARTS = ("attn.qkv", "attn.proj", "mlp.lin1", "mlp.lin2")
EPS = 1e-6


def merged_arrays(path: str) -> dict:
    """{Cellpose-SAM state-dict name: float32 CPU tensor} of a weight file,
    the large matrices rebuilt from their seeded bases and factors."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        seed = int(z["lowrank.base_seed"]) if "lowrank.base_seed" in z.files else None
        for key in z.files:
            if key in ("meta", "lowrank.base_seed") or key.endswith(".lowrank_b"):
                continue
            if not key.endswith(".lowrank_a"):
                out[key] = torch.as_tensor(z[key].astype(np.float32))
                continue
            name = key[:-len(".lowrank_a")]
            a = torch.as_tensor(z[key].astype(np.float32))
            b = torch.as_tensor(z[f"{name}.lowrank_b"].astype(np.float32))
            m = re.fullmatch(r"encoder\.blocks\.(\d+)\.(.+)\.weight", name)
            gen = torch.Generator().manual_seed(seed + 4 * int(m.group(1))
                                                + PARTS.index(m.group(2)))
            out[name] = torch.randn((a.shape[0], b.shape[1]), generator=gen) * 0.02 + a @ b
    return out


def load(path: str, device) -> dict:
    """The merged weights as float32 tensors on `device`."""
    return {k: v.to(device) for k, v in merged_arrays(path).items()}


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1), size=max_rel_dist,
            mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


def attention(s: dict, pre: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, H, W, _ = x.shape
    qkv = F.linear(x, s[pre + "qkv.weight"], s[pre + "qkv.bias"])
    qkv = qkv.reshape(B, H * W, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, q, s[pre + "rel_pos_h"], s[pre + "rel_pos_w"], (H, W),
                                  (H, W))
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    return F.linear(x, s[pre + "proj.weight"], s[pre + "proj.bias"])


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    u = x.mean(1, keepdim=True)
    v = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(v + EPS)
    return weight[:, None, None] * x + bias[:, None, None]


def n_blocks(s: dict) -> int:
    n = 0
    while f"encoder.blocks.{n}.norm1.weight" in s:
        n += 1
    return n


def vit_sam(s: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, T, T) tiles -> (B, 3, T, T): (dy, dx, cellprob)."""
    pw = s["encoder.patch_embed.proj.weight"]
    ps = pw.shape[-1]
    x = F.conv2d(x, pw, s["encoder.patch_embed.proj.bias"], stride=ps).permute(0, 2, 3, 1)
    x = x + s["encoder.pos_embed"]
    dim = x.shape[-1]
    for i in range(n_blocks(s)):
        pre = f"encoder.blocks.{i}."
        heads = dim // s[pre + "attn.rel_pos_h"].shape[1]
        h = F.layer_norm(x, (dim,), s[pre + "norm1.weight"], s[pre + "norm1.bias"], EPS)
        x = x + attention(s, pre + "attn.", h, heads)
        h = F.layer_norm(x, (dim,), s[pre + "norm2.weight"], s[pre + "norm2.bias"], EPS)
        h = F.linear(F.gelu(F.linear(h, s[pre + "mlp.lin1.weight"], s[pre + "mlp.lin1.bias"])),
                     s[pre + "mlp.lin2.weight"], s[pre + "mlp.lin2.bias"])
        x = x + h
    x = x.permute(0, 3, 1, 2)
    x = layer_norm_2d(F.conv2d(x, s["encoder.neck.0.weight"]), s["encoder.neck.1.weight"],
                      s["encoder.neck.1.bias"])
    x = layer_norm_2d(F.conv2d(x, s["encoder.neck.2.weight"], padding=1),
                      s["encoder.neck.3.weight"], s["encoder.neck.3.bias"])
    x1 = F.conv2d(x, s["out.weight"], s["out.bias"])
    nc = x1.shape[1]
    W2 = torch.eye(nc, device=x1.device).reshape(nc, nc // (ps * ps), ps, ps)
    return F.conv_transpose2d(x1, W2, stride=ps, padding=0)


def run_net(s: dict, frame: np.ndarray, cfg: dict, device) -> np.ndarray:
    """(3, H, W) float32 network output of one raw (H, W) frame."""
    zeros = np.zeros(frame.shape, np.float32)
    img = np.stack([normalize99(frame, cfg["norm_pmin"], cfg["norm_pmax"]), zeros, zeros])
    img, sy, sx = pad_image_nd(img)
    tiles, ysub, xsub = make_tiles(img, cfg["tile"], cfg["tile_overlap"])
    y = np.zeros((len(tiles), 3) + tiles.shape[-2:])
    step = 25
    with torch.no_grad():
        for k in range(0, len(tiles), step):
            out = vit_sam(s, torch.as_tensor(tiles[k:k + step], device=device))
            y[k:k + step] = out.cpu().numpy()
    yf = average_tiles(y, ysub, xsub, img.shape[-2], img.shape[-1])
    return yf[:, sy, sx]


def labels(state: dict, frame: np.ndarray, cfg: dict, device) -> np.ndarray:
    """One raw (H, W) frame's int32 label map."""
    y = run_net(state, frame, cfg, device)
    return compute_masks(y[:2], y[2], cfg, device)
