"""Training augmentation (Keras `ImageDataGenerator`), on the device.

Counterpart of `cell_image_analysis_tpu/train/augment.py`, in two halves:

- `sample_params(generator, n, cfg)` draws the seven per-image parameters
  from a `torch.Generator`, on its device: rotation theta ~ U(-r, r)
  degrees (returned in radians), shifts ty, tx ~ U(-s, s) (fractions of
  the side), zooms zy, zx ~ U(1 - z, 1 + z) independently, and vertical /
  horizontal flips with p = 0.5 where enabled.  `jax.random` draws cannot
  be reproduced, so the port's draws differ from JAX's; the distributions
  are the same.
- `warp_batch(batch, params)` warps a (B, H, W, 1) batch: each output
  pixel samples the input at zoom(rot(centred coords)) + shift, flipped,
  with bilinear weights and coordinates clamped to the frame (Keras'
  'nearest' fill), in the float32 operations and order of JAX's warp.  It
  is a gather, as in JAX, where it is plain XLA and not a Pallas kernel.
  The rotation's cosine and sine are taken where the parameters lie, and
  they cross to the batch's device with the rest in one pinned buffer:
  the trainer draws on the CPU, so that a seed gives the same parameters
  on every device, and with the CPU's trigonometry (CUDA's `cosf` is not
  the CPU's to the last bit) the rest of the warp is exactly rounded
  elementwise arithmetic, so a warp on the card equals the CPU's bit for
  bit.

`augment_batch(generator, batch, cfg)` composes the two.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cell_image_analysis_tpu_torch.config import AugmentConfig


class AugmentParams(NamedTuple):
    """(B,) tensors: theta (radians), ty, tx, zy, zx float32; flips bool."""

    theta: torch.Tensor
    ty: torch.Tensor
    tx: torch.Tensor
    zy: torch.Tensor
    zx: torch.Tensor
    flip_h: torch.Tensor
    flip_v: torch.Tensor


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def sample_params(generator: torch.Generator, n: int,
                  cfg: AugmentConfig = AugmentConfig()) -> AugmentParams:
    theta = _uniform(generator, n, -cfg.rotation_range, cfg.rotation_range) * (math.pi / 180.0)
    ty = _uniform(generator, n, -cfg.height_shift_range, cfg.height_shift_range)
    tx = _uniform(generator, n, -cfg.width_shift_range, cfg.width_shift_range)
    zy = _uniform(generator, n, 1.0 - cfg.zoom_range, 1.0 + cfg.zoom_range)
    zx = _uniform(generator, n, 1.0 - cfg.zoom_range, 1.0 + cfg.zoom_range)
    fk = torch.rand((n, 2), generator=generator, device=generator.device)
    flip_h = (fk[:, 0] < 0.5) & bool(cfg.horizontal_flip)
    flip_v = (fk[:, 1] < 0.5) & bool(cfg.vertical_flip)
    return AugmentParams(theta, ty, tx, zy, zx, flip_h, flip_v)


def _to_device(packed: torch.Tensor, device) -> torch.Tensor:
    """`packed` on `device`: from the CPU to the card through pinned memory,
    without a wait."""
    if packed.device == device:
        return packed
    if packed.device.type == "cpu" and device.type == "cuda":
        packed = packed.pin_memory()
    return packed.to(device, non_blocking=True)


def warp_batch(batch: torch.Tensor, params) -> torch.Tensor:
    """Bilinear affine warp of a (B, H, W, 1) batch by `params` (an
    `AugmentParams` or the seven (B,) tensors in its order)."""
    b, h, w, _ = batch.shape
    dev = batch.device
    theta, *rest = params
    packed = torch.stack([torch.cos(theta.float()), torch.sin(theta.float()),
                          *(t.float() for t in rest)])     # the flips as 0 / 1
    cos, sin, dy, dx, sy, sx, fh, fv = _to_device(packed, dev)
    fh, fv = fh > 0.5, fv > 0.5
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y0 = ((yy - cy) * torch.ones_like(xx))[None]                    # (1, H, W)
    x0 = ((xx - cx) * torch.ones_like(yy))[None]

    def per(t):
        return t.float()[:, None, None]

    cos, sin = per(cos), per(sin)
    ys = (cos * y0 - sin * x0) * per(sy) + cy + per(dy) * h
    xs = (sin * y0 + cos * x0) * per(sx) + cx + per(dx) * w
    ys = torch.where(fv[:, None, None], (h - 1) - ys, ys)
    xs = torch.where(fh[:, None, None], (w - 1) - xs, xs)
    ys = torch.clamp(ys, 0.0, h - 1)  # 'nearest' fill = clamped sampling
    xs = torch.clamp(xs, 0.0, w - 1)
    y0i = torch.floor(ys).long()
    x0i = torch.floor(xs).long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    wy = ys - y0i
    wx = xs - x0i
    im = batch[..., 0].reshape(b, h * w)

    def at(r, c):
        return torch.gather(im, 1, (r * w + c).reshape(b, -1)).reshape(b, h, w)

    out = (at(y0i, x0i) * (1 - wy) * (1 - wx)
           + at(y0i, x1i) * (1 - wy) * wx
           + at(y1i, x0i) * wy * (1 - wx)
           + at(y1i, x1i) * wy * wx)
    return out[..., None]


def augment_batch(generator: torch.Generator, batch: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Random affine warp of a (B, H, W, 1) batch."""
    return warp_batch(batch, sample_params(generator, batch.shape[0], cfg))
