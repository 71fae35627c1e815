"""StarDist-style 2D U-Net with a probability head and a late dist head.

Counterpart of `cell_image_analysis_tpu/models/unet.py`: the plain layout
of `StarDistUNet.__call__` (depth 3, two 3x3 convs per level, 2x2 max
pools, nearest-2x upsampling with skip concatenation, a 3x3 conv head, and
1x1 prob/dist heads at grid (2, 2)), returning `(prob, feat)` as
`unet_apply_late` does; `dist_head_rows` applies the 32-ray head to
gathered feature rows only; `forward_train` returns the full-map heads
`(prob, dist)` as flax's `__call__` does, for training, and `unet_forward`
is the same without autograd, JAX's inference forward.  Activations are
NHWC throughout, and every 3x3 conv (Conv_0..Conv_12) goes through
`ops.winograd.winograd_conv3x3`, i.e. the Winograd CUDA kernel on the GPU,
with a gradient (`WinogradConv3x3Fn`) when grad mode is on: the inference
callers run without grad (`predict_instances`, and the screening and
extraction entry points under `torch.inference_mode`).  Each 3x3 conv is
followed by a ReLU, the op's `out_relu` (`_Conv.relu`): without grad the
kernel applies it at its store, under grad `torch.relu_` does, with the
same bits.  The 1x1 heads are matmuls.  The 2x2 max pool is
`F.max_pool2d`, whose gradient goes to the first maximum of a window, as
flax's `nn.max_pool` does.

Parameters keep the flax names (`convs.Conv_0` .. `convs.Conv_14`, OIHW);
`io.artifacts.unet_state_from_jax` maps the JAX weights onto them and
`unet_params_to_jax` back.  `init_unet` draws them as flax's default
init does (Glorot-uniform 3x3 kernels, truncated-normal LeCun 1x1
kernels, zero biases) from a seeded `torch.Generator` on the CPU, so one
seed gives the same module on every device (the draws cannot be JAX's).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cell_image_analysis_tpu_torch.ops import winograd


class _Conv(nn.Module):
    """Conv weights in OIHW with a bias; 3x3 runs through the Winograd op,
    1x1 as a matmul over the channel axis (NHWC)."""

    def __init__(self, ci: int, co: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, k, k))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[-1] == 3:
            return winograd.winograd_conv3x3(x, self.weight.permute(2, 3, 1, 0), self.bias)
        return torch.matmul(x, self.weight[:, :, 0, 0].t()) + self.bias

    def relu(self, x: torch.Tensor) -> torch.Tensor:
        """relu(conv(x)) of a 3x3 conv: the Winograd op's output ReLU."""
        return winograd.winograd_conv3x3(x, self.weight.permute(2, 3, 1, 0), self.bias,
                                         out_relu=True)


def _maxpool2(h: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of NHWC h with even sides; the gradient goes to the first
    maximum of a window in row-major order (an `amax` would split it among
    tied maxima)."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _up2(h: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NHWC h (`repeat_interleave` would wait on the
    device)."""
    b, hh, ww, c = h.shape
    return h[:, :, None, :, None].expand(b, hh, 2, ww, 2, c).reshape(b, 2 * hh, 2 * ww, c)


class StarDistUNet(nn.Module):
    """forward(x (B, H, W, 1), H and W multiples of 2**depth) ->
    (prob (B, H/2, W/2), feat (B, H/2, W/2, head_filters))."""

    def __init__(self, n_rays: int = 32, depth: int = 3, base_filters: int = 32,
                 head_filters: int = 128, grid: tuple = (2, 2)):
        super().__init__()
        if tuple(grid) != (2, 2):
            raise ValueError("StarDistUNet: only grid (2, 2) is supported")
        self.depth = depth
        self.grid = tuple(grid)
        convs, ci, i = {}, 1, 0
        for lvl in range(depth + 1):                 # encoder levels + middle
            f = base_filters * 2 ** lvl
            convs[f"Conv_{i}"] = _Conv(ci, f, 3)
            convs[f"Conv_{i + 1}"] = _Conv(f, f, 3)
            ci, i = f, i + 2
        for lvl in reversed(range(1, depth)):        # decoder stops at grid 2
            f = base_filters * 2 ** lvl
            convs[f"Conv_{i}"] = _Conv(ci + f, f, 3)
            convs[f"Conv_{i + 1}"] = _Conv(f, f, 3)
            ci, i = f, i + 2
        convs[f"Conv_{i}"] = _Conv(ci, head_filters, 3)
        convs[f"Conv_{i + 1}"] = _Conv(head_filters, 1, 1)
        convs[f"Conv_{i + 2}"] = _Conv(head_filters, n_rays, 1)
        self.convs = nn.ModuleDict(convs)
        self._head = i

    def _block(self, h: torch.Tensor, i: int) -> torch.Tensor:
        h = self.convs[f"Conv_{i}"].relu(h)
        return self.convs[f"Conv_{i + 1}"].relu(h)

    def forward(self, x: torch.Tensor):
        skips, h, i = [], x, 0
        for _ in range(self.depth):
            h = self._block(h, i)
            skips.append(h)
            h = _maxpool2(h)
            i += 2
        h = self._block(h, i)
        i += 2
        for lvl in reversed(range(1, self.depth)):
            skip = skips[lvl]
            h = torch.cat([_up2(h)[:, : skip.shape[1], : skip.shape[2]], skip], dim=-1)
            h = self._block(h, i)
            i += 2
        feat = self.convs[f"Conv_{self._head}"].relu(h)
        prob = torch.sigmoid(self.convs[f"Conv_{self._head + 1}"](feat))[..., 0]
        return prob, feat

    def forward_train(self, x: torch.Tensor):
        """x (B, H, W, 1) -> (prob (B, H/2, W/2), dist (B, H/2, W/2, n_rays)):
        both heads over every grid pixel, as flax's `__call__` returns them."""
        prob, feat = self(x)
        return prob, self.dist_head_rows(feat)

    def dist_head_rows(self, feat_rows: torch.Tensor) -> torch.Tensor:
        """The 32-ray dist head on gathered feature rows: (K, head_filters)
        -> (K, n_rays), softplus in the logaddexp(x, 0) form of JAX."""
        z = self.convs[f"Conv_{self._head + 2}"](feat_rows)
        return torch.logaddexp(z, torch.zeros_like(z))


def unet_forward(model: StarDistUNet, x: torch.Tensor) -> tuple:
    """The inference forward over the full maps, as JAX's `unet_forward`:
    x (B, H, W, 1) -> (prob (B, H/2, W/2), dist (B, H/2, W/2, n_rays)),
    without autograd (`forward_train`'s heads)."""
    with torch.no_grad():
        return model.forward_train(x)


def init_unet(seed: int, device=None, **arch) -> StarDistUNet:
    """A `StarDistUNet(**arch)` drawn as flax's default init does: 3x3
    kernels Glorot-uniform (limit sqrt(6 / (9 ci + 9 co))), the two 1x1
    heads LeCun-normal truncated at two standard deviations (std
    sqrt(1 / ci) / 0.8796...), biases zero; drawn from a CPU
    `torch.Generator` seeded with `seed`, then moved to `device` (default:
    the card)."""
    from cell_image_analysis_tpu_torch.io.artifacts import resolve_device

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = StarDistUNet(**arch)
    with torch.no_grad():
        for conv in model.convs.values():
            co, ci, kh, kw = conv.weight.shape
            if kh == 3:
                limit = math.sqrt(6.0 / (kh * kw * (ci + co)))
                conv.weight.copy_(torch.rand(conv.weight.shape, generator=gen) * (2 * limit)
                                  - limit)
            else:
                # jax.nn.initializers.lecun_normal: variance 1 / fan_in after
                # truncation to [-2, 2] standard deviations
                std = math.sqrt(1.0 / (ci * kh * kw)) / .87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            conv.bias.zero_()
    return model.to(device)
