"""StarDist-style 2D U-Net with a probability head and a late dist head.

Counterpart of `cell_image_analysis_tpu/models/unet.py`: the plain layout
of `StarDistUNet.__call__` (depth 3, two 3x3 convs per level, 2x2 max
pools, nearest-2x upsampling with skip concatenation, a 3x3 conv head, and
1x1 prob/dist heads at grid (2, 2)), returning `(prob, feat)` as
`unet_apply_late` does; `dist_head_rows` applies the 32-ray head to
gathered feature rows only.  Activations are NHWC throughout, and every
3x3 conv (Conv_0..Conv_12) goes through `ops.winograd.winograd_conv3x3`,
i.e. the Winograd CUDA kernel on the GPU.  The 1x1 heads are matmuls.

Parameters keep the flax names (`convs.Conv_0` .. `convs.Conv_14`, OIHW);
`io.artifacts.unet_state_from_jax` maps the JAX weights onto them.
"""

from __future__ import annotations

import torch
from torch import nn

from cell_image_analysis_tpu_torch.ops.winograd import winograd_conv3x3


class _Conv(nn.Module):
    """Conv weights in OIHW with a bias; 3x3 runs through the Winograd op,
    1x1 as a matmul over the channel axis (NHWC)."""

    def __init__(self, ci: int, co: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(co), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[-1] == 3:
            return winograd_conv3x3(x, self.weight.permute(2, 3, 1, 0), self.bias)
        return torch.matmul(x, self.weight[:, :, 0, 0].t()) + self.bias


def _maxpool2(h: torch.Tensor) -> torch.Tensor:
    b, hh, ww, c = h.shape
    return h.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def _up2(h: torch.Tensor) -> torch.Tensor:
    return h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


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
        h = torch.relu_(self.convs[f"Conv_{i}"](h))
        return torch.relu_(self.convs[f"Conv_{i + 1}"](h))

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
        feat = torch.relu_(self.convs[f"Conv_{self._head}"](h))
        prob = torch.sigmoid(self.convs[f"Conv_{self._head + 1}"](feat))[..., 0]
        return prob, feat

    def dist_head_rows(self, feat_rows: torch.Tensor) -> torch.Tensor:
        """The 32-ray dist head on gathered feature rows: (K, head_filters)
        -> (K, n_rays), softplus in the logaddexp(x, 0) form of JAX."""
        z = self.convs[f"Conv_{self._head + 2}"](feat_rows)
        return torch.logaddexp(z, torch.zeros_like(z))
