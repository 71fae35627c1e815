"""Convolutional autoencoder (inference), the reference's one trainable net.

Counterpart of `cell_image_analysis_tpu/models/cae.py`: 64x64x1 input,
encoder 3 x [3x3 conv + relu -> BatchNorm -> 2x2 max pool] with 32/64/32
filters (latent 8x8x32), decoder 3 x [3x3 conv + relu -> BatchNorm ->
nearest 2x upsample], then a 3x3 conv + sigmoid.  BatchNorm runs in eval
mode with Keras' eps 1e-3, in flax's form
`(x - mean) * (scale * rsqrt(var + eps)) + bias`.  Inputs and outputs are
NHWC; the encoded tensor is NHWC so its flattening matches JAX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _BatchNorm(nn.Module):
    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:             # NCHW
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class CAE(nn.Module):
    """forward(x (B, 64, 64, 1)) -> (decoded (B, 64, 64, 1), encoded (B, 8, 8, 32))."""

    def __init__(self, encoder_filters=(32, 64, 32), decoder_filters=(32, 64, 32),
                 bn_epsilon: float = 1e-3):
        super().__init__()
        chans = [1, *encoder_filters, *decoder_filters]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1)
                                   for a, b in zip(chans[:-1], chans[1:]))
        self.convs.append(nn.Conv2d(chans[-1], 1, 3, padding=1))
        self.bns = nn.ModuleList(_BatchNorm(c, bn_epsilon) for c in chans[1:])
        self.n_enc = len(encoder_filters)
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.bns)):
            h = self.bns[i](torch.relu(self.convs[i](h)))
            if i < self.n_enc:
                h = F.max_pool2d(h, 2)
                if i == self.n_enc - 1:
                    encoded = h.permute(0, 2, 3, 1)
            else:
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        decoded = torch.sigmoid(self.convs[-1](h))
        return decoded.permute(0, 2, 3, 1), encoded
