"""Convolutional autoencoder, the reference's one trainable net.

Counterpart of `cell_image_analysis_tpu/models/cae.py`: 64x64x1 input,
encoder 3 x [3x3 conv + relu -> BatchNorm -> 2x2 max pool] with 32/64/32
filters (latent 8x8x32), decoder 3 x [3x3 conv + relu -> BatchNorm ->
nearest 2x upsample], then a 3x3 conv + sigmoid.  Inputs and outputs are
NHWC; the encoded tensor is NHWC so its flattening matches JAX's.  The
convolutions are cuDNN's (float32, TF32 off) with autograd: in JAX they are
flax `nn.Conv`, not Pallas kernels.

BatchNorm follows flax (Keras) rather than `nn.BatchNorm2d`:

- eval mode normalizes with the running statistics in flax's form
  `(x - mean) * (scale * rsqrt(var + eps)) + bias`, eps 1e-3;
- train mode normalizes with the batch mean and the biased batch variance
  `max(mean(x^2) - mean^2, 0)` (flax's fast variance) and updates the
  running statistics, without grad, as `m * ra + (1 - m) * batch` with the
  same biased variance, m = 0.99 (flax's momentum; torch's own `momentum`
  would be 0.01, and `F.batch_norm` would keep the unbiased variance).

`init_cae` draws Glorot-uniform kernels and zero biases from an explicit
`torch.Generator`, as flax's default init does from a `jax.random` key
(the draws cannot be the same).

`forward_sharded` runs replicas of one CAE on the shards of a batch in
train mode with the global batch's BatchNorm statistics: the per-shard
sums of x and x^2 are added over the shards on the home device and sent
back (`all_reduce_sum`, whose gradient is the same sum of the shards'
gradients), as GSPMD's psum does for JAX's sharded BatchNorm.  The running
statistics are updated once, on the home replica, from the global ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """psum over shards: each output is the sum of all inputs, added in
    shard order on the home device and copied to the input's device; the
    gradient of each input is the same sum of the outputs' gradients."""

    @staticmethod
    def forward(ctx, home, *parts):
        ctx.home, ctx.devices = home, [p.device for p in parts]
        total = parts[0].to(home)
        for p in parts[1:]:
            total = total + p.to(home)
        return tuple(total.to(d, copy=True) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].to(ctx.home)
        for g in grads[1:]:
            total = total + g.to(ctx.home)
        return (None, *(total.to(d, copy=True) for d in ctx.devices))


def all_reduce_sum(parts: list, home: torch.device) -> tuple:
    """The sum of `parts` (one tensor a shard), back on each part's device,
    differentiable."""
    return _AllReduceSum.apply(home, *parts)


class _BatchNorm(nn.Module):
    def __init__(self, c: int, eps: float, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:             # NCHW
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return self.normalize(x, mean, var)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _batch_norm_sharded(bns: list, xs: list, home: torch.device) -> list:
    """Train-mode BatchNorm of NCHW shards `xs` with the statistics of their
    union (flax's biased variance max(E[x^2] - E[x]^2, 0)); each shard is
    normalized by its replica `bns[i]`, the home replica's running
    statistics move once."""
    count = sum(x.shape[0] * x.shape[2] * x.shape[3] for x in xs)
    sums = all_reduce_sum([torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))])
                           for x in xs], home)
    out, stats = [], []
    for bn, x, s in zip(bns, xs, sums):
        mean = s[0] / count
        var = torch.clamp(s[1] / count - mean * mean, min=0.0)
        stats.append((mean, var))
        out.append(bn.normalize(x, mean, var))
    bns[0].update_running(*stats[0])
    return out


class CAE(nn.Module):
    """forward(x (B, 64, 64, 1)) -> (decoded (B, 64, 64, 1), encoded (B, 8, 8, 32))."""

    def __init__(self, encoder_filters=(32, 64, 32), decoder_filters=(32, 64, 32),
                 bn_epsilon: float = 1e-3, bn_momentum: float = 0.99):
        super().__init__()
        self.encoder_filters = tuple(encoder_filters)
        self.decoder_filters = tuple(decoder_filters)
        self.bn_epsilon = bn_epsilon
        self.bn_momentum = bn_momentum
        chans = [1, *encoder_filters, *decoder_filters]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1)
                                   for a, b in zip(chans[:-1], chans[1:]))
        self.convs.append(nn.Conv2d(chans[-1], 1, 3, padding=1))
        self.bns = nn.ModuleList(_BatchNorm(c, bn_epsilon, bn_momentum) for c in chans[1:])
        self.n_enc = len(encoder_filters)

    def resample(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Block i's 2x2 max pool (encoder) or nearest 2x upsample (decoder;
        repeat_interleave would wait on the device)."""
        if i < self.n_enc:
            return F.max_pool2d(h, 2)
        b, c, hh, ww = h.shape
        return h[:, :, :, None, :, None].expand(b, c, hh, 2, ww, 2).reshape(b, c, 2 * hh, 2 * ww)

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.bns)):
            h = self.resample(i, self.bns[i](torch.relu(self.convs[i](h))))
            if i == self.n_enc - 1:
                encoded = h.permute(0, 2, 3, 1)
        decoded = torch.sigmoid(self.convs[-1](h))
        return decoded.permute(0, 2, 3, 1), encoded


def forward_sharded(replicas: list, xs: list) -> list:
    """Train-mode forward of the batch whose shards are `xs` ((b_i, 64, 64,
    1), each on its replica's device) through `replicas` of one CAE (one a
    shard; shards on one device may share one): every BatchNorm takes the
    whole batch's statistics, so each shard's output equals its rows of
    the unsharded forward up to the summation order.  Returns [(decoded,
    encoded)] a shard."""
    home = xs[0].device
    net = replicas[0]
    hs = [x.permute(0, 3, 1, 2) for x in xs]
    encoded = None
    for i in range(len(net.bns)):
        hs = [torch.relu(r.convs[i](h)) for r, h in zip(replicas, hs)]
        hs = _batch_norm_sharded([r.bns[i] for r in replicas], hs, home)
        hs = [net.resample(i, h) for h in hs]
        if i == net.n_enc - 1:
            encoded = [h.permute(0, 2, 3, 1) for h in hs]
    return [(torch.sigmoid(r.convs[-1](h)).permute(0, 2, 3, 1), e)
            for r, h, e in zip(replicas, hs, encoded)]


def init_cae(generator: torch.Generator, input_size: int = 64, encoder_filters=(32, 64, 32),
             decoder_filters=(32, 64, 32), bn_momentum: float = 0.99,
             bn_epsilon: float = 1e-3) -> CAE:
    """A CAE with Glorot-uniform kernels (limit sqrt(6 / (9 ci + 9 co))) and
    zero biases drawn from `generator`, BatchNorm scale 1, bias 0 and
    running statistics (0, 1), on the generator's device.  `input_size`
    is taken for JAX's signature: the net is fully convolutional."""
    model = CAE(encoder_filters, decoder_filters, bn_epsilon=bn_epsilon,
                bn_momentum=bn_momentum).to(generator.device)
    with torch.no_grad():
        for conv in model.convs:
            co, ci, kh, kw = conv.weight.shape
            limit = math.sqrt(6.0 / (kh * kw * (ci + co)))
            w = torch.rand(conv.weight.shape, generator=generator, device=generator.device)
            conv.weight.copy_(w * (2 * limit) - limit)
            conv.bias.zero_()
    return model


@torch.no_grad()
def _chunked(model: CAE, x: torch.Tensor, fn, chunk: int):
    was_training = model.training
    model.eval()
    try:
        return [fn(*model(x[s:s + chunk].float()), x[s:s + chunk].float())
                for s in range(0, x.shape[0], chunk)]
    finally:
        model.train(was_training)


def reconstruction_errors(model: CAE, x: torch.Tensor, chunk: int = 1024):
    """Per-cell reconstruction MSE and MAE over (H, W, C) of x (B, 64, 64,
    1), in eval mode, `chunk` cells a forward pass on x's device."""
    def errs(recon, _, xc):
        diff = xc - recon
        return (diff * diff).mean(dim=(1, 2, 3)), diff.abs().mean(dim=(1, 2, 3))

    parts = _chunked(model, x, errs, chunk)
    if not parts:
        empty = torch.zeros(0, device=x.device)
        return empty, empty
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def encode(model: CAE, x: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """The flattened 2048-d encoder features of x (B, 64, 64, 1), in eval
    mode, `chunk` cells a forward pass on x's device."""
    parts = _chunked(model, x, lambda _, enc, xc: enc.reshape(enc.shape[0], -1), chunk)
    if not parts:
        return torch.zeros((0, model.encoder_filters[-1] * (x.shape[1] // 8) ** 2),
                           device=x.device)
    return torch.cat(parts)
