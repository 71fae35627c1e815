"""Cellpose 3's network (`CPnet`) and its tiled inference, for the port's
third segmentation backend (`models.segmentation.CellposeBackend`).

The JAX package has no counterpart.  The source is MouseLand/cellpose:
`resnet_torch.CPnet` (the `cyto3` model's network, nbase 2-32-64-128-256)
and `core.run_net` / `_run_tiled` with `transforms.normalize99`,
`pad_image_ND`, `make_tiles`, `_taper_mask` and `average_tiles`.

- Every conv is pre-activation: `_BC` is BatchNorm (eval: running
  statistics, eps 1e-5), ReLU, then the conv (SAME, bias); the 1x1
  projections leave out the ReLU.  Activations are NHWC, as in
  `models/unet.py`, and every 3x3 conv (32 of them) goes through
  `ops.winograd.winograd_conv3x3`, the Winograd kernel on the card; a 1x1
  conv is a matmul over the channels.  A 3x3 `_BC` hands its BatchNorm
  (and a style term, `_StyleBC`) to the conv as a per-channel scale and a
  per-channel or per-tile shift, with the ReLU: without grad the kernel
  applies them to its input patch, so the normalized map is never
  written; under grad the op runs them in PyTorch before the conv.
- The encoder is four residual blocks (`_ResDown`) with a 2x2 max pool
  before blocks 1-3; the style is the mean of the last block's map over
  its pixels, over its L2 norm; the decoder is four residual blocks
  (`_ResUp`) with a nearest 2x upsample before blocks 2, 1 and 0, in
  which the style enters three of the four convs through a linear map,
  and the first of those also takes the skip connection; a 1x1 conv gives
  (dy, dx, cellprob).
- `run_tiled` normalizes each frame (`normalize99`: the 1st and 99th
  percentile by numpy's float32 linear interpolation, from the radix
  select of `ops.percentile`), pads it with zeros to a multiple of 16 plus
  8 px a side, cuts the padded frames into `tile`^2 tiles at
  `tile_overlap`, runs the tiles of all frames through the network
  `tile_chunk` a call, and blends them back with the sigmoid taper mask.

Parameters follow Cellpose's state-dict names through
`cellpose_state_from_numpy`, which maps a NumPy dict of those names (what
`scripts/make_cellpose_weights_torch.py` writes) onto the module.  In
training mode BatchNorm uses the batch's statistics and updates the running
ones with momentum 0.05 (`train/cellpose_trainer.py`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from cell_image_analysis_tpu_torch.models.unet import _maxpool2, _up2
from cell_image_analysis_tpu_torch.ops import winograd
from cell_image_analysis_tpu_torch.ops.percentile import kth_smallest
from cell_image_analysis_tpu_torch.utils.profiler import count, span

BN_EPS = 1e-5
BN_MOMENTUM = 0.05
PAD_DIV = 16          # pad_image_ND: div 16, extra 1


class _BC(nn.Module):
    """Cellpose's `batchconv` (BN, ReLU, k x k conv) or, with relu=False,
    `batchconv0` (BN, conv; 1x1 only), on NHWC maps."""

    def __init__(self, ci: int, co: int, k: int, relu: bool = True):
        super().__init__()
        if k == 3 and not relu:
            raise ValueError("_BC: a 3x3 conv takes its BatchNorm and ReLU as the Winograd "
                             "op's input prologue, which always has the ReLU")
        self.relu = relu
        self.bn_weight = nn.Parameter(torch.ones(ci))
        self.bn_bias = nn.Parameter(torch.zeros(ci))
        self.register_buffer("bn_mean", torch.zeros(ci))
        self.register_buffer("bn_var", torch.ones(ci))
        self.weight = nn.Parameter(torch.zeros(co, ci, k, k))
        self.bias = nn.Parameter(torch.zeros(co))

    def norm(self, x: torch.Tensor) -> tuple:
        """The BatchNorm as (alpha, shift), BN(x) = alpha x + shift: x's
        batch statistics in training (the running ones updated), else the
        running ones."""
        if self.training:
            n = x.numel() // x.shape[-1]
            mean = x.mean((0, 1, 2))
            var = x.var((0, 1, 2), unbiased=False)
            with torch.no_grad():
                self.bn_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                self.bn_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * n / max(n - 1, 1))
        else:
            mean, var = self.bn_mean, self.bn_var
        alpha = self.bn_weight / torch.sqrt(var + BN_EPS)
        return alpha, self.bn_bias - mean * alpha

    def forward(self, x: torch.Tensor, style: torch.Tensor | None = None) -> torch.Tensor:
        """x (N, H, W, ci); style (N, ci) or None, added to x before the BN.
        A 3x3 conv hands relu(BN(x + style)) to the Winograd op as its
        input prologue, the style folded into a per-tile shift; in training
        the batch statistics are those of x + style, which is then formed."""
        if style is not None and self.training:
            x, style = x + style[:, None, None, :], None
        alpha, shift = self.norm(x)
        if style is not None:
            shift = torch.addcmul(shift, style, alpha)
        if self.weight.shape[-1] == 3:
            return winograd.winograd_conv3x3(x, self.weight.permute(2, 3, 1, 0), self.bias,
                                             in_scale=alpha, in_shift=shift)
        x = torch.addcmul(shift, x, alpha)
        if self.relu:
            x = torch.relu_(x)
        return torch.matmul(x, self.weight[:, :, 0, 0].t()) + self.bias


class _StyleBC(nn.Module):
    """`batchconvstyle`: (x [+ skip] + Linear(style)) through a `_BC`."""

    def __init__(self, c: int, style: int):
        super().__init__()
        self.conv = _BC(c, c, 3)
        self.full = nn.Linear(style, c)

    def forward(self, style: torch.Tensor, x: torch.Tensor, skip=None) -> torch.Tensor:
        if skip is not None:
            x = x + skip
        return self.conv(x, self.full(style))


class _ResDown(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.proj = _BC(ci, co, 1, relu=False)
        self.conv = nn.ModuleList([_BC(ci, co, 3)] + [_BC(co, co, 3) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = self.proj(x) + c[1](c[0](x))
        return x + c[3](c[2](x))


class _ResUp(nn.Module):
    def __init__(self, ci: int, co: int, style: int):
        super().__init__()
        self.proj = _BC(ci, co, 1, relu=False)
        self.conv0 = _BC(ci, co, 3)
        self.conv = nn.ModuleList([_StyleBC(co, style) for _ in range(3)])

    def forward(self, x: torch.Tensor, skip: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = self.proj(x) + c[0](style, self.conv0(x), skip)
        return x + c[2](style, c[1](style, x))


class CPnet(nn.Module):
    """forward(x (N, H, W, nbase[0]), H and W multiples of 8) ->
    (N, H, W, 3): (dy, dx, cellprob).  `in_channels` is nbase[0]; `tile`
    is Cellpose 3's bsize, the tile `run_tiled` cuts by default (the
    network takes any multiple of 8)."""

    tile = 224

    def __init__(self, nbase=(2, 32, 64, 128, 256), nout: int = 3):
        super().__init__()
        nbase = list(nbase)
        up = nbase[1:] + [nbase[-1]]
        self.nbase = tuple(nbase)
        self.in_channels = nbase[0]
        self.down = nn.ModuleList([_ResDown(nbase[n], nbase[n + 1])
                                   for n in range(len(nbase) - 1)])
        self.up = nn.ModuleList([_ResUp(up[n + 1], up[n], up[-1]) for n in range(len(up) - 1)])
        self.output = _BC(up[0], nout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xd = []
        for n, block in enumerate(self.down):
            xd.append(block(x if n == 0 else _maxpool2(xd[-1])))
        style = xd[-1].mean((1, 2))
        style = style / torch.sqrt(torch.sum(style * style, dim=1, keepdim=True))
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = self.up[n](_up2(x), xd[n], style)
        return self.output(x)


def _bc_keys(prefix: str, bc: str, relu: bool) -> dict:
    """{port name: Cellpose name} of one `_BC` (Cellpose: a Sequential of
    BatchNorm, [ReLU,] conv)."""
    conv = "2" if relu else "1"
    return {f"{prefix}.bn_weight": f"{bc}.0.weight", f"{prefix}.bn_bias": f"{bc}.0.bias",
            f"{prefix}.bn_mean": f"{bc}.0.running_mean", f"{prefix}.bn_var": f"{bc}.0.running_var",
            f"{prefix}.weight": f"{bc}.{conv}.weight", f"{prefix}.bias": f"{bc}.{conv}.bias"}


def cellpose_key_map(nbase=(2, 32, 64, 128, 256)) -> dict:
    """{the port's state-dict name: Cellpose's `CPnet` state-dict name}."""
    out = {}
    for n in range(len(nbase) - 1):
        p, c = f"down.{n}", f"downsample.down.res_down_{n}"
        out.update(_bc_keys(f"{p}.proj", f"{c}.proj", False))
        for t in range(4):
            out.update(_bc_keys(f"{p}.conv.{t}", f"{c}.conv.conv_{t}", True))
        p, c = f"up.{n}", f"upsample.up.res_up_{n}"
        out.update(_bc_keys(f"{p}.proj", f"{c}.proj", False))
        out.update(_bc_keys(f"{p}.conv0", f"{c}.conv.conv_0", True))
        for t in range(3):
            out.update(_bc_keys(f"{p}.conv.{t}.conv", f"{c}.conv.conv_{t + 1}.conv", True))
            out[f"{p}.conv.{t}.full.weight"] = f"{c}.conv.conv_{t + 1}.full.weight"
            out[f"{p}.conv.{t}.full.bias"] = f"{c}.conv.conv_{t + 1}.full.bias"
    out.update(_bc_keys("output", "output", True))
    return out


def nbase_of(arrays: dict) -> tuple:
    """The widths of a Cellpose state dict: each encoder block's input and
    the last one's output."""
    ins, n = [], 0
    while f"downsample.down.res_down_{n}.proj.1.weight" in arrays:
        w = arrays[f"downsample.down.res_down_{n}.proj.1.weight"]
        ins.append(int(w.shape[1]))
        last = int(w.shape[0])
        n += 1
    if not ins:
        raise ValueError("not a Cellpose CPnet state dict: no downsample.down.res_down_0")
    return tuple(ins + [last])


def cellpose_state_from_numpy(arrays: dict) -> dict:
    """The port's `CPnet` state dict from a dict of Cellpose-named arrays."""
    return {k: torch.as_tensor(np.asarray(arrays[v], np.float32))
            for k, v in cellpose_key_map(nbase_of(arrays)).items()}


def cellpose_state_to_numpy(model: CPnet) -> dict:
    """`model`'s weights under Cellpose's names, as float32 NumPy arrays."""
    state = model.state_dict()
    return {v: state[k].detach().cpu().numpy().astype(np.float32)
            for k, v in cellpose_key_map(model.nbase).items()}


def build_cpnet(arrays: dict, device) -> CPnet:
    """An eval-mode `CPnet` on `device` with the weights of `arrays`."""
    model = CPnet(nbase_of(arrays))
    model.load_state_dict(cellpose_state_from_numpy(arrays))
    return model.to(device).eval()


def init_cpnet(seed: int, nbase=(2, 32, 64, 128, 256)) -> CPnet:
    """A `CPnet` drawn as PyTorch's default conv and linear init draws
    (uniform within 1 / sqrt(fan_in), weights and biases) from a CPU
    generator seeded with `seed`, BN at weight 1, bias 0, mean 0, variance
    1; on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    model = CPnet(nbase)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (_BC, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return model


# ---- tiled inference ---------------------------------------------------


def numpy_percentile_ranks(n: int, q: float) -> tuple:
    """(k_lo, k_hi, gamma float32) of numpy's linear percentile of a float32
    array of n elements: the virtual index (n - 1) * (q / 100) and its
    fraction are float32, as numpy computes them for float32 data."""
    idx = np.float32(n - 1) * (np.float32(q) / np.float32(100))
    lo = int(np.floor(idx))
    return lo, min(lo + 1, n - 1), np.float32(idx - np.float32(lo))


def numpy_lerp(a: torch.Tensor, b: torch.Tensor, g) -> torch.Tensor:
    """numpy's `_lerp` in float32: a + (b - a) g below g = 0.5, else
    b - (b - a) (1 - g)."""
    d = b - a
    if g >= 0.5:
        return b - d * float(np.float32(1) - g)
    return a + d * float(g)


def normalize99(frames: torch.Tensor, pmin: float = 1.0, pmax: float = 99.0) -> torch.Tensor:
    """Cellpose's `normalize99` of each frame of (B, H, W): (x - p_min) /
    (p_max - p_min) in float32, or zeros where p_max - p_min <= 1e-3; the
    percentiles from the radix select (`ops.percentile.kth_smallest`)."""
    x = frames.float()
    n = x[0].numel()
    r = [numpy_percentile_ranks(n, q) for q in (pmin, pmax)]
    v = kth_smallest(x, (r[0][0], r[0][1], r[1][0], r[1][1]))
    lo = numpy_lerp(v[:, 0], v[:, 1], r[0][2]).reshape(-1, 1, 1)
    hi = numpy_lerp(v[:, 2], v[:, 3], r[1][2]).reshape(-1, 1, 1)
    span_ = hi - lo
    return torch.where(span_ > 1e-3, (x - lo) / span_, torch.zeros((), device=x.device))


def pad_sizes(L: int) -> tuple:
    """(before, after) of `pad_image_ND` (div 16, extra 1) on a side L."""
    lpad = int(PAD_DIV * np.ceil(L / PAD_DIV) - L)
    return PAD_DIV // 2 + lpad // 2, PAD_DIV // 2 + lpad - lpad // 2


def tile_starts(L: int, tile: int, overlap: float) -> list:
    """`make_tiles`' starts on a padded side L: n = ceil((1 + 2 overlap) L /
    tile) tiles (1 where L <= tile) at linspace(0, L - tile, n) truncated."""
    overlap = min(0.5, max(0.05, overlap))
    b = min(tile, L)
    n = 1 if L <= tile else int(np.ceil((1.0 + 2 * overlap) * L / tile))
    return [int(s) for s in np.linspace(0, L - b, n).astype(int)]


def taper_mask(ly: int, lx: int, sig: float = 7.5) -> np.ndarray:
    """`_taper_mask`: a sigmoid falling over the tile's last 20 px, the
    centre crop of a max(224, side) square; float64."""
    bsize = max(224, max(ly, lx))
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / sig))
    mask = mask * mask[:, np.newaxis]
    return mask[bsize // 2 - ly // 2:bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2:bsize // 2 + lx // 2 + lx % 2]


def tiles_of(h: int, w: int, tile: int, overlap: float) -> tuple:
    """((pad_y, pad_x), ystarts, xstarts, (tile_h, tile_w)) of a frame of
    h x w: what `run_tiled` cuts."""
    py, px = pad_sizes(h), pad_sizes(w)
    Ly, Lx = h + sum(py), w + sum(px)
    return ((py, px), tile_starts(Ly, tile, overlap), tile_starts(Lx, tile, overlap),
            (min(tile, Ly), min(tile, Lx)))


@functools.lru_cache(maxsize=8)
def blend_weights(h: int, w: int, tile: int, overlap: float, device: torch.device) -> tuple:
    """(taper mask (tile_h, tile_w), its sum over the tiles (Ly, Lx)), float64
    on `device`, of `run_tiled`'s blend on frames of h x w: made once a
    shape, not uploaded every batch."""
    _, ys, xs, (th, tw) = tiles_of(h, w, tile, overlap)
    mask = torch.as_tensor(taper_mask(th, tw), device=device)
    navg = torch.zeros((ys[-1] + th, xs[-1] + tw), dtype=torch.float64, device=device)
    for y0 in ys:
        for x0 in xs:
            navg[y0:y0 + th, x0:x0 + tw] += mask
    return mask, navg


@torch.inference_mode()
def run_tiled(model, frames: torch.Tensor, tile: int | None = None, overlap: float = 0.1,
              tile_chunk: int = 64, pmin: float = 1.0, pmax: float = 99.0) -> torch.Tensor:
    """(B, H, W) raw frames -> (B, H, W, 3) float32 (dy, dx, cellprob):
    normalize99 into channel 0 of the network's `in_channels` (the others
    zeros: CPnet's 2, Cellpose-SAM's 3), the padding, the tiles (`tile`,
    by default the network's own) of all frames through `model`
    `tile_chunk` at a time, the tapered blend (`average_tiles`, in float64
    on the device) and the crop back.  Spans `cellpose.normalize`,
    `cellpose.tiles` (cut, net, blend) and `cellpose.net`; counts
    `cellpose.tiles`."""
    tile = model.tile if tile is None else tile
    B, h, w = frames.shape
    dev = frames.device
    with span("cellpose.normalize"):
        x = normalize99(frames, pmin, pmax)
    with span("cellpose.tiles"):
        (py, px), ys, xs, (th, tw) = tiles_of(h, w, tile, overlap)
        nchan = model.in_channels
        img = torch.nn.functional.pad(x, (px[0], px[1], py[0], py[1]))
        Ly, Lx = img.shape[1:]
        # (B, ny, nx, th, tw): tile (j, i) of a frame is rows ys[j], cols xs[i]
        rows = torch.tensor(ys, device=dev)[:, None] + torch.arange(th, device=dev)
        cols = torch.tensor(xs, device=dev)[:, None] + torch.arange(tw, device=dev)
        cut = img[:, rows[:, None, :, None], cols[None, :, None, :]]
        n_tiles = B * len(ys) * len(xs)
        count("cellpose.tiles", n_tiles)
        tiles = torch.zeros((n_tiles, th, tw, nchan), dtype=torch.float32, device=dev)
        tiles[..., 0] = cut.reshape(n_tiles, th, tw)
        out = torch.empty((n_tiles, th, tw, 3), dtype=torch.float32, device=dev)
        with span("cellpose.net"):
            for s in range(0, n_tiles, tile_chunk):
                out[s:s + tile_chunk] = model(tiles[s:s + tile_chunk])
        del tiles
        mask, navg = blend_weights(h, w, tile, overlap, dev)
        yf = torch.zeros((B, Ly, Lx, 3), dtype=torch.float32, device=dev)
        out = out.reshape(B, len(ys), len(xs), th, tw, 3)
        for j, y0 in enumerate(ys):
            for i, x0 in enumerate(xs):
                region = yf[:, y0:y0 + th, x0:x0 + tw]
                region.copy_((region.double() + out[:, j, i].double() * mask[..., None]).float())
        yf = (yf.double() / navg[..., None]).float()
        return yf[:, py[0]:py[0] + h, px[0]:px[0] + w].contiguous()
