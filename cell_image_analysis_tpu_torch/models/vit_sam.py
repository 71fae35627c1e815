"""Cellpose-SAM's network (Cellpose 4's default model `cpsam`), the Cellpose
backend's second network (`models.segmentation.CellposeBackend`).

The JAX package has no counterpart.  The source is MouseLand/cellpose 4,
`vit_sam.Transformer`: SAM's ViT-L image encoder (facebookresearch/
segment-anything, `modeling/image_encoder.py`) with 8 px patches, the
position embedding taken [::2, ::2] for 256^2 tiles, every block's window
set to 0 (global attention), SAM's neck, and a 1x1 readout to nout x 8^2
channels that a fixed identity `conv_transpose2d` unfolds to pixels.

On a tile x (B, 256, 256, 3), NHWC (channel 0 the normalized frame, 1-2
zeros):

- patch embedding: Conv2d(3, 1024, k 8, s 8) with a bias, as a matmul
  over each patch's 192 pixels, then + `pos_embed` (1, 32, 32, 1024);
- 24 blocks: x + proj(attn(LN1 x)), then x + lin2(GELU(lin1(LN2 x)));
  LayerNorm eps 1e-6, the erf GELU.  The attention of each of 16 heads of
  64 is softmax((q scale) k^T + rel_h + rel_w) v, scale 64^-0.5, with
  SAM's decomposed relative position: rel_h[q, kh] = sum_c q[c] Rh[qh,
  kh, c] on the unscaled q, Rh = R_h[qh - kh + 31], R_h the block's
  `rel_pos_h` resized to 63 rows (`F.interpolate`, linear, as SAM's
  `get_rel_pos`), rel_w alike.  The tables keep their SAM sizes: 27 rows
  in the blocks SAM windows, 127 in blocks 5, 11, 17 and 23, resized at
  every forward as SAM does; `ops.vit_attention` runs the attention (the
  fused kernel on the card);
- neck: Conv2d(1024, 256, 1, no bias), LayerNorm2d (eps 1e-6), the 3x3
  Conv2d(256, 256, pad 1, no bias) through `ops.winograd`, LayerNorm2d;
- readout: Conv2d(256, 192, 1) with a bias, then the pixel unfold y[c, 8i
  + a, 8j + b] = x1[64c + 8a + b, i, j] (`conv_transpose2d` with the
  identity W2), as a reshape; out (B, 256, 256, 3): (dy, dx, cellprob).

The blocks' qkv, proj, lin1 and lin2 run through `ops.vit_linear` (the
3xTF32 tensor-core GEMM on the card, `F.linear` on the CPU); the other
linears are float32 matmuls (the package turns TF32 off).  Parameter
names are Cellpose-SAM's state-dict names (`encoder.blocks.0.attn.qkv.weight`,
...; W2 is not a parameter here).  Spans `vit.patch_embed`, `vit.blocks`,
`vit.attention`, `vit.mlp`, `vit.neck`, `vit.readout`; counters
`vit.tiles`, `vit.tokens` (and `vit.attention_calls` /
`vit.attention_fused`, `vit.linear_calls` / `vit.linear_fused` from the
ops).

The weight format (`io.artifacts.load_cellpose_weights`): each of the 96
large matrices of the blocks (`LOW_RANK`) is a seeded base, `randn(shape)
* 0.02` from `torch.Generator().manual_seed(base_seed + index)` on the CPU
(`low_rank_index`), plus a stored rank-r update A @ B; the merged
matrices are dense.  `LowRankLinear` is that form for training
(`low_rank_`), and `low_rank_state_to_numpy` writes it.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cell_image_analysis_tpu_torch.ops import winograd
from cell_image_analysis_tpu_torch.ops.vit_attention import vit_attention
from cell_image_analysis_tpu_torch.ops.vit_linear import vit_linear
from cell_image_analysis_tpu_torch.utils.profiler import count, span

LN_EPS = 1e-6
GLOBAL_BLOCKS = (5, 11, 17, 23)     # SAM ViT-L's global-attention blocks: 127-row tables
WINDOW_ROWS, GLOBAL_ROWS = 27, 127  # 2 x 14 - 1 and 2 x 64 - 1
LOW_RANK = ("attn.qkv", "attn.proj", "mlp.lin1", "mlp.lin2")
BASE_STD = 0.02


def rel_pos_rows(depth: int, global_blocks=GLOBAL_BLOCKS) -> tuple:
    """The table rows of each block as SAM ViT-L has them."""
    return tuple(GLOBAL_ROWS if i in global_blocks else WINDOW_ROWS for i in range(depth))


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """SAM's `get_rel_pos` for q_size == k_size: the table resized to 2 size
    - 1 rows (linear interpolation), gathered at q - k + size - 1 ->
    (q_size, k_size, C)."""
    rows = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != rows:
        rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=rows, mode="linear").reshape(-1, rows).permute(1, 0)
    d = rel_pos.device
    idx = torch.arange(q_size, device=d)[:, None] - torch.arange(k_size, device=d) + (k_size - 1)
    return rel_pos[idx]


def _linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A block's `nn.Linear` through `ops.vit_linear`; a `LowRankLinear`
    (training) as it is."""
    if isinstance(layer, nn.Linear):
        return vit_linear(x, layer.weight, layer.bias)
    return layer(x)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, rows: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(rows, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(rows, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        n, hd = H * W, C // self.heads
        qkv = _linear(self.qkv, x).reshape(B, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.contiguous().reshape(3, B * self.heads, n, hd).unbind(0)
        Rh, Rw = get_rel_pos(H, H, self.rel_pos_h), get_rel_pos(W, W, self.rel_pos_w)
        r_q = q.reshape(B * self.heads, H, W, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh).reshape(B * self.heads, n, H)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw).reshape(B * self.heads, n, W)
        o = vit_attention(q, k, v, rel_h, rel_w, self.scale)
        o = o.view(B, self.heads, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return _linear(self.proj, o)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.lin2, F.gelu(_linear(self.lin1, x)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, rows: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim, heads, rows)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _MLP(dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vit.attention"):
            x = x + self.attn(self.norm1(x))
        with span("vit.mlp"):
            return x + self.mlp(self.norm2(x))


class _Conv(nn.Module):
    """A bias-free conv's weight (co, ci, k, k), applied by the neck."""

    def __init__(self, ci: int, co: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(co, ci, k, k))


class _LayerNorm2d(nn.Module):
    """SAM's LayerNorm2d over the channels, here the last axis (NHWC)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


class _PatchEmbed(nn.Module):
    def __init__(self, ci: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(ci, dim, patch, stride=patch)


class _Encoder(nn.Module):
    def __init__(self, ci, dim, depth, heads, hidden, patch, tokens, neck, rows):
        super().__init__()
        self.patch_embed = _PatchEmbed(ci, dim, patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, tokens, dim))
        self.blocks = nn.ModuleList([_Block(dim, heads, hidden, r) for r in rows])
        self.neck = nn.ModuleList([_Conv(dim, neck, 1), _LayerNorm2d(neck), _Conv(neck, neck, 3),
                                   _LayerNorm2d(neck)])


class ViTSAM(nn.Module):
    """forward(x (N, tile, tile, in_channels)) -> (N, tile, tile, nout):
    (dy, dx, cellprob).  Defaults: Cellpose-SAM's published widths."""

    def __init__(self, dim: int = 1024, depth: int = 24, heads: int = 16, hidden: int = 4096,
                 patch: int = 8, tile: int = 256, neck: int = 256, nout: int = 3,
                 in_channels: int = 3, rows: tuple | None = None):
        super().__init__()
        self.in_channels, self.tile, self.patch, self.nout = in_channels, tile, patch, nout
        rows = rel_pos_rows(depth) if rows is None else tuple(rows)
        self.encoder = _Encoder(in_channels, dim, depth, heads, hidden, patch, tile // patch,
                                neck, rows)
        self.out = nn.Conv2d(neck, nout * patch * patch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, ci = x.shape
        p, e = self.patch, self.encoder
        h, w = H // p, W // p
        count("vit.tiles", B)
        count("vit.tokens", B * h * w)
        with span("vit.patch_embed"):
            pe = e.patch_embed.proj
            patches = x.reshape(B, h, p, w, p, ci).permute(0, 1, 3, 5, 2, 4).reshape(B, h, w, -1)
            x = F.linear(patches, pe.weight.reshape(pe.weight.shape[0], -1), pe.bias)
            x = x + e.pos_embed
        with span("vit.blocks"):
            for blk in e.blocks:
                x = blk(x)
        with span("vit.neck"):
            n0, n1, n2, n3 = e.neck
            x = n1(torch.matmul(x, n0.weight[:, :, 0, 0].t()))
            x = n3(winograd.winograd_conv3x3(x, n2.weight.permute(2, 3, 1, 0)))
        with span("vit.readout"):
            x1 = F.linear(x, self.out.weight[:, :, 0, 0], self.out.bias)
            c = self.nout
            return (x1.reshape(B, h, w, c, p, p).permute(0, 1, 4, 2, 5, 3)
                    .reshape(B, h * p, w * p, c))


# ---- the weights ---------------------------------------------------------


def is_vit_state(arrays) -> bool:
    """Whether a dict of Cellpose-named arrays is a Cellpose-SAM state."""
    return "encoder.patch_embed.proj.weight" in arrays


def widths_of(arrays: dict) -> dict:
    """`ViTSAM`'s keyword arguments from a Cellpose-SAM state's shapes."""
    pe = arrays["encoder.patch_embed.proj.weight"]
    depth = 0
    while f"encoder.blocks.{depth}.norm1.weight" in arrays:
        depth += 1
    dim, patch = int(pe.shape[0]), int(pe.shape[-1])
    rel = arrays["encoder.blocks.0.attn.rel_pos_h"]
    return dict(dim=dim, depth=depth, heads=dim // int(rel.shape[1]),
                hidden=int(arrays["encoder.blocks.0.mlp.lin1.weight"].shape[0]), patch=patch,
                tile=int(arrays["encoder.pos_embed"].shape[1]) * patch,
                neck=int(arrays["encoder.neck.0.weight"].shape[0]),
                nout=int(arrays["out.weight"].shape[0]) // (patch * patch),
                in_channels=int(pe.shape[1]),
                rows=tuple(int(arrays[f"encoder.blocks.{i}.attn.rel_pos_h"].shape[0])
                           for i in range(depth)))


def build_vit_sam(arrays: dict, device) -> ViTSAM:
    """An eval-mode `ViTSAM` on `device` with the (merged) weights of `arrays`."""
    model = ViTSAM(**widths_of(arrays))
    model.load_state_dict({k: torch.as_tensor(np.asarray(arrays[k], np.float32))
                           for k in model.state_dict()})
    return model.to(device).eval()


def low_rank_index(name: str) -> int:
    """The fixed index of a large matrix, 4 x block + its place in
    LOW_RANK: its base's generator seed is base_seed + index."""
    m = re.fullmatch(r"encoder\.blocks\.(\d+)\.(attn\.qkv|attn\.proj|mlp\.lin1|mlp\.lin2)\.weight",
                     name)
    if m is None:
        raise ValueError(f"{name}: not one of the blocks' large matrices")
    return 4 * int(m.group(1)) + LOW_RANK.index(m.group(2))


def base_matrix(name: str, shape, base_seed: int) -> torch.Tensor:
    """The seeded base of a large matrix: randn(shape) * 0.02 from
    `torch.Generator().manual_seed(base_seed + low_rank_index(name))`,
    float32 on the CPU."""
    gen = torch.Generator().manual_seed(int(base_seed) + low_rank_index(name))
    return torch.randn(tuple(shape), generator=gen) * BASE_STD


def merge_low_rank(base: torch.Tensor, a, b) -> torch.Tensor:
    """base + A.float() @ B.float(), on the CPU."""
    return base + torch.as_tensor(np.asarray(a)).float() @ torch.as_tensor(np.asarray(b)).float()


class LowRankLinear(nn.Module):
    """A linear whose weight is a frozen seeded base plus A @ B, trained in
    that form: x base^T + (x B^T) A^T + bias.  A starts at zero."""

    def __init__(self, linear: nn.Linear, name: str, rank: int, base_seed: int,
                 gen: torch.Generator):
        super().__init__()
        co, ci = linear.weight.shape
        self.name = name
        self.register_buffer("base", base_matrix(name, (co, ci), base_seed))
        self.a = nn.Parameter(torch.zeros(co, rank))
        self.b = nn.Parameter(torch.randn(rank, ci, generator=gen) / math.sqrt(ci))
        self.bias = nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.base, self.bias) + F.linear(F.linear(x, self.b), self.a)


def low_rank_(model: ViTSAM, rank: int, base_seed: int, seed: int = 0) -> ViTSAM:
    """Replaces the blocks' 96 large linears of `model` (on the CPU) by
    `LowRankLinear`s, in place; returns `model`."""
    gen = torch.Generator().manual_seed(seed)
    for i, blk in enumerate(model.encoder.blocks):
        for part, attr in (("attn", "qkv"), ("attn", "proj"), ("mlp", "lin1"), ("mlp", "lin2")):
            owner = getattr(blk, part)
            name = f"encoder.blocks.{i}.{part}.{attr}.weight"
            setattr(owner, attr, LowRankLinear(getattr(owner, attr), name, rank, base_seed, gen))
    return model


def init_vit_sam(seed: int, **widths) -> ViTSAM:
    """A `ViTSAM` on the CPU for training, drawn from a CPU generator
    seeded with `seed`: the patch embedding normal within 1 / sqrt(fan_in),
    every other matrix and the position embedding normal 0.02, LayerNorms
    at 1 and 0, biases and relative-position tables 0."""
    gen = torch.Generator().manual_seed(seed)
    model = ViTSAM(**widths)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("norm1.weight", "norm2.weight", "neck.1.weight", "neck.3.weight")):
                p.fill_(1.0)
            elif name.endswith("bias") or "rel_pos" in name:
                p.zero_()
            else:
                std = (1.0 / math.sqrt(p[0].numel()) if name == "encoder.patch_embed.proj.weight"
                       else BASE_STD)
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def low_rank_state_to_numpy(model: ViTSAM) -> tuple:
    """(arrays, large): a `low_rank_` model's weights as float32 NumPy
    arrays under Cellpose-SAM's names, each large matrix as its factors
    `<name>.lowrank_a` (co, r) and `<name>.lowrank_b` (r, ci); `large` the
    names of the large matrices."""
    arrays, large = {}, []
    for mod in model.modules():
        if isinstance(mod, LowRankLinear):
            large.append(mod.name)
    state = model.state_dict()
    for key, value in state.items():
        v = value.detach().cpu().numpy().astype(np.float32)
        if key.endswith(".base"):
            continue
        for suffix, new in ((".a", ".weight.lowrank_a"), (".b", ".weight.lowrank_b")):
            stem = key[:-len(suffix)]
            if key.endswith(suffix) and f"{stem}.weight" in large:
                key = stem + new
                break
        arrays[key] = v
    return arrays, large
