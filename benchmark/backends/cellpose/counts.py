"""The work of the Cellpose backend: cyto3's CPnet on a frame's tiles, and
the least bytes of the flow following.

A frame is padded as Cellpose's `pad_image_ND` pads it (to a multiple of 16,
plus 8 px a side) and cut into `tile`^2 tiles, n = ceil((1 + 2 overlap) L /
tile) a side (`make_tiles`).  The network runs on every tile; one square of
n x n tiles has the same FLOPs and activation bytes as the n^2 tiles, so
each 3x3 conv is listed at (n tile / 2^level)^2 with its weights counted
once.  Nothing here reads the program."""

from __future__ import annotations

import math

from benchmark.work import F32, conv_flops


def tiles_a_side(size: int, seg: dict) -> int:
    lpad = 16 * math.ceil(size / 16) - size
    padded = size + 16 + lpad
    tile, overlap = seg["tile"], min(0.5, max(0.05, seg["tile_overlap"]))
    return 1 if padded <= tile else math.ceil((1.0 + 2 * overlap) * padded / tile)


def cpnet_layers(side: int, nbase: list) -> list:
    """(name, h, w, ci, co, k) of CPnet's convs on a side^2 input: four
    residual blocks down (a 1x1 projection and four 3x3 convs each, a 2x2
    pool before blocks 1-3), four up (a 1x1 projection and four 3x3 convs
    each, a 2x upsample before blocks 2-0), the 1x1 output conv."""
    up = list(nbase[1:]) + [nbase[-1]]
    layers = []
    for n in range(len(nbase) - 1):
        s = side >> n
        ci, co = nbase[n], nbase[n + 1]
        layers.append((f"down{n}.proj", s, s, ci, co, 1))
        layers += [(f"down{n}.conv{t}", s, s, ci if t == 0 else co, co, 3) for t in range(4)]
    for n in range(len(up) - 2, -1, -1):
        s = side >> n
        ci, co = up[n + 1], up[n]
        layers.append((f"up{n}.proj", s, s, ci, co, 1))
        layers += [(f"up{n}.conv{t}", s, s, ci if t == 0 else co, co, 3) for t in range(4)]
    layers.append(("output", side, side, up[0], 3, 1))
    return layers


def frame_flops(size: int, seg: dict) -> float:
    """CPnet's direct FLOPs on a size^2 frame's tiles: its convs and the
    style's linear maps into three convs of each decoder block."""
    n = tiles_a_side(size, seg)
    tile, nbase = seg["tile"], seg["nbase"]
    convs = sum(conv_flops(h, w, ci, co, k) for _, h, w, ci, co, k in cpnet_layers(tile, nbase))
    style = sum(3 * 2.0 * nbase[-1] * co for co in nbase[1:])
    return n * n * (convs + style)


def conv3x3_layers(size: int, seg: dict) -> list:
    """(name, h, w, ci, co) of the 32 3x3 convs, each through the port's
    Winograd kernel, on the square of the frame's n x n tiles."""
    side = tiles_a_side(size, seg) * seg["tile"]
    return [(name, h, w, ci, co) for name, h, w, ci, co, k in cpnet_layers(side, seg["nbase"])
            if k == 3]


def follow_flows_bytes(size: int, seg: dict) -> float:
    """The least bytes of a frame's flow following: the flows (2 x float32)
    and the cell probability read once, every pixel's final position (2 x
    float32) written once."""
    return float((2 + 1 + 2) * F32 * size * size)
