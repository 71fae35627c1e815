"""The work of the StarDist backend's network, from the configuration's
widths and the frame's size: the U-Net's convolutions, its probability head
and the dist head on the top-K rows."""

from __future__ import annotations

from benchmark.work import conv_flops


def unet_layers(size: int, seg: dict) -> list:
    """The U-Net's convolutions at a size^2 frame as (name, h, w, ci, co,
    k): two 3x3 convs a level down to `unet_depth` and in the middle, two
    a decoder level back to the grid's resolution (the input is the
    upsampled level beside the skip), the 3x3 head conv and the 1x1
    probability head.  The 1x1 dist head runs on the top-K rows only
    (`dist_head_flops`)."""
    depth, base, head = seg["unet_depth"], seg["base_filters"], seg["head_filters"]
    layers, ci, i, s = [], 1, 0, size
    for lvl in range(depth + 1):
        f = base * 2 ** lvl
        layers += [(f"Conv_{i}", s, s, ci, f, 3), (f"Conv_{i + 1}", s, s, f, f, 3)]
        ci, i = f, i + 2
        if lvl < depth:
            s //= 2
    for lvl in reversed(range(1, depth)):
        f = base * 2 ** lvl
        s *= 2
        layers += [(f"Conv_{i}", s, s, ci + f, f, 3), (f"Conv_{i + 1}", s, s, f, f, 3)]
        ci, i = f, i + 2
    layers += [(f"Conv_{i}", s, s, ci, head, 3), (f"Conv_{i + 1}", s, s, head, 1, 1)]
    return layers


def unet_flops(size: int, seg: dict) -> float:
    """Direct FLOPs of the U-Net's convolutions and probability head, one frame."""
    return sum(conv_flops(h, w, ci, co, k) for _, h, w, ci, co, k in unet_layers(size, seg))


def dist_head_flops(seg: dict, rows: int) -> float:
    """The 1x1 dist head on `rows` gathered feature rows."""
    return 2.0 * rows * seg["head_filters"] * seg["n_rays"]


def frame_flops(size: int, seg: dict) -> float:
    """The U-Net and probability head of one frame, and the dist head on
    its `max_candidates` top-K rows."""
    return unet_flops(size, seg) + dist_head_flops(seg, seg["max_candidates"])


def conv3x3_layers(size: int, seg: dict) -> list:
    """(name, h, w, ci, co) of the U-Net's 3x3 convolutions, each through
    the port's Winograd kernel."""
    return [(name, h, w, ci, co) for name, h, w, ci, co, k in unet_layers(size, seg) if k == 3]
