"""The work of Cellpose-SAM's backend: the ViT on a frame's tiles, its
attention kernel's least work, and (from `backends/cellpose/counts.py`,
loaded by path) the tiles and the flow following's least bytes.

A frame is padded and cut as Cellpose 3 cuts it (`tiles_a_side`), at the
ViT's 256^2 tiles: 25 tiles a 1024^2 frame.  Per tile, with N = (tile /
patch)^2 tokens of width E, H heads of d, an MLP of M: the patch
embedding 2 N E (3 patch^2); each block the qkv, proj, lin1 and lin2
matmuls 2 N E (3E + E + 2M), the attention 4 H N^2 d (scores and P V),
the relative-position terms 2 x 2 H N sqrt(N) d (rel_h and rel_w); the
neck 2 N E n + 2 N n^2 9 (n = 256); the readout 2 N n (nout patch^2).
At the published widths 727.0 GFLOP a tile.  Nothing here reads the
program."""

from __future__ import annotations

import importlib.util
import os

from benchmark.work import F32, conv_flops

_CELLPOSE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "cellpose", "counts.py")
_spec = importlib.util.spec_from_file_location("benchmark_backend_cellpose_counts_shared",
                                               _CELLPOSE)
_cellpose = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cellpose)

tiles_a_side = _cellpose.tiles_a_side
follow_flows_bytes = _cellpose.follow_flows_bytes


def tile_flops(seg: dict) -> dict:
    """{part: FLOPs} of one tile: patch, block (each of `depth`), neck,
    readout."""
    v = seg["vit"]
    E, H, M, p, n = v["dim"], v["heads"], v["hidden"], v["patch"], v["neck"]
    side = seg["tile"] // p
    N, d = side * side, E // H
    return dict(patch=2.0 * N * E * (3 * p * p),
                block=2.0 * N * E * (3 * E + E + 2 * M) + 4.0 * H * N * N * d
                + 2 * 2.0 * H * N * side * d,
                neck=conv_flops(side, side, E, n, 1) + conv_flops(side, side, n, n, 3),
                readout=conv_flops(side, side, n, v["nout"] * p * p, 1))


def frame_flops(size: int, seg: dict) -> float:
    """The ViT's direct FLOPs on a size^2 frame's tiles."""
    f = tile_flops(seg)
    n = tiles_a_side(size, seg)
    return n * n * (f["patch"] + seg["vit"]["depth"] * f["block"] + f["neck"] + f["readout"])


def conv3x3_layers(size: int, seg: dict) -> list:
    """(name, h, w, ci, co) of the one 3x3 conv through the port's Winograd
    kernel, the neck's, on the square of the frame's n x n tiles' tokens."""
    side = tiles_a_side(size, seg) * seg["tile"] // seg["vit"]["patch"]
    n = seg["vit"]["neck"]
    return [("neck.2", side, side, n, n)]


def attention_work(size: int, seg: dict) -> tuple:
    """(FLOPs, bytes) of a size^2 frame's fused attention calls, the least
    the kernel must do: per tile and block 4 H N^2 d for the scores and P V
    plus 2 H N^2 for the two bias adds; q, k, v, rel_h, rel_w and the
    output read or written once in float32."""
    v = seg["vit"]
    side = seg["tile"] // v["patch"]
    N, H, d = side * side, v["heads"], v["dim"] // v["heads"]
    calls = tiles_a_side(size, seg) ** 2 * v["depth"]
    flops = 4.0 * H * N * N * d + 2.0 * H * N * N
    nbytes = F32 * H * N * (4 * d + side + side)
    return calls * flops, calls * float(nbytes)
