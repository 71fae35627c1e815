"""The work counters against hand counts, layer by layer."""

import json
import os

import pytest

from benchmark import backends, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(HERE, "configs", "stardist_fluo.json")))
STARDIST = backends.module("stardist", "counts")


def test_unet_flops_at_1024_by_hand():
    # (side, in channels, out channels) of the 13 3x3 convs at a 1024^2 frame,
    # then the 1x1 probability head at the grid's 512^2
    convs = [(1024, 1, 32), (1024, 32, 32), (512, 32, 64), (512, 64, 64), (256, 64, 128),
             (256, 128, 128), (128, 128, 256), (128, 256, 256), (256, 256 + 128, 128),
             (256, 128, 128), (512, 128 + 64, 64), (512, 64, 64), (512, 64, 128)]
    hand = sum(2 * s * s * ci * co * 9 for s, ci, co in convs) + 2 * 512 * 512 * 128
    got = STARDIST.unet_flops(1024, CFG["segmentation"])
    assert got == hand
    assert got == pytest.approx(300.2e9, rel=1e-3)
    assert STARDIST.unet_flops(4096, CFG["segmentation"]) == 16 * got


def test_cae_flops_by_hand():
    # encoder 64->32->16 (conv before each pool), decoder at 8, 16, 32, output at 64
    layers = [(64, 1, 32), (32, 32, 64), (16, 64, 32), (8, 32, 32), (16, 32, 64),
              (32, 64, 32), (64, 32, 1)]
    hand = sum(2 * s * s * ci * co * 9 for s, ci, co in layers)
    assert work.cae_flops(CFG["scoring"]) == hand
    assert hand == pytest.approx(100e6, rel=0.01)


def test_least_times():
    seg = CFG["segmentation"]
    # Conv_1 at a 1024^2 frame is bound by its bytes, Conv_8 by its FLOPs
    t = work.conv3x3_least_seconds(STARDIST.conv3x3_layers(1024, seg), 16)
    assert 9e-3 < t < 12e-3
    assert work.percentile_least_seconds(16, 1024) == pytest.approx(16 * 2 ** 22 / 3.35e12)
    assert work.clahe_least_seconds(1000) == pytest.approx(8000 / 3.35e12)
