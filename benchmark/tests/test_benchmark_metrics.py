"""The per-layer readers on made-up runs: what they read, and that a reader
with nothing to read returns nothing."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import backends, harness, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(HERE, "configs", "stardist_fluo.json")))
WORKLOAD = json.load(open(os.path.join(HERE, "workloads", "stardist_fluo.f1024_b16.json")))


def _ctx(device_type="cuda", trace=None, traced=()):
    batches = [dict(frames=np.arange(16), cells=800) for _ in range(100)]
    return SimpleNamespace(config=CFG, workload=WORKLOAD, traffic={"size": 1024},
                           device_type=device_type, seconds=30.0, batches=batches,
                           trace=trace, traced_batches=list(traced))


def test_mfu_reads_the_untraced_window():
    seg = dict(CFG["segmentation"], **WORKLOAD["segmentation"])
    stardist = backends.module("stardist", "counts")
    frame = stardist.unet_flops(1024, seg) + stardist.dist_head_flops(seg, 256)
    flops = 1600 * frame + 80000 * work.cae_flops(CFG["scoring"])
    got = harness.metric_reader("mfu")(_ctx())
    assert got == pytest.approx(100 * flops / (30.0 * work.PEAK_FLOPS))
    # the traced window does not enter
    assert harness.metric_reader("mfu")(_ctx(trace={"window_s": 1.0})) == got
    assert harness.metric_reader("mfu")(_ctx(device_type="cpu")) is None


def test_device_idle_is_busy_a_traced_batch_over_seconds_an_untraced_batch():
    # 6 traced batches busy 1.2 s in all (0.2 s a batch) against 0.3 s a
    # batch untraced (30 s over 100 batches): a third idle, whatever the
    # traced window's own length
    ctx = _ctx(trace={"busy_s": 1.2, "window_s": 3.0}, traced=[{}] * 6)
    assert harness.metric_reader("device_idle_pct")(ctx) == pytest.approx(100 / 3)
    assert harness.metric_reader("device_idle_pct")(_ctx()) is None


def test_clahe_buckets_follow_the_tightest_capacity():
    heights = np.array([20, 64, 65, 96, 97, 14, 12, 30])
    widths = np.array([20, 64, 30, 96, 20, 40, 12, 15])
    # 14 and 15 px sides ride the full capacity; 12 px fit the first bucket
    assert work.clahe_buckets(heights, widths, (64, 96), 192) == {64: 3, 96: 2, 192: 3}
