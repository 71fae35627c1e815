"""The Cellpose configuration's files: its backend found by name, its work
counts, a reference that imports nothing of the program, and per-layer
readers that read nothing where there is nothing to read."""

import ast
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import backends, harness, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(HERE, "configs", "cellpose_cyto3.json")))
WORKLOAD = json.load(open(os.path.join(HERE, "workloads", "cellpose_cyto3.f1024_b16.json")))
SEG = dict(CFG["segmentation"], **WORKLOAD["segmentation"])
NEW_METRICS = ("follow_flows_roofline", "cellpose_masks_host_ms", "flow_qc_host_ms")


def test_the_backend_is_found_by_name():
    assert CFG["segmentation"]["backend"] == "cellpose"
    assert os.path.isdir(backends.directory("cellpose"))
    assert callable(backends.module("cellpose", "system").build)
    ref = backends.module("cellpose", "reference")
    assert callable(ref.load) and callable(ref.labels)
    counts = backends.module("cellpose", "counts")
    assert callable(counts.frame_flops) and callable(counts.conv3x3_layers)


def test_conv3x3_layers_are_cpnets_32_on_36_tiles():
    counts = backends.module("cellpose", "counts")
    assert counts.tiles_a_side(1024, SEG) == 6                     # 1040^2 padded
    layers = counts.conv3x3_layers(1024, SEG)
    assert len(layers) == 32
    sides = sorted({h for _, h, w, _, _ in layers})
    assert sides == [6 * 224 // 8, 6 * 224 // 4, 6 * 224 // 2, 6 * 224]
    assert ("down0.conv0", 1344, 1344, 2, 32) in layers
    assert ("up3.conv3", 168, 168, 256, 256) in layers
    assert counts.tiles_a_side(4096, SEG) == 23 and counts.tiles_a_side(200, SEG) == 1


def test_frame_flops_is_the_sum_over_the_layers():
    counts = backends.module("cellpose", "counts")
    side = 6 * 224
    convs = sum(work.conv_flops(h, w, ci, co, k)
                for _, h, w, ci, co, k in counts.cpnet_layers(side, SEG["nbase"]))
    style = 36 * 3 * 2.0 * 256 * (32 + 64 + 128 + 256)
    assert counts.frame_flops(1024, SEG) == pytest.approx(convs + style, rel=1e-12)
    three = sum(work.conv_flops(h, w, ci, co, 3) for _, h, w, ci, co in
                counts.conv3x3_layers(1024, SEG))
    assert three < counts.frame_flops(1024, SEG) < 1.05 * three
    # 31.0 GFLOP a 224^2 tile
    assert counts.frame_flops(1024, SEG) / 36 == pytest.approx(31.0e9, rel=2e-3)
    assert counts.follow_flows_bytes(1024, SEG) == 20 * 1024 * 1024


@pytest.mark.parametrize("path", ["reference/cellpose.py", "backends/cellpose/reference.py",
                                  "backends/cellpose/counts.py",
                                  *(f"metrics/{m}.py" for m in NEW_METRICS)])
def test_the_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "cell_image_analysis_tpu",
                       "cell_image_analysis_tpu_torch"}


def _ctx(trace=None, traced=(), spans=None):
    return SimpleNamespace(config=CFG, workload=WORKLOAD, traffic={"size": 1024},
                           device_type="cuda", seconds=30.0,
                           batches=[dict(frames=np.arange(16), cells=800)] * 10,
                           trace=trace, traced_batches=list(traced), spans=spans, counters={})


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metrics_read_nothing_without_a_trace(name):
    read = harness.metric_reader(name)
    assert read(_ctx()) is None
    # a trace with none of the cell's kernels or spans, as the parent's
    other = {"by_name": {"winograd_kernel": 0.1}, "busy_s": 1.0, "window_s": 2.0}
    assert read(_ctx(trace=other, traced=[dict(frames=np.arange(16))] * 6, spans={})) is None


def test_new_metrics_read_the_trace_and_the_spans():
    traced = [dict(frames=np.arange(16))] * 6
    trace = {"by_name": {"follow_flows_kernel": 0.004, "follow_flows_count_kernel": 0.001},
             "busy_s": 1.0, "window_s": 2.0}
    spans = {"cellpose.masks": {"calls": 6, "host_ms": 120.0, "self_ms": 100.0},
             "cellpose.flow_qc": {"calls": 6, "host_ms": 60.0, "self_ms": 60.0}}
    ctx = _ctx(trace=trace, traced=traced, spans=spans)
    least = 96 * 20 * 1024 * 1024 / work.PEAK_BYTES
    assert harness.metric_reader("follow_flows_roofline")(ctx) == pytest.approx(
        100 * least / 0.005)
    assert harness.metric_reader("cellpose_masks_host_ms")(ctx) == pytest.approx(20.0)
    assert harness.metric_reader("flow_qc_host_ms")(ctx) == pytest.approx(10.0)
