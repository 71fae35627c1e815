"""The Cellpose-SAM configuration's files: its backend found by name, its
work counts at the published widths, a reference that imports nothing of
the program, and the two per-layer readers, which read nothing where there
is nothing to read (the parent's program, a cell without a ViT)."""

import ast
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import backends, harness, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(HERE, "configs", "cellpose_sam.json")))
WORKLOAD = json.load(open(os.path.join(HERE, "workloads", "cellpose_sam.f1024_b4.json")))
SEG = dict(CFG["segmentation"], **WORKLOAD["segmentation"])
NEW_METRICS = ("vit_attention_roofline", "vit_attention_fused_pct")


def test_the_backend_is_found_by_name():
    assert SEG["backend"] == "cellpose_sam"
    assert callable(backends.module("cellpose_sam", "system").build)
    ref = backends.module("cellpose_sam", "reference")
    assert callable(ref.load) and callable(ref.labels)
    counts = backends.module("cellpose_sam", "counts")
    for fn in ("frame_flops", "conv3x3_layers", "follow_flows_bytes", "attention_work"):
        assert callable(getattr(counts, fn))


def test_the_configuration_states_the_published_widths():
    v, pub = SEG["vit"], CFG["published_widths"]
    assert (v["dim"], v["depth"], v["heads"], v["hidden"], v["patch"], v["neck"], v["nout"]) == (
        pub["embed_dim"], pub["depth"], pub["num_heads"], pub["mlp_dim"], pub["patch_size"],
        pub["neck_dim"], pub["nout"]) == (1024, 24, 16, 4096, 8, 256, 3)
    assert v["rows"] == [127 if i in pub["global_attn_indexes"] else 27 for i in range(24)]
    assert SEG["tile"] == pub["bsize"] == 256 and SEG["tile_chunk"] == 100
    assert CFG["reduced"] == []
    assert any("float32" in a and "bfloat16" in a for a in CFG["assumed"])
    assert "vit_sam.Transformer" in CFG["source"] and "cpsam" in CFG["source"]


def test_a_tile_is_727_gflop():
    counts = backends.module("cellpose_sam", "counts")
    f = counts.tile_flops(SEG)
    assert f["patch"] / 1e9 == pytest.approx(0.403, abs=1e-3)
    assert f["block"] / 1e9 == pytest.approx(30.199, abs=1e-3)
    assert f["neck"] / 1e9 == pytest.approx(1.745, abs=1e-3)
    assert f["readout"] / 1e9 == pytest.approx(0.101, abs=1e-3)
    assert counts.tiles_a_side(1024, SEG) == 5                      # 1040^2 padded
    assert counts.frame_flops(1024, SEG) / 25 / 1e9 == pytest.approx(727.0, abs=0.05)


def test_the_neck_is_the_one_winograd_conv_and_the_attention_work():
    counts = backends.module("cellpose_sam", "counts")
    assert counts.conv3x3_layers(1024, SEG) == [("neck.2", 160, 160, 256, 256)]
    flops, nbytes = counts.attention_work(1024, SEG)
    calls = 25 * 24
    assert flops == pytest.approx(calls * (4 * 16 * 1024 ** 2 * 64 + 2 * 16 * 1024 ** 2))
    assert nbytes == pytest.approx(calls * 4 * 16 * 1024 * (4 * 64 + 32 + 32))
    assert counts.follow_flows_bytes(1024, SEG) == 20 * 1024 * 1024


@pytest.mark.parametrize("path", ["reference/cellpose_sam.py", "backends/cellpose_sam/reference.py",
                                  "backends/cellpose_sam/counts.py",
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


def test_the_system_imports_the_vit_first():
    # a program without models.vit_sam fails at the first line of build
    src = open(os.path.join(HERE, "backends", "cellpose_sam", "system.py")).read()
    body = ast.parse(src).body[-1].body
    first = next(n for n in body if isinstance(n, ast.ImportFrom))
    assert first.module == "cell_image_analysis_tpu_torch.models" and first.names[0].name == "vit_sam"


def _ctx(trace=None, traced=(), counters=None):
    return SimpleNamespace(config=CFG, workload=WORKLOAD, traffic={"size": 1024},
                           device_type="cuda", seconds=30.0,
                           batches=[dict(frames=np.arange(4), cells=300)] * 10,
                           trace=trace, traced_batches=list(traced), spans={},
                           counters=counters or {})


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metrics_read_nothing_where_there_is_nothing(name):
    read = harness.metric_reader(name)
    assert read(_ctx()) is None
    other = {"by_name": {"winograd_kernel": 0.1}, "busy_s": 1.0, "window_s": 2.0}
    assert read(_ctx(trace=other, traced=[dict(frames=np.arange(4))] * 6,
                     counters={"winograd.launches": 4})) is None


def test_new_metrics_read_the_trace_and_the_counters():
    traced = [dict(frames=np.arange(4))] * 6
    trace = {"by_name": {"vit_attention_kernel": 0.5}, "busy_s": 1.0, "window_s": 2.0}
    counts = backends.module("cellpose_sam", "counts")
    flops, nbytes = counts.attention_work(1024, SEG)
    least = 24 * max(flops / work.PEAK_FLOPS, nbytes / work.PEAK_BYTES)
    assert harness.metric_reader("vit_attention_roofline")(_ctx(trace=trace, traced=traced)) == (
        pytest.approx(100 * least / 0.5))
    read = harness.metric_reader("vit_attention_fused_pct")
    assert read(_ctx(counters={"vit.attention_calls": 96, "vit.attention_fused": 96})) == 100.0
    assert read(_ctx(counters={"vit.attention_calls": 96, "vit.attention_fused": 48})) == 50.0


def test_the_cell_is_reported_by_the_cellpose_metrics():
    c = harness.load_cell(os.path.dirname(HERE), "cellpose_sam.f1024_b4")
    assert c.cell["chips"] == 1 and c.traffic["frame_batch"] == 4
    names = {m["name"] for m in c.per_layer}
    # the neck's 3x3 conv runs the Winograd kernel, with no activation beside it
    assert set(NEW_METRICS) | {"unet_conv3x3_roofline", "follow_flows_roofline", "mfu",
                               "percentile_roofline", "clahe_cells_roofline",
                               "winograd_fused_pct"} <= names
    assert {m["name"] for m in c.end_to_end} == {"cells_per_s", "batch_p90_ms", "peak_gib",
                                                  "setup_s"}
