"""The two per-layer readers of the ViT linear kernel (csrc/vit_linear.cu):
`vit_linear_roofline` (device trace) and `vit_linear_fused_pct` (program
counters), as `test_benchmark_cellpose_sam.py` holds the attention's: they
import nothing of the program, read nothing where there is nothing to read
(the parent's program, a cell without a ViT), read the trace and the
counters, and the Cellpose-SAM cell reports them."""

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
NEW_METRICS = ("vit_linear_roofline", "vit_linear_fused_pct")


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_reader_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(HERE, "metrics", f"{name}.py")).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "cell_image_analysis_tpu",
                       "cell_image_analysis_tpu_torch"}


def _ctx(trace=None, traced=(), counters=None, config=CFG, workload=WORKLOAD):
    return SimpleNamespace(config=config, workload=workload, traffic={"size": 1024},
                           device_type="cuda", seconds=30.0,
                           batches=[dict(frames=np.arange(4), cells=300)] * 10,
                           trace=trace, traced_batches=list(traced), spans={},
                           counters=counters or {})


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_readers_read_nothing_where_there_is_nothing(name):
    read = harness.metric_reader(name)
    assert read(_ctx()) is None
    # the parent's program: cuBLAS's SGEMM and the attention, no linear kernel or counter
    parent = {"by_name": {"sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3": 1.2,
                          "vit_attention_kernel": 0.2}, "busy_s": 1.6, "window_s": 1.7}
    assert read(_ctx(trace=parent, traced=[dict(frames=np.arange(4))] * 6,
                     counters={"vit.attention_calls": 24, "vit.attention_fused": 24})) is None


def test_the_roofline_reads_nothing_in_a_cell_without_a_vit():
    cyto3 = json.load(open(os.path.join(HERE, "configs", "cellpose_cyto3.json")))
    work_ = json.load(open(os.path.join(HERE, "workloads", "cellpose_cyto3.f1024_b16.json")))
    trace = {"by_name": {"vit_linear_kernel": 0.5}, "busy_s": 1.0, "window_s": 2.0}
    read = harness.metric_reader("vit_linear_roofline")
    assert read(_ctx(trace=trace, traced=[dict(frames=np.arange(16))], config=cyto3,
                     workload=work_)) is None


def test_the_roofline_is_one_tf32_product_of_the_blocks_linears_over_the_kernels_time():
    traced = [dict(frames=np.arange(4))] * 6
    trace = {"by_name": {"vit_linear_kernel": 3.0, "vit_attention_kernel": 0.5}, "busy_s": 4.0,
             "window_s": 4.1}
    got = harness.metric_reader("vit_linear_roofline")(_ctx(trace=trace, traced=traced))
    # 25 tiles a frame, 24 blocks, 1,024 tokens of 1,024, MLP 4,096
    flops = 24 * 25 * 24 * 2.0 * 1024 * 1024 * (4 * 1024 + 2 * 4096)
    assert got == pytest.approx(100 * flops / work.PEAK_FLOPS / 3.0)
    # the same work as `counts.tile_flops`' linear share of a block
    f = backends.module("cellpose_sam", "counts").tile_flops(SEG)
    linear = 2.0 * 1024 * 1024 * (4 * 1024 + 2 * 4096)
    assert linear < f["block"] and f["block"] - linear == pytest.approx(
        4.0 * 16 * 1024 ** 2 * 64 + 4.0 * 16 * 1024 * 32 * 64)


@pytest.mark.parametrize("fused,want", [(96, 100.0), (48, 50.0), (0, 0.0)])
def test_the_fused_share_reads_the_counters(fused, want):
    read = harness.metric_reader("vit_linear_fused_pct")
    assert read(_ctx(counters={"vit.linear_calls": 96, "vit.linear_fused": fused})) == want


def test_the_cell_reports_both_and_moves_cells_per_s():
    c = harness.load_cell(os.path.dirname(HERE), "cellpose_sam.f1024_b4")
    entries = {m["name"]: m for m in c.per_layer}
    for name in NEW_METRICS:
        assert entries[name]["moves"] == "cells_per_s"
        assert entries[name]["layer"] == "kernel: ops.vit_linear (csrc/vit_linear.cu)"
    for other in ("stardist_fluo.f1024_b16", "threshold_p90.f1024_b16", "cellpose_cyto3.f1024_b16"):
        names = {m["name"] for m in harness.load_cell(os.path.dirname(HERE), other).per_layer}
        assert not names & set(NEW_METRICS), other
