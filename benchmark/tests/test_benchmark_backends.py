"""Segmentation backends found by name, and what the metrics can read of the
port: a backend that only new files bring runs through the harness, an
unknown one stops a run before set-up, the work counts stay as they were,
and `ctx` carries the port's counters and spans."""

import copy
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import backends, harness, program, work
from benchmark.reference.screen import Reference
from benchmark.tests.conftest import ROOT, tiny_cell

torch.set_num_threads(4)
CPU = torch.device("cpu")

# each module of the toy delegates to the threshold backend's and notes
# in the toy's directory that it ran
TOY = '''
import os

from benchmark.backends.threshold import {module} as _threshold


def _ran(what):
    with open(os.path.join(os.path.dirname(__file__), "ran.txt"), "a") as f:
        f.write(what + "\\n")

{body}
'''
TOY_BODIES = {
    "system": '''
def build(seg, weights, device):
    _ran("system.build")
    return _threshold.build(seg, weights, device)
''',
    "reference": '''
def load(seg, weights, device):
    _ran("reference.load")
    return _threshold.load(seg, weights, device)


def labels(state, seg_channel, seg):
    return _threshold.labels(state, seg_channel, seg)
''',
    "counts": '''
def frame_flops(size, seg):
    return 1e9


def conv3x3_layers(size, seg):
    return [("toy", size, size, 1, 8)]
''',
}


def _named(cell, backend: str):
    """The cell `cell` at a test's size, its configuration naming `backend`."""
    c = tiny_cell(cell)
    c.config = copy.deepcopy(c.config)
    c.config["segmentation"]["backend"] = backend
    return c


def test_a_backend_brought_as_files_runs_through_the_harness(tmp_path, monkeypatch):
    toy = tmp_path / "toy"
    toy.mkdir()
    for module, body in TOY_BODIES.items():
        (toy / f"{module}.py").write_text(TOY.format(module=module, body=body))
    monkeypatch.setattr(backends, "BACKENDS", str(tmp_path))
    c = _named("threshold_p90.f1024_b16", "toy")
    line = harness.measure(c, 2 ** 31 + 5, 0.5, False, CPU, ROOT, pool_workers=1)
    assert line["correct"], line["checks"]
    assert line["counts"]["cells_matched"] >= 10
    assert (toy / "ran.txt").read_text().split() == ["system.build", "reference.load"]
    # the metrics take the toy's work counts
    ctx = SimpleNamespace(config=c.config, workload=c.workload, traffic={"size": 1024},
                          device_type="cuda", seconds=2.0, batches=[dict(frames=[0, 1], cells=0)])
    assert harness.metric_reader("mfu")(ctx) == 100.0 * 2e9 / (2.0 * work.PEAK_FLOPS)


def test_an_unknown_backend_stops_the_run_before_set_up(monkeypatch):
    from benchmark.traffic import frames

    def no_pool(*args, **kwargs):
        raise AssertionError("the frame pool was made")

    monkeypatch.setattr(frames, "make_pool", no_pool)
    c = _named("threshold_p90.f1024_b16", "nonexistent")
    where = "benchmark/backends/nonexistent/"
    with pytest.raises(SystemExit, match=where):
        harness.measure(c, 1, 0.5, False, CPU, ROOT, pool_workers=1)
    # and the program and the reference do not fall back to threshold
    with pytest.raises(SystemExit, match=where):
        program.System(c.config, c.workload, ROOT, CPU)
    with pytest.raises(SystemExit, match=where):
        Reference(c.config, c.workload, ROOT, CPU)


# each cell's network FLOPs of one frame, and the least time of the 3x3
# convolutions of its traced frames (6 batches of 16 at 1024^2, 4 of 2 at
# 4096^2), as the counts read before the backends had directories of their own
@pytest.mark.parametrize("cell,frames,flops,least", [
    ("stardist_fluo.f1024_b16", 96, 300247154688.0, 0.06721621418703717),
    ("stardist_fluo.f1024_b16", 1, 300247154688.0, 0.0007002893256423338),
    ("stardist_fluo.f4096_b2", 8, 4803954475008.0, 0.08962157835087542),
    ("threshold_p90.f1024_b16", 96, 0.0, 0.0),
])
def test_work_counts_are_frozen(cell, frames, flops, least):
    c = harness.load_cell(ROOT, cell)
    seg = dict(c.config["segmentation"], **c.workload["segmentation"])
    counts = backends.module(seg["backend"], "counts")
    size = c.traffic["size"]
    assert counts.frame_flops(size, seg) == flops
    assert work.conv3x3_least_seconds(counts.conv3x3_layers(size, seg), frames) == least
    assert work.cae_flops(c.config["scoring"]) == 100270080.0


METRICS = {
    "cells_counted": "def read(ctx):\n    return ctx.counters.get('cells.scored')\n",
    "cells_returned": "def read(ctx):\n    return sum(b['cells'] for b in ctx.batches)\n",
    "start_calls": ("def read(ctx):\n"
                    "    return None if ctx.spans is None else ctx.spans['scoring.start']['calls']\n"),
    "wait_calls": ("def read(ctx):\n"
                   "    return None if ctx.spans is None else ctx.spans['scoring.wait']['calls']\n"),
}


@pytest.mark.parametrize("traced", [False, True])
def test_metrics_read_the_ports_counters_and_spans(traced, tmp_path, monkeypatch):
    c = tiny_cell("threshold_p90.f1024_b16")
    os.mkdir(tmp_path / "metrics")
    for name, src in METRICS.items():
        (tmp_path / "metrics" / f"{name}.py").write_text(src)
    entries = [{"name": name, "unit": "1"} for name in METRICS]
    c.end_to_end, c.per_layer = entries, entries
    # a metric is a file found by name: here, under tmp_path
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    line = harness.measure(c, 2 ** 31 + 77, 0.5, traced, CPU, ROOT, pool_workers=1)
    got = {k: m["value"] for k, m in line["metrics"].items()}
    # the counter over the untraced window alone: the cells its batches returned
    assert got["cells_counted"] == got["cells_returned"] > 0
    if traced:
        assert got["start_calls"] >= c.workload["trace_batches"]
        assert got["wait_calls"] >= c.workload["trace_batches"]
    else:
        assert "start_calls" not in got and "wait_calls" not in got
