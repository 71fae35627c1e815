"""PyTorch port: the spans and counters of `utils.profiler` on the screening
path (`pipeline.scoring.score_frames_fused_start` / `_wait`).

- Under a `torch.profiler` session one batch records its span tree, both
  halves under one batch id, each span also a user annotation of the
  profiler; with no session nothing is recorded and `record_function` is
  never entered; tracing changes no score and no statistic;
- the counters: `nms.iterations` is the fixpoint's rounds, a forced
  overflow counts its batch and its reason and runs the twin, the cell and
  slot counts add up;
- the root spans agree with a host clock around the two calls; a mesh
  nests each shard's start under the batch's;
- `StageTimer` keeps its totals and counts, its stages root spans;
- the stats' crop boxes are what the benchmark reads from the handle;
- `cli screen --trace-dir` writes the trace and the spans' summary, and
  the screening report prints the counters;
- `scripts/profile_torch_port.py` gives a kernel's device time to the
  innermost span open at its launch.
"""

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_helpers import BENCH_SEG, BENCH_STAGE_A, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend, ThresholdBackend
from cell_image_analysis_tpu_torch.ops.nms import star_nms
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    frame_geometry,
    score_frames_fused,
    score_frames_fused_start,
    score_frames_fused_wait,
)
from cell_image_analysis_tpu_torch.utils import profiler
from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESH_STAGE_A = dict(label_capacity=4096, cell_capacity=128, fg_fraction=0.12)

START_SPANS = {
    "threshold": ["segmentation.threshold", "segmentation.cc", "extract.stage_a",
                  "scoring.copy_out"],
    "stardist": ["segmentation.normalize", "segmentation.unet", "segmentation.topk",
                 "nms.star_nms", "rasterize", "extract.stage_a", "scoring.copy_out"],
}
WAIT_SPANS = ["scoring.flags", "extract.bucket", "clahe.bucket", "resize.chunk",
              "scoring.score_cells", "scoring.fetch"]


def _frames(seed, n=2, size=256, n_cells=14):
    rng = np.random.default_rng(seed)
    frames = np.stack([make_frame(rng, size=size, n_cells=n_cells) for _ in range(n)])
    return (torch.from_numpy(frames[..., 2].astype(np.float32)),
            torch.from_numpy(frames[..., 1].astype(np.float32)))


@pytest.fixture(scope="module")
def scoring():
    return load_scoring_params(device="cpu")


@pytest.fixture(scope="module")
def unet_variables():
    return load_unet_variables()


def _args(route, unet_variables, **seg):
    if route == "threshold":
        fn = ThresholdBackend()
        return fn, dict(chunk=32, caps=(64, 96), rcap=32, fallback_segment_fn=fn.exact_twin(),
                        **THRESH_STAGE_A)
    cfg = dataclasses.replace(BENCH_SEG, nms_max_pairs=BENCH_SEG.max_candidates ** 2, **seg)
    fn = StarDistBackend(unet_variables, cfg, device="cpu")
    return fn, dict(chunk=32, caps=(64, 96), fallback_segment_fn=fn.exact_twin(),
                    **BENCH_STAGE_A)


@contextlib.contextmanager
def _session():
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def _batch(scoring, fn, kw, frames):
    return score_frames_fused_wait(score_frames_fused_start(*scoring, *frames, fn, **kw))


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


@pytest.mark.parametrize("route", ["threshold", "stardist"])
def test_a_traced_batch_records_the_span_tree(scoring, unet_variables, route):
    fn, kw = _args(route, unet_variables)
    frames = _frames(5)
    _batch(scoring, fn, kw, frames)                       # warm
    with _session() as prof:
        pend = score_frames_fused_start(*scoring, *frames, fn, **kw)
        scores, stats = score_frames_fused_wait(pend)
    recs = profiler.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in roots] == ["scoring.start", "scoring.wait"]
    start, wait = roots
    assert _children(recs, start) == START_SPANS[route]
    names = [r.name for r in recs]
    for name in START_SPANS[route] + WAIT_SPANS:
        assert name in names, name
    assert {"scoring.flags", "extract.bucket", "scoring.fetch"} == set(_children(recs, wait))
    for i, r in enumerate(recs):
        assert r.end_ns >= r.start_ns > 0, r
        assert r.parent < i
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (p, r)
        if r.name in ("clahe.bucket", "resize.chunk", "scoring.score_cells"):
            assert recs[r.parent].name == "extract.bucket"
        assert not r.name.startswith("bench.")
    # one batch id, drawn by the start half and carried by the handle
    assert {r.batch for r in recs} == {pend["batch"]}
    c = profiler.counters()
    buckets = [r.arg for r in recs if r.name == "extract.bucket"]
    assert buckets == [k.split("_")[1] for k in c if k.startswith("cells.bucket_")]
    assert sum(r.name == "scoring.score_cells" for r in recs) == c["chunks"]
    # the same ranges are the profiler's user annotations
    annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    assert set(names) <= annotations
    assert len(scores["reconstruction_mse"]) == len(stats["area"]) >= 10


def test_without_a_session_nothing_is_recorded(scoring, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("record_function entered with no profiler session")

    monkeypatch.setattr(profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    fn, kw = _args("threshold", None)
    profiler.reset()
    assert profiler.span("scoring.start") is profiler.span("extract.bucket", arg=64)
    scores, stats = _batch(scoring, fn, kw, _frames(5))
    assert profiler.records() == [] and profiler.summary()["spans"] == {}
    # the counters stay on
    assert profiler.counters()["cells.scored"] == len(stats["area"]) >= 10


@pytest.mark.parametrize("route", ["threshold", "stardist"])
def test_tracing_changes_no_score_and_no_statistic(scoring, unet_variables, route):
    fn, kw = _args(route, unet_variables)
    frames = _frames(6)
    off = _batch(scoring, fn, kw, frames)
    with _session():
        on = _batch(scoring, fn, kw, frames)
    assert profiler.records()
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_nms_iterations_count_the_fixpoint_rounds(monkeypatch):
    rng = np.random.default_rng(2)
    B, K, R = 2, 40, 32
    centers = torch.from_numpy(rng.uniform(10, 90, size=(B, K, 2)).astype(np.float32))
    dists = torch.from_numpy(rng.uniform(3, 12, size=(B, K, R)).astype(np.float32))
    probs = torch.from_numpy(rng.uniform(0.5, 1, size=(B, K)).astype(np.float32))
    valid = torch.ones(B, K, dtype=torch.bool)
    rounds = []
    real_equal = torch.equal

    def counting(a, b):
        rounds.append(1)
        return real_equal(a, b)

    profiler.reset()
    monkeypatch.setattr(torch, "equal", counting)
    keep, _ = star_nms(centers, dists, probs, valid, max_pairs=None)
    monkeypatch.setattr(torch, "equal", real_equal)
    c = profiler.counters()
    assert len(rounds) >= 3              # crowded: suppression takes rounds
    assert c["nms.iterations"] == c["host_waits.nms"] == len(rounds)
    assert c["host_waits.pair_count"] == 1
    assert 0 < int(keep.sum()) < B * K


def test_a_forced_overflow_counts_its_reason_and_runs_the_twin(scoring, unet_variables):
    fn, kw = _args("stardist", unet_variables, max_candidates=2)
    calls = []

    class Twin:
        returns_overflow, runs_props = True, False

        def __call__(self, s):
            calls.append(s.shape[0])
            return kw["fallback_segment_fn"](s)

    frames = _frames(5)
    with _session():
        pend = score_frames_fused_start(*scoring, *frames, fn, **{**kw, "fallback_segment_fn":
                                                                   Twin()})
        # bit 0 of the first B ints: the candidate cap K fired in every frame
        assert pend["ints"][:2].tolist() == [1, 1]
        with warnings.catch_warnings():
            # the twin runs at the same K, so its own flag fires with no fallback
            warnings.simplefilter("ignore", RuntimeWarning)
            score_frames_fused_wait(pend)
    c = profiler.counters()
    assert calls == [2]
    assert c["fallback.batches"] == 1 and c["fallback.candidates"] == 1
    assert not any(k in c for k in ("fallback.nms_pairs", "fallback.raster", "fallback.stage_a"))
    assert c["overflow.no_fallback"] == 1
    assert frame_geometry(pend).shape == (2,)
    recs = profiler.records()
    fb = [i for i, r in enumerate(recs) if r.name == "scoring.fallback"]
    assert len(fb) == 1 and recs[recs[fb[0]].parent].name == "scoring.wait"
    assert _children(recs, fb[0]) == ["scoring.start", "scoring.wait"]
    assert {r.batch for r in recs} == {pend["batch"]}


def test_a_run_table_overflow_is_the_stage_a_reason(scoring):
    fn, kw = _args("threshold", None)
    profiler.reset()
    pend = score_frames_fused_start(*scoring, *_frames(5), fn, **{**kw, "rcap": 2})
    assert set(pend["ints"][:2].tolist()) <= {0, 8} and pend["ints"][:2].any()
    score_frames_fused_wait(pend)
    c = profiler.counters()
    assert c["fallback.batches"] == 1 and c["fallback.stage_a"] == 1


def test_counters_add_up(scoring):
    fn, kw = _args("threshold", None)
    profiler.reset()
    scores, stats = _batch(scoring, fn, kw, _frames(7, n=3))
    c = profiler.counters()
    n = len(stats["area"])
    assert c["batches"] == 1 and c["cells.scored"] == c["slots.valid"] == n >= 10
    assert c["slots"] == 3 * THRESH_STAGE_A["cell_capacity"]
    assert sum(v for k, v in c.items() if k.startswith("cells.bucket_")) == n
    assert c["chunks"] == sum(-(-v // kw["chunk"]) for k, v in c.items()
                              if k.startswith("cells.bucket_"))
    assert c["host_waits.flags"] == c["host_waits.fetch"] == 1
    assert profiler.counters(since=c) == {}
    profiler.count("cells.scored", 5)
    assert profiler.counters(since=c) == {"cells.scored": 5}


def test_root_spans_agree_with_a_host_clock(scoring, unet_variables):
    fn, kw = _args("stardist", unet_variables)
    frames = _frames(5)
    _batch(scoring, fn, kw, frames)
    with _session():
        t0 = time.perf_counter_ns()
        pend = score_frames_fused_start(*scoring, *frames, fn, **kw)
        t1 = time.perf_counter_ns()
        score_frames_fused_wait(pend)
        t2 = time.perf_counter_ns()
    s = profiler.summary()
    assert s["batches"] == 1
    for name, clock in (("scoring.start", t1 - t0), ("scoring.wait", t2 - t1)):
        ms = s["spans"][name]["host_ms"]
        assert abs(ms - clock * 1e-6) <= 0.05 * clock * 1e-6, (name, ms, clock)
        assert s["spans"][name]["host_ms_a_batch"] == ms
        assert 0 <= s["spans"][name]["self_ms"] <= 0.1 * ms


def test_a_mesh_nests_each_shard_under_the_batch(scoring):
    fn, kw = _args("threshold", None)
    frames = _frames(8, n=4)
    with _session():
        pend = score_frames_fused_start(*scoring, *frames, fn, mesh=virtual_mesh("cpu", 2),
                                        **kw)
        score_frames_fused_wait(pend)
    recs = profiler.records()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in roots] == ["scoring.start", "scoring.wait"]
    assert _children(recs, roots[0]) == ["scoring.start", "scoring.start"]
    assert {r.batch for r in recs} == {pend["batch"]}
    assert all(sh["batch"] == pend["batch"] for sh in pend["shards"])
    assert sum(r.name == "scoring.fetch" for r in recs) == 2


def test_stage_timer_reports_and_counts_as_before():
    timer = profiler.StageTimer()
    with timer.stage("a"):
        time.sleep(0.01)
    with _session():
        with timer.stage("a"):
            with profiler.span("inner"):
                time.sleep(0.01)
        with timer.stage("b"):
            pass
    assert timer.counts == {"a": 2, "b": 1}
    assert timer.totals["a"] >= 0.02
    assert set(timer.summary()) == {"a", "b"}
    report = timer.report()
    assert "host seconds" in report and "a " in report and "(2 calls" in report
    recs = profiler.records()
    assert [(r.name, r.parent) for r in recs] == [("a", -1), ("inner", 0), ("b", -1)]
    s = profiler.summary()
    assert s["batches"] == 0 and s["spans"]["a"]["host_ms_a_batch"] is None
    assert s["spans"]["a"]["self_ms"] < s["spans"]["a"]["host_ms"]
    profiler.reset()
    assert profiler.records() == [] and profiler.counters() == {}


def test_the_crop_box_is_what_the_benchmark_reads(scoring, unet_variables):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.program import handle_cells

    for route in ("threshold", "stardist"):
        fn, kw = _args(route, unet_variables)
        pend = score_frames_fused_start(*scoring, *_frames(9), fn, **kw)
        _, stats = score_frames_fused_wait(pend)
        heights, widths = handle_cells(pend, stats, crop_capacity=192)
        assert len(heights) == len(stats["area"]) >= 10
        np.testing.assert_array_equal(stats["bbox_height"], heights)
        np.testing.assert_array_equal(stats["bbox_width"], widths)
        assert stats["bbox_height"].dtype == stats["area"].dtype == np.int32
        assert (stats["bbox_height"] * stats["bbox_width"] >= stats["area"]).all()


def test_the_stats_carry_the_crop_box(scoring):
    fn, kw = _args("threshold", None)
    scores, stats = score_frames_fused(*scoring, *_frames(5), fn, **kw)
    assert list(stats) == ["label_ids", "area", "eccentricity", "mean_intensity",
                           "std_intensity", "bbox_height", "bbox_width", "frame_index"]


def test_cli_screen_writes_the_trace_and_the_summary(tmp_path, capsys):
    from cell_image_analysis_tpu_torch import cli
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    folder = str(tmp_path / "wt")
    make_dataset(folder, n_frames=2, size=256, n_cells=12, seed=4)
    trace_dir = tmp_path / "trace"
    store = os.path.join(ROOT, "assets", "screening_store_synthetic")
    assert cli.main(["screen", "--models", store, "--sample", f"wt={folder}", "--backend",
                     "threshold", "--device", "cpu", "--no-figures", "--output",
                     str(tmp_path / "out"), "--trace-dir", str(trace_dir)]) == 0
    printed = capsys.readouterr().out
    files = sorted(os.listdir(trace_dir))
    assert [f.split("_")[0] for f in files] == ["summary", "trace"]
    with open(trace_dir / files[0]) as f:
        summary = json.load(f)
    assert summary["batches"] >= 1 and summary["spans"]["scoring.wait"]["calls"] >= 1
    assert summary["spans"]["score_frames"]["calls"] >= 2    # the StageTimer's stage
    with open(trace_dir / files[1]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"scoring.start", "extract.bucket", "scoring.fetch"} <= names
    report = printed.split("counters:")[1]
    assert "cells.scored" in report and "host_waits.fetch" in report
    assert f"Trace and span summary written to: {trace_dir}" in printed


def test_cli_screen_without_trace_dir_prints_the_counters(tmp_path, capsys):
    from cell_image_analysis_tpu_torch import cli
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    folder = str(tmp_path / "wt")
    make_dataset(folder, n_frames=1, size=256, n_cells=12, seed=4)
    profiler.reset()
    profiler.count("cells.scored", 1000)          # an earlier screening's
    assert cli.main(["screen", "--models", os.path.join(ROOT, "assets",
                                                        "screening_store_synthetic"),
                     "--sample", f"wt={folder}", "--backend", "threshold", "--device", "cpu",
                     "--no-figures", "--output", str(tmp_path / "out")]) == 0
    printed = capsys.readouterr().out
    total = int(printed.split("Total wt cells: ")[1].split()[0])
    lines = printed.split("counters:")[1].splitlines()
    scored = [ln.split() for ln in lines if ln.split()[:1] == ["cells.scored"]]
    assert scored == [["cells.scored", str(total)]] and total > 0
    assert not os.path.exists(tmp_path / "trace")


class _Event:
    """A profiler event as `device_ms_by_span` reads it: on the host, or a
    kernel on the device sharing its launch call's id."""

    def __init__(self, name, start, end, device="CPU", id=0, annotation=False):
        self.name, self.id, self.is_user_annotation = name, id, annotation
        self.device_type = type("D", (), {"name": device})()
        self.time_range = type("T", (), {"start": start, "end": end})()


def test_the_span_table_gives_a_kernel_to_the_innermost_span():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_port", os.path.join(ROOT, "scripts", "profile_torch_port.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    events = [
        _Event("scoring.wait", 0, 100), _Event("extract.bucket", 10, 60),
        _Event("resize.chunk", 20, 30), _Event("aten::mul", 21, 23, id=7),
        _Event("cudaLaunchKernel", 22, 23, id=101),
        _Event("cudaLaunchKernelExC", 40, 41, id=102),      # in the bucket, after the chunk
        _Event("cudaMemcpyAsync", 72, 73, id=103),
        _Event("scoring.fetch", 70, 80),
        _Event("cudaLaunchKernel", 150, 151, id=104),       # outside every span
        _Event("mul_kernel", 500, 4500, "CUDA", id=101),
        _Event("clahe_cells_kernel", 600, 1600, "CUDA", id=102),
        _Event("Memcpy DtoH", 700, 950, "CUDA", id=103),
        _Event("cat_kernel", 5000, 7000, "CUDA", id=104),
        _Event("lost_kernel", 8000, 8500, "CUDA", id=999),  # its launch call not seen
        _Event("resize.chunk", 500, 9000, "CUDA", annotation=True),
        _Event("aten::view", 25, 26, id=8),
    ]
    got = script.device_ms_by_span(events, {"scoring.wait", "extract.bucket", "resize.chunk",
                                            "scoring.fetch"})
    assert got == pytest.approx({"resize.chunk": 4.0, "extract.bucket": 1.0,
                                 "scoring.fetch": 0.25, "(outside the spans)": 2.0,
                                 "(no launch call seen)": 0.5})
