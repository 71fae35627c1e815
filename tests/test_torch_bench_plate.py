"""PyTorch port: the plate-scale bench rows (`utils/bench.plate_settings`,
`run_device_bench(frame_batch=, fused=)`, `scripts/bench_2048_torch.py`,
`scripts/bench_4096_torch.py`).

- `plate_settings(1024)` (and below) is the 1024^2 bench's `STARDIST_SEG` /
  `STARDIST_KW`; `plate_settings(4096)` is JAX's `scripts/bench_4096.py`
  capacities but the cell capacity; `plate_settings(2048)` follows the
  screener's rule (`config.capacity_scale`, `row_scale`,
  `scaled_seg_config`).
- `pipeline/scoring.frame_geometry` counts each frame's geometry-passing
  labels in the run itself, also past the cell capacity and after a
  fallback, so that the timed rows show a truncation.
- `run_device_bench` at frame batch 2 gives the same cells fused and
  host-chunked (`fused=False`), as many as JAX's `_batch_pipeline(frame_batch=2,
  fused=False)` at the same settings, on 2 frames of 256^2 (the sizes of
  tests/test_torch_bench.py).
- `plate_line` has the JAX scripts' metric names and keys; both scripts
  exit 2 without a GPU unless given `--device cpu`.
- `_make_frames(planted=)` records the planted cells without changing the
  frames; the kernels' wrappers raise on a C `int` argument past int32.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_scoring, torch_threads

from cell_image_analysis_tpu_torch.config import (
    SegConfig,
    capacity_scale,
    row_scale,
    scaled_seg_config,
)
from cell_image_analysis_tpu_torch.utils import bench

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")


def _jax_plate_capacities() -> dict:
    """The `CIA_BENCH_SD_*` values that JAX's scripts/bench_4096.py sets."""
    with open(os.path.join(_REPO, "scripts", "bench_4096.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "CIA_BENCH_SD_CAND" for k in node.keys):
            return {k.value: int(v.value) for k, v in zip(node.keys, node.values)}
    raise AssertionError("scripts/bench_4096.py sets no capacities")


@pytest.mark.parametrize("size", [256, 1000, 1024])
def test_plate_settings_up_to_1024_are_the_bench_settings(size):
    seg, kw = bench.plate_settings(size)
    assert seg == bench.STARDIST_SEG and kw == bench.STARDIST_KW


def test_plate_settings_4096_are_jax_bench_4096_but_the_cell_capacity():
    """JAX's row sets cell capacity 1024; the port's is the rule's 128 x 16
    = 2048: the selection of the first `cell_capacity` geometry-passing
    labels truncates without a flag, and a whole 4096^2 frame of 1,280
    planted cells held 1,324 cells on the card, so 1024 may drop cells
    silently.  The capacity is a bound, not a tuning."""
    jax_caps = _jax_plate_capacities()
    seg, kw = bench.plate_settings(4096)
    assert seg["max_candidates"] == jax_caps["CIA_BENCH_SD_CAND"] == 4096
    assert seg["raster_cap"] == kw["label_capacity"] == jax_caps["CIA_BENCH_SD_RCAP"] == 2048
    assert kw["rcap"] == jax_caps["CIA_BENCH_SD_RUNS_RCAP"] == 128
    assert seg["nms_max_pairs"] == jax_caps["CIA_BENCH_SD_NMSPAIRS"] == 131072
    assert seg["raster_patch"] == bench.STARDIST_SEG["raster_patch"]
    assert (kw["chunk"], kw["caps"]) == (32, (64, 96))
    assert jax_caps["CIA_BENCH_SD_CCAP"] == 1024 and kw["cell_capacity"] == 2048


def test_plate_settings_2048_follow_the_rule():
    """s = 4: K, raster cap, pairs and cell capacity x 4, rcap x 2 (JAX's
    bench_2048.py sets none and runs at K 256)."""
    seg, kw = bench.plate_settings(2048)
    assert capacity_scale(2048, 2048) == 4 and row_scale(2048) == 2
    assert seg == dict(max_candidates=1024, raster_patch=96, raster_cap=512,
                       nms_max_pairs=32768)
    assert kw == dict(label_capacity=512, cell_capacity=512, rcap=64, chunk=32, caps=(64, 96))
    # the screener's scale for another area: ceil(area / 1024^2); rcap x the
    # row-width multiple, floor(1500 / 1024) = 1, as the screener's rcap
    seg, kw = bench.plate_settings(1500)
    assert (seg["max_candidates"], kw["cell_capacity"], kw["rcap"]) == (768, 384, 32)


@pytest.mark.parametrize("scale,raster_cap", [(1, 0), (4, 0), (16, 128)])
def test_scaled_seg_config_scales_the_stardist_capacities(scale, raster_cap):
    """The screener, its tiler and the plate rows scale the StarDist
    backend by `scaled_seg_config`: K, the raster cap (K where unset) and
    the NMS pair budget times the scale; nothing else changes."""
    import dataclasses

    base = SegConfig(raster_cap=raster_cap)
    cfg = scaled_seg_config(base, scale)
    assert (cfg is base) == (scale == 1)
    assert cfg.max_candidates == base.max_candidates * scale
    assert cfg.raster_cap == (raster_cap if scale == 1
                              else (raster_cap or base.max_candidates) * scale)
    assert cfg.nms_max_pairs == base.nms_max_pairs * scale
    same = ("max_candidates", "raster_cap", "nms_max_pairs")
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in same} \
        == {f.name: getattr(base, f.name) for f in dataclasses.fields(base) if f.name not in same}


@pytest.mark.parametrize("backend", ["stardist", "threshold"])
def test_fused_and_chunked_rows_give_jax_chunked_cells(backend):
    """2 frames of 256^2 in one batch of 2: `fused=True` and `fused=False`
    screen the same cells (areas and label ids equal, scores within 1e-5),
    and as many as JAX's host-chunked `_batch_pipeline` at the same
    settings (K 256 ..., the defaults of both at this size)."""
    from cell_image_analysis_tpu.utils.bench import _batch_pipeline as jax_pipeline

    frames = bench._make_frames(2, 256, 10)
    reports = {}
    for fused in (True, False):
        reports[fused] = bench.run_device_bench(n_frames=2, size=256, n_cells=10,
                                                backend=backend, device="cpu", frames=frames,
                                                frame_batch=2, fused=fused)
        assert reports[fused]["frame_batch"] == 2 and reports[fused]["fused"] is fused
        assert reports[fused]["fallback_batches"] == 0 and reports[fused]["batches_run"] == 4
    assert reports[True]["cells"] == reports[False]["cells"] > 0
    assert reports[False]["pending_gib"] is None
    # the timed run's geometry-passing labels a frame, on the pipelined route
    assert len(reports[True]["geometry"]) == 2 and reports[False]["geometry"] is None
    assert sum(reports[True]["geometry"]) >= reports[True]["cells"]

    model, params, _ = bench._fit_params(device="cpu")
    stack = np.stack(frames)
    segs = torch.tensor(stack[..., 2].astype(np.float32))
    greens = torch.tensor(stack[..., 1].astype(np.float32))
    outs = [bench._batch_pipeline(model, params, backend, "cpu", fused=fused)[0](segs, greens)
            for fused in (True, False)]
    (n_f, (sc_f, st_f)), (n_c, (sc_c, st_c)) = outs
    assert n_f == n_c == reports[True]["cells"]
    for k in ("frame_index", "label_ids", "area"):
        np.testing.assert_array_equal(st_f[k], st_c[k])
    np.testing.assert_allclose(sc_f["reconstruction_mse"], sc_c["reconstruction_mse"],
                               rtol=1e-5, atol=1e-7)

    import jax.numpy as jnp

    model_j, params_j = jax_scoring()
    run_j, _ = jax_pipeline(model_j, params_j, frame_batch=2, fused=False, backend=backend)
    n_j, _ = run_j(jnp.asarray(segs.numpy()), jnp.asarray(greens.numpy()))
    assert n_j == reports[False]["cells"]


@pytest.mark.parametrize("cell_capacity,rcap", [(128, None), (3, None), (128, 1)])
def test_frame_geometry_counts_the_run_s_geometry_passing_labels(cell_capacity, rcap):
    """2 frames of 256^2 through the threshold backend's fused path:
    `frame_geometry` of the waited handle equals each frame's labels that
    pass the geometric QC in the exact label route, also where the
    selection of `cell_capacity` truncated (3: no frame gives more than 3
    cells, and the count shows it) and where a run-table overflow (rcap 1)
    made the batch fall back to the exact twin (the re-run's count)."""
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.ops.regionprops import qc_mask, regionprops
    from cell_image_analysis_tpu_torch.pipeline.scoring import (
        frame_geometry,
        score_frames_fused_start,
        score_frames_fused_wait,
    )

    stack = np.stack(bench._make_frames(2, 256, 10))
    segs = torch.tensor(stack[..., 2].astype(np.float32))
    greens = torch.tensor(stack[..., 1].astype(np.float32))
    model, params, _ = bench._fit_params(device="cpu")
    backend = ThresholdBackend()
    kw = dict(bench.THRESHOLD_KW, cell_capacity=cell_capacity)
    if rcap is not None:
        kw["rcap"] = rcap
    pend = score_frames_fused_start(model, params, segs, greens, backend,
                                    fallback_segment_fn=backend.exact_twin(), **kw)
    _, stats = score_frames_fused_wait(pend)
    assert ("rerun" in pend) == (rcap is not None)
    props = regionprops(backend.exact_twin()(segs), capacity=kw["label_capacity"])
    want = qc_mask(props, 256, 256).sum(dim=1).tolist()
    got = frame_geometry(pend)
    assert got.dtype == np.int32 and got.tolist() == want and min(want) > 3
    cells = np.bincount(stats["frame_index"], minlength=2)
    assert np.all(cells <= np.minimum(got, cell_capacity))


@pytest.mark.parametrize("size,keys", [
    (2048, ["metric", "value", "unit", "frames_per_sec", "cells"]),
    (4096, ["metric", "value", "unit", "frames_per_sec", "mpx_per_sec", "cells"])])
def test_plate_line_has_the_jax_scripts_keys(size, keys):
    """scripts/bench_2048.py and scripts/bench_4096.py print these keys in
    this order."""
    res = dict(cells_per_sec=1234.5678, frames_per_sec=0.98765, cells=4321)
    out = json.loads(bench.plate_line(size, res))
    assert list(out) == keys
    assert out["metric"] == f"screening_cells_per_sec_per_chip_stardist_{size}"
    assert (out["value"], out["unit"], out["frames_per_sec"], out["cells"]) == (
        1234.57, "cells/s/chip", 0.988, 4321)
    if size == 4096:
        assert out["mpx_per_sec"] == round(0.98765 * 4096 * 4096 / 1e6, 1)
    assert bench.PLATE_ROWS[size] == ((12, 320, 2) if size == 2048 else (4, 1280, 2))


@pytest.mark.parametrize("size", [2048, 4096])
def test_plate_scripts_need_a_gpu_or_the_device_flag(no_gpu, size):
    done = subprocess.run([sys.executable, os.path.join(_REPO, "scripts",
                                                        f"bench_{size}_torch.py")],
                          capture_output=True, text=True, timeout=120, cwd=_REPO)
    assert done.returncode == 2 and done.stdout == ""
    assert "no CUDA device" in done.stderr and "--device cpu" in done.stderr


def test_make_frames_records_the_planted_cells():
    """`planted` takes each frame's cell centres and short radii without
    changing the frames (byte-equal to the frames made without it)."""
    planted = []
    frames = bench._make_frames(2, 2048, 6, planted=planted)
    plain = bench._make_frames(2, 2048, 6)
    assert all(np.array_equal(a, b) for a, b in zip(frames, plain))
    assert [p.shape for p in planted] == [(6, 3), (6, 3)]
    assert np.all((planted[0][:, :2] >= 30) & (planted[0][:, :2] <= 2048 - 30))
    assert np.all((planted[0][:, 2] >= 9) & (planted[0][:, 2] <= 16))
    with pytest.raises(ValueError, match="2048"):
        bench._make_frames(1, 256, 4, planted=[])


@pytest.mark.parametrize("value,ok", [(2 ** 31 - 1, True), (2 ** 31, False), (-2 ** 31, True),
                                      (4 * 4096 * 4096 * 32, False)])
def test_kernel_int_arguments_raise_past_int32(value, ok):
    """The kernels' C `int` arguments: ctypes would wrap a larger value
    silently (at frame batch 4, B x H x W x C of Conv_1 at 4096^2 is past
    2^31), so the wrappers raise first."""
    from cell_image_analysis_tpu_torch.ops.cuda._build import c_ints

    if ok:
        c_ints("kernel", n=value)
    else:
        with pytest.raises(ValueError, match="32-bit"):
            c_ints("kernel", n=value, m=1)
