"""PyTorch port: `ProductionMutantScreening`'s plate route (`tiled_route`
/ `score_tiled`) on `virtual_mesh("cpu", 4)`, with the committed store
`assets/screening_store_synthetic`.

- JAX's two route tests (`tests/test_screening_tiled_route.py`) at 384^2:
  the tiled route gives the fused route's cells and rates (and JAX's tiled
  route on a mesh of 4 of its virtual devices gives the same), and a
  `cell_overflow` at 4 cells a tile re-runs at 4x and recovers every cell;
- StarDist with the bundled U-Net at 256^2 on 2 shards: the tiled route
  gives the fused route's cells and rates;
- the two faults of the JAX screener that the port does not copy:
  `screening.py:331`, whose threshold route leaves `label_capacity` at 512
  (the port scales it with the tile: a spy on the tiler at tile scale 4),
  and `:396-409`, whose 4x re-run drops the exact twin's settings that the
  raster re-run chose and never reads `raster_overflow` again (a scripted
  tiler: the port's third call keeps the scatter settings and its flag
  still warns);
- without a mesh the route is never taken; a `device` that is not the
  mesh's first raises;
- `cli screen --mesh 2 --device cpu` gives the run without a mesh.
"""

import contextlib
import io
import os

import numpy as np
import pandas as pd
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch import cli
from cell_image_analysis_tpu_torch.config import ExtractConfig, PipelineConfig, SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
from cell_image_analysis_tpu_torch.io.tiff import imwrite
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.parallel.tiling import TiledCells
from cell_image_analysis_tpu_torch.pipeline import screening
from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset, make_frame

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(_REPO, "assets", "screening_store_synthetic")
RATES = ("conservative", "moderate", "ensemble", "fft")


def _cfg(backend="threshold", tile_min_side=256, max_candidates=1024, **extract_kw):
    return PipelineConfig(seg=SegConfig(backend=backend, max_candidates=max_candidates),
                          extract=ExtractConfig(tile_min_side=tile_min_side, **extract_kw))


def _plate(tmp_path, size=384, n_cells=24, seed=42):
    folder = tmp_path / f"plate{size}"
    folder.mkdir(exist_ok=True)
    imwrite(str(folder / "f0.tif"), make_frame(np.random.default_rng(seed), size=size,
                                               n_cells=n_cells))
    return str(folder)


def _screen(cfg, folder, out, mesh=None, unet=None):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        s = ProductionMutantScreening(STORE, cfg, unet, device=None if mesh else "cpu",
                                      mesh=mesh)
        results, _ = s.screen_mutant_samples({"s": folder}, str(out), figures=False)
    return results["s"], printed.getvalue()


def _assert_same(a, b, min_cells):
    assert a["total_cells"] == b["total_cells"] > min_cells
    for det in RATES:
        assert a[f"{det}_anomaly_rate"] == b[f"{det}_anomaly_rate"], det


def test_tiled_route_matches_fused_and_jax(tmp_path):
    from cell_image_analysis_tpu import config as J
    from cell_image_analysis_tpu.parallel.mesh import make_mesh as jax_mesh
    from cell_image_analysis_tpu.pipeline.screening import (
        ProductionMutantScreening as JaxScreening,
    )

    folder = _plate(tmp_path)
    cfg = _cfg(cell_capacity=32)
    fused, out_f = _screen(cfg, folder, tmp_path / "o1")
    tiled, out_t = _screen(cfg, folder, tmp_path / "o2", mesh=virtual_mesh("cpu", 4))
    assert "overflow" not in out_f + out_t
    _assert_same(tiled, fused, min_cells=5)

    jcfg = J.PipelineConfig(seg=J.SegConfig(backend="threshold"),
                            extract=J.ExtractConfig(tile_min_side=256, cell_capacity=32))
    with contextlib.redirect_stdout(io.StringIO()):
        ref, _ = JaxScreening(STORE, jcfg, mesh=jax_mesh(4)).screen_mutant_samples(
            {"s": folder}, str(tmp_path / "o3"))
    _assert_same(tiled, ref["s"], min_cells=5)


def test_tiled_cell_overflow_rerun_recovers(tmp_path):
    folder = _plate(tmp_path)
    mesh = virtual_mesh("cpu", 4)
    ample, out_a = _screen(_cfg(cell_capacity=32), folder, tmp_path / "o1", mesh=mesh)
    # 4 cells a tile truncate; the 4x re-run (16 a tile) must recover them
    tight, out_t = _screen(_cfg(cell_capacity=4), folder, tmp_path / "o2", mesh=mesh)
    assert "cell_capacity overflow" not in out_a
    assert "cell_capacity overflow -> 4x re-run" in out_t and "WARNING" not in out_t
    _assert_same(tight, ample, min_cells=5)


def test_stardist_tiled_route_matches_fused(tmp_path):
    folder = _plate(tmp_path, size=256, n_cells=12, seed=5)
    cfg = _cfg(backend="stardist", max_candidates=256, cell_capacity=64)
    unet = load_unet_variables()
    fused, _ = _screen(cfg, folder, tmp_path / "o1", unet=unet)
    tiled, printed = _screen(cfg, folder, tmp_path / "o2", mesh=virtual_mesh("cpu", 2),
                             unet=unet)
    assert "WARNING" not in printed
    _assert_same(tiled, fused, min_cells=5)


def _empty_tiles(n_slots: int) -> TiledCells:
    z = torch.zeros(n_slots)
    return TiledCells(cells=torch.zeros(n_slots, 64, 64), valid=z.bool(), area=z.int(),
                      eccentricity=z, mean_intensity=z, std_intensity=z, n_cells=0,
                      raster_overflow=None, cell_overflow=False)


def test_threshold_route_scales_label_capacity_with_the_tile(monkeypatch):
    """JAX's threshold route (`screening.py:331`) passes no label_capacity,
    so it stays 512 while cell_capacity grows with the tile; from tile
    scale 4 up regionprops then truncates and the cell_overflow guard
    cannot fire.  The port scales the label table as the fused route does."""
    calls = []

    def spy(seg, green, mesh, **kw):
        calls.append(kw)
        return _empty_tiles(4)

    monkeypatch.setattr(screening, "tiled_extract_cells", spy)
    s = ProductionMutantScreening(STORE, _cfg(tile_min_side=2048), device="cpu",
                                  mesh=virtual_mesh("cpu", 4))
    plate = np.zeros((2048, 4096), np.float32)
    assert s.tiled_route(plate.shape)
    s.score_tiled(plate, plate)
    (kw,) = calls
    # rows 512 + 2 x 192 halo rows, 4096 wide: 3.5 Mpx, scale 4
    assert kw["halo"] == 192 and kw["cell_capacity"] == 512 * 4
    assert kw["label_capacity"] == 2 * 512 * 4 > kw["cell_capacity"] > 512


def test_stardist_rerun_keeps_the_twin_and_checks_raster_overflow(monkeypatch):
    """JAX's 4x re-run (`screening.py:396-409`) goes back to the primary
    settings and never reads raster_overflow again.  Scripted tiles: a
    segmentation flag, then after the exact-twin re-run a capacity flag,
    then the flag again; the port's third call keeps the twin's settings
    and its flag warns."""
    script = iter([(True, False), (False, True), (True, False)])
    calls = []

    def scripted(seg, green, mesh, unet, seg_cfg=None, **kw):
        calls.append((seg_cfg, kw["cell_capacity"]))
        raster, cell = next(script)
        return _empty_tiles(4)._replace(raster_overflow=raster, cell_overflow=cell)

    monkeypatch.setattr(screening, "tiled_extract_cells_stardist", scripted)
    s = ProductionMutantScreening(STORE, _cfg(backend="stardist"), load_unet_variables(),
                                  device="cpu", mesh=virtual_mesh("cpu", 4))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        s.score_tiled(np.zeros((256, 256), np.float32), np.zeros((256, 256), np.float32))
    out = printed.getvalue()
    modes = [(c.raster_mode, c.nms_max_pairs) for c, _ in calls]
    assert modes == [("tiled", 8192), ("scatter", None), ("scatter", None)]
    assert [cap for _, cap in calls] == [512, 512, 2048]
    assert "exact-twin re-run" in out and "4x re-run" in out
    assert "WARNING: segmentation overflow persists" in out


def test_no_mesh_no_tiles_and_the_home_device(tmp_path):
    s = ProductionMutantScreening(STORE, _cfg(), device="cpu")
    assert not s.tiled_route((4096, 4096))
    mesh = virtual_mesh("cpu", 4)
    s = ProductionMutantScreening(STORE, _cfg(), device="cpu", mesh=mesh)
    assert s.device == mesh.home and s.tiled_route((512, 512))
    assert not s.tiled_route((510, 512)) and not s.tiled_route((128, 512))
    with pytest.raises(ValueError, match="first device"):
        ProductionMutantScreening(STORE, _cfg(), device="cuda:1", mesh=mesh)


def test_cli_screen_mesh_on_the_cpu(tmp_path, capsys):
    folder = str(tmp_path / "a")
    make_dataset(folder, n_frames=3, size=256, n_cells=10, seed=3)
    summaries = []
    for extra in ([], ["--mesh", "2"]):
        out = str(tmp_path / f"out{len(extra)}")
        assert cli.main(["screen", "--models", STORE, "--sample", f"a={folder}", "--backend",
                         "threshold", "--device", "cpu", "--no-figures", "--output", out,
                         *extra]) == 0
        summaries.append(pd.read_csv(os.path.join(out, "screening_summary.csv")))
    assert summaries[0]["total_cells"].iloc[0] > 10
    pd.testing.assert_frame_equal(summaries[0], summaries[1])
