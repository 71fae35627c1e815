"""PyTorch port: `ProductionMutantScreening` on the CPU against the JAX
screener (no mesh) on the same TIFF folders and the same model directory
(`assets/screening_store_synthetic`, written by the JAX package).

Threshold backend, 384^2 frames, 3 + 3 frames, plus a folder whose last
frame has another shape, an empty folder, a folder of blank frames and one
with a corrupt file: the same per-file cell counts and `total_cells`, equal
rates, per-cell scores within 1e-4, predictions equal except within 1e-4 of
a threshold, the schema and failure-path checks of the JAX package's
end-to-end test, the two CSVs equal under `pandas.read_csv`, and the text
report equal but for its date.  StarDist with the bundled U-Net, 256^2
frames, at capacities cut for the CPU: the same checks on counts, rates and
per-cell scores.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pandas as pd
import pytest

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.config import (
    OUTPUT_FILES_SCREENING,
    ExtractConfig,
    PipelineConfig,
    SegConfig,
    capacity_scale,
)
from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(_REPO, "assets", "screening_store_synthetic")
TOL = 1e-4
_RATES = ("conservative_anomaly_rate", "moderate_anomaly_rate", "ensemble_anomaly_rate",
          "fft_anomaly_rate")


def _jax_config(cfg: PipelineConfig):
    """The JAX package's PipelineConfig with the port config's values."""
    from cell_image_analysis_tpu import config as J

    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(J, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return J.PipelineConfig(**kw)


def _run_both(cfg, unet, samples, root):
    """Both screeners on `samples`; returns {side: (results, detailed, out
    dir, printed, screener)}."""
    from cell_image_analysis_tpu.pipeline.screening import (
        ProductionMutantScreening as JaxScreening,
    )
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    def run(side, make):
        out, printed = str(root / f"out_{side}"), io.StringIO()
        with contextlib.redirect_stdout(printed):
            screener = make()
            res, det = screener.screen_mutant_samples(samples, out)
        return res, det, out, printed.getvalue(), screener

    return {
        "port": run("port", lambda: ProductionMutantScreening(STORE, cfg, unet, device="cpu")),
        "jax": run("jax", lambda: JaxScreening(
            STORE, _jax_config(cfg),
            load_synthetic_unet_variables() if unet is not None else None)),
    }


def _per_file_counts(printed: str) -> list:
    return [line.strip() for line in printed.splitlines()
            if line.strip().endswith(" cells") and ".tif: " in line]


@pytest.fixture(scope="module")
def threshold_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("screen_thr")
    d = {n: str(root / n) for n in ("wt", "mut", "shapes", "empty", "blank", "mixed")}
    make_dataset(d["wt"], n_frames=3, size=384, n_cells=22, seed=2)
    make_dataset(d["mut"], n_frames=3, size=384, n_cells=22, mutant_fraction=0.7, seed=3)
    # a frame whose shape differs inside a folder: the batch flushes on it
    make_dataset(d["shapes"], n_frames=3, size=384, n_cells=22, seed=6)
    small = make_dataset(str(root / "small"), n_frames=1, size=256, n_cells=10, seed=7)[0]
    os.replace(small, os.path.join(d["shapes"], "frame_003.tif"))
    os.makedirs(d["empty"])
    make_dataset(d["blank"], n_frames=3, size=384, n_cells=0, seed=4)
    make_dataset(d["mixed"], n_frames=3, size=384, n_cells=22, seed=5)
    with open(os.path.join(d["mixed"], "corrupt.tif"), "wb") as f:
        f.write(b"not a tiff at all")
    samples = {"wildtype": d["wt"], "mutantA": d["mut"], "shapes": d["shapes"],
               "empty": d["empty"], "blank": d["blank"], "mixed": d["mixed"]}
    cfg = PipelineConfig(seg=SegConfig(backend="threshold"))
    return _run_both(cfg, None, samples, root), samples


def _assert_results_equal(port, ref, n_near=0):
    assert list(port) == list(ref)
    for name in port:
        a, b = port[name], ref[name]
        assert list(a) == list(b)
        for k in ("sample_name", "total_cells", "files_processed"):
            assert a[k] == b[k], (name, k)
        for k in _RATES:
            assert abs(a[k] - b[k]) <= n_near / a["total_cells"], (name, k)
        for k in ("mean_mse", "std_mse", "mean_mae", "std_mae"):
            assert abs(a[k] - b[k]) <= TOL, (name, k)


def _assert_detailed_equal(port, ref) -> int:
    """Per-cell rows equal: scores within TOL, flags equal except where the
    score lies within TOL of its threshold (0).  Returns how many such."""
    assert len(port) == len(ref)
    near = 0
    for a, b in zip(port, ref):
        assert list(a) == list(b)
        assert (a["sample_name"], a["cell_id"]) == (b["sample_name"], b["cell_id"])
        for k in ("mse", "mae", "conservative_score", "moderate_score"):
            assert abs(a[k] - b[k]) <= TOL, (a["sample_name"], a["cell_id"], k)
        for flag, score in (("conservative_anomaly", "conservative_score"),
                            ("moderate_anomaly", "moderate_score")):
            if a[flag] != b[flag]:
                assert abs(b[score]) <= TOL, (a["sample_name"], a["cell_id"], flag)
                near += 1
        # the ensemble and FFT flags hang on thresholds the rows do not hold
        near += (a["ensemble_anomaly"] != b["ensemble_anomaly"])
        near += (a["fft_anomaly"] != b["fft_anomaly"])
    return near


def test_threshold_screener_matches_jax(threshold_runs):
    runs, _ = threshold_runs
    (res, det, _, printed, _), (res_j, det_j, _, printed_j, _) = runs["port"], runs["jax"]
    assert set(res) == {"wildtype", "mutantA", "shapes", "mixed"}
    near = _assert_detailed_equal(det, det_j)
    assert near <= 2
    _assert_results_equal(res, res_j, n_near=near)
    counts = _per_file_counts(printed)
    assert counts == _per_file_counts(printed_j)
    assert len(counts) == 3 + 3 + 4 + 3   # a sample without cells prints no per-file line
    assert res["wildtype"]["total_cells"] > 20 and res["mutantA"]["total_cells"] > 20
    assert res["shapes"]["files_processed"] == 4
    assert any(c.startswith("frame_003.tif: ") and not c.startswith("frame_003.tif: 0 ")
               for c in counts)
    # the store is fitted on extracted cells (of 1024^2 frames): normal cells
    # and anomalies both occur, so the compared predictions have both signs
    assert 0.0 < res["wildtype"]["conservative_anomaly_rate"] < 1.0
    assert res["mutantA"]["moderate_anomaly_rate"] > res["wildtype"]["moderate_anomaly_rate"]
    assert (res["mutantA"]["conservative_anomaly_rate"]
            > res["wildtype"]["conservative_anomaly_rate"])


def test_threshold_screener_failure_paths(threshold_runs):
    runs, samples = threshold_runs
    for side in ("port", "jax"):
        printed = runs[side][3]
        assert f"No .tif files found in {samples['empty']}" in printed
        assert "No quality cells extracted from blank" in printed
        assert "Error processing" in printed and "corrupt.tif" in printed
        assert "Total mixed cells: " in printed
    err = [line for line in runs["port"][3].splitlines() if line.startswith("Error processing")]
    assert err == [line for line in runs["jax"][3].splitlines()
                   if line.startswith("Error processing")]
    assert runs["port"][0]["mixed"]["total_cells"] > 5
    assert runs["port"][0]["mixed"]["files_processed"] == 4   # the corrupt file is counted


def test_threshold_screener_files_and_schema(threshold_runs):
    runs, _ = threshold_runs
    out, out_j = runs["port"][2], runs["jax"][2]
    for name in OUTPUT_FILES_SCREENING:
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    summary = pd.read_csv(os.path.join(out, "screening_summary.csv"), index_col=0)
    assert {"sample_name", "total_cells", "files_processed", "conservative_anomaly_rate",
            "moderate_anomaly_rate", "mean_mse", "std_mse", "mean_mae",
            "std_mae"} <= set(summary.columns)
    detailed = pd.read_csv(os.path.join(out, "detailed_cell_results.csv"))
    assert {"sample_name", "cell_id", "mse", "mae", "conservative_anomaly", "moderate_anomaly",
            "conservative_score", "moderate_score"} <= set(detailed.columns)
    assert detailed["conservative_anomaly"].dtype == bool
    with open(os.path.join(out, "run_parameters.json")) as f:
        snap = json.load(f)
    env = snap["environment"]
    assert "argv" in env and "python" in env and "torch" in env and "jax" not in env
    assert snap["qc"]["min_area"] == 200 and "samples" in snap["run"]
    with open(os.path.join(out_j, "run_parameters.json")) as f:
        snap_j = json.load(f)
    assert snap["sharding"] == snap_j["sharding"]      # the config's, field for field
    # column for column, the JAX package's files
    for name, kw in (("screening_summary.csv", dict(index_col=0)),
                     ("detailed_cell_results.csv", {})):
        a = pd.read_csv(os.path.join(out, name), **kw)
        b = pd.read_csv(os.path.join(out_j, name), **kw)
        assert list(a.columns) == list(b.columns) and list(a.index) == list(b.index)
        assert list(a.dtypes) == list(b.dtypes), name
        pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=0, atol=TOL)


def test_csv_text_is_what_pandas_writes(threshold_runs, tmp_path):
    """The port's writer against pandas on the port's own results: the same
    bytes, so `read_csv` cannot tell them apart."""
    res, det, out = threshold_runs[0]["port"][:3]
    pd.DataFrame.from_dict(res, orient="index").to_csv(tmp_path / "summary.csv")
    pd.DataFrame(det).to_csv(tmp_path / "detailed.csv", index=False)
    for ours, theirs in (("screening_summary.csv", "summary.csv"),
                         ("detailed_cell_results.csv", "detailed.csv")):
        with open(os.path.join(out, ours)) as f, open(tmp_path / theirs) as g:
            assert f.read() == g.read(), ours


def test_text_report_equals_jax_but_for_the_date(threshold_runs):
    runs, _ = threshold_runs

    def lines(side):
        with open(os.path.join(runs[side][2], "mutant_screening_report.txt")) as f:
            return [line for line in f.read().splitlines() if not line.startswith("Generated:")]

    port, ref = lines("port"), lines("jax")
    assert len(port) == len(ref) > 20
    for a, b in zip(port, ref):
        if a != b:   # a number may differ in its last printed digit
            assert a.split()[:2] == b.split()[:2], (a, b)
    assert sum(a != b for a, b in zip(port, ref)) <= 2
    assert any(line.startswith("ENSEMBLE") for line in port)


def test_in_flight_batches_and_meters(threshold_runs):
    screener = threshold_runs[0]["port"][4]
    # 6 fused batches had cells (wildtype, mutantA, shapes x2, mixed; blank's
    # batch too): each is one start and one wait
    assert screener.timer.counts["score_frames"] == 2 * 6
    assert screener.meter.items == sum(r["total_cells"] for r in threshold_runs[0]["port"][0]
                                       .values())
    assert screener.meter.rate > 0 and screener.decode_seconds > 0
    assert "score_frames" in screener.timer.report()


def test_extract_quality_cells_and_scores_match_jax(threshold_runs):
    """The screener's slow path on one frame: `extract_quality_cells` then
    `compute_anomaly_scores`, both sides."""
    from cell_image_analysis_tpu_torch.io.ingest import list_tiffs, split_channels
    from cell_image_analysis_tpu_torch.io.tiff import imread

    runs, samples = threshold_runs
    seg, green = split_channels(imread(list_tiffs(samples["wildtype"])[0]))
    cells, stats = runs["port"][4].extract_quality_cells(seg, green)
    cells_j, stats_j = runs["jax"][4].extract_quality_cells(seg, green)
    assert cells.shape == cells_j.shape and len(cells) >= 10 and cells.dtype == np.float32
    np.testing.assert_allclose(cells, cells_j, rtol=0, atol=1e-5)
    assert [s["area"] for s in stats] == [s["area"] for s in stats_j]
    for k in ("eccentricity", "mean_intensity", "std_intensity"):
        np.testing.assert_allclose([s[k] for s in stats], [s[k] for s in stats_j],
                                   rtol=1e-5, atol=1e-4)
    got = runs["port"][4].compute_anomaly_scores(cells)
    ref = runs["jax"][4].compute_anomaly_scores(cells_j)
    assert got.keys() == ref.keys()
    for k in ("reconstruction_mse", "reconstruction_mae", "conservative_scores",
              "moderate_scores"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL, err_msg=k)
    for k, score in (("conservative", "conservative_scores"), ("moderate", "moderate_scores")):
        far = np.abs(ref[score]) > TOL
        np.testing.assert_array_equal(got[f"{k}_predictions"][far],
                                      ref[f"{k}_predictions"][far])
    assert runs["port"][4].compute_anomaly_scores(cells[:0]) == {}


def test_stardist_screener_matches_jax(tmp_path):
    wt, mut = str(tmp_path / "wt"), str(tmp_path / "mut")
    make_dataset(wt, n_frames=2, size=256, n_cells=14, seed=5)
    make_dataset(mut, n_frames=2, size=256, n_cells=14, mutant_fraction=0.7, seed=6)
    # capacities cut for the CPU; the exact pair set, so that the dense small
    # frames do not send both sides through their fallbacks
    cfg = PipelineConfig(seg=SegConfig(max_candidates=256, nms_max_pairs=256 ** 2),
                         extract=ExtractConfig(cell_capacity=64))
    runs = _run_both(cfg, load_unet_variables(), {"wildtype": wt, "mutantA": mut}, tmp_path)
    (res, det, out, printed, screener), (res_j, det_j, _, printed_j, _) = (runs["port"],
                                                                           runs["jax"])
    assert set(res) == {"wildtype", "mutantA"}
    assert screener._segment.cfg.raster_cap == 64 and screener._segment.runs_props
    assert _per_file_counts(printed) == _per_file_counts(printed_j)
    near = _assert_detailed_equal(det, det_j)
    assert near <= 2
    _assert_results_equal(res, res_j, n_near=near)
    assert res["wildtype"]["total_cells"] >= 10
    for name in OUTPUT_FILES_SCREENING:
        assert os.path.exists(os.path.join(out, name)), name


def test_capacities_scale_with_the_frame_area():
    screener = ProductionMutantScreening(STORE, PipelineConfig(), load_unet_variables(),
                                         device="cpu")
    assert [capacity_scale(h, w) for h, w in ((512, 512), (1024, 1024), (1025, 1024),
                                                       (2048, 2048), (4096, 4096))] \
        == [1, 1, 2, 4, 16]
    fn, kw = screener.fused_arguments(1024, 1024)
    assert fn is screener._segment and kw["fallback_segment_fn"] is screener._segment_fallback
    assert (fn.cfg.max_candidates, fn.cfg.raster_cap, fn.cfg.nms_max_pairs) == (1024, 512, 8192)
    assert (kw["cell_capacity"], kw["label_capacity"], kw["rcap"], kw["chunk"]) == (512, 1024,
                                                                                     32, 32)
    twin = kw["fallback_segment_fn"]
    assert (twin.cfg.raster_mode, twin.cfg.nms_max_pairs, twin.runs_props) == (
        "scatter", None, False)   # None: every candidate pair
    fn4, kw4 = screener.fused_arguments(2048, 2048)
    assert fn4 is screener.fused_arguments(2048, 2048)[0] is not fn   # kept by shape
    assert fn4.model is fn.model                                      # one U-Net
    assert (fn4.cfg.max_candidates, fn4.cfg.raster_cap, fn4.cfg.nms_max_pairs) == (
        4096, 2048, 32768)
    assert (kw4["cell_capacity"], kw4["label_capacity"], kw4["rcap"]) == (2048, 4096, 64)
    assert kw4["fallback_segment_fn"].cfg.nms_max_pairs is None
    thr = ProductionMutantScreening(STORE, PipelineConfig(seg=SegConfig(backend="threshold")),
                                    device="cpu")
    fn_t, kw_t = thr.fused_arguments(2048, 2048)
    assert fn_t.runs_props and not kw_t["fallback_segment_fn"].runs_props
    assert abs(kw_t["fg_fraction"] - 0.12) < 1e-12 and kw_t["cell_capacity"] == 2048
    # no U-Net: the threshold backend runs, at the StarDist fg_fraction
    none = ProductionMutantScreening(STORE, PipelineConfig(), device="cpu")
    assert isinstance(none._segment, ThresholdBackend)
    assert none.fused_arguments(64, 64)[1]["fg_fraction"] == 0.25
