"""PyTorch port: the training entry point end to end on the CPU.

- `ImprovedAnomalyDetectionTraining(..., device="cpu")` on a small
  `make_dataset` folder (threshold backend, 4 frames of 256^2 and a
  corrupt file, `min_cells` 10, 2 epochs, `figures=False`) writes every
  file of the contract but the figures, and `run_parameters.json`.
- The port's screener loads that store and screens a folder.
- `cell_statistics.csv` and `file_summary.csv` are byte-equal to the JAX
  package's pandas writers on the same rows, and the two text reports
  equal but for their `Generated:` line: on the trainer's own rows, and on
  rows that exercise pandas' upcasting (an int 0 among floats, all ints),
  one row (a NaN std) and no row.
- Below `min_cells` `run` returns False and `cli train` exits 1; `cli
  train --device cpu` trains; without a GPU and without `--device cpu` it
  exits 2; the root script passes its arguments through; `train`'s flags
  and defaults are the JAX parser's but for the TPU knobs,
  plus `--device` and `--no-figures`.
"""

import argparse
import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch import cli
from cell_image_analysis_tpu_torch.config import (
    OUTPUT_FILES_TRAINING,
    PipelineConfig,
    SegConfig,
    TrainConfig,
)
from cell_image_analysis_tpu_torch.pipeline import reports
from cell_image_analysis_tpu_torch.pipeline.training import ImprovedAnomalyDetectionTraining
from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_FILES = ("best_autoencoder.keras", "final_autoencoder.keras", "encoder.keras",
               "scaler.pkl", "pca.pkl", "detector_conservative.pkl", "detector_moderate.pkl",
               "ensemble.json", "fft_scaler.pkl", "detector_fft.pkl")
_CFG = dataclasses.replace(PipelineConfig(), seg=SegConfig(backend="threshold"),
                           train=TrainConfig(epochs=2, min_cells=10, batch_size=16))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    folder = str(root / "train")
    make_dataset(folder, n_frames=4, size=256, n_cells=12, seed=1)
    with open(os.path.join(folder, "zz_corrupt.tif"), "wb") as f:
        f.write(b"not a tiff")
    out = str(root / "model")
    printed = io.StringIO()
    trainer = ImprovedAnomalyDetectionTraining(out, _CFG, device="cpu")
    real = trainer.create_training_dataset
    rows = {}

    def keep(folder_path):
        cells, stats = real(folder_path)
        rows["stats"], rows["cells"] = stats, cells
        return cells, stats

    trainer.create_training_dataset = keep
    with contextlib.redirect_stdout(printed):
        ok = trainer.run(folder, figures=False)
    return dict(ok=ok, out=out, root=root, folder=folder, printed=printed.getvalue(),
                trainer=trainer, **rows)


def test_training_writes_the_contract(trained):
    assert trained["ok"]
    names = set(os.listdir(trained["out"]))
    for name in STORE_FILES + ("run_parameters.json",):
        assert name in names, name
    for name in OUTPUT_FILES_TRAINING:
        assert (name in names) == (not name.endswith(".png")), name
    assert "Error processing" in trained["printed"] and "zz_corrupt.tif" in trained["printed"]
    assert "TRAINING COMPLETED" in trained["printed"]
    assert len(trained["cells"]) >= 10 and trained["cells"].shape[1:] == (64, 64)
    with open(os.path.join(trained["out"], "file_summary.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "filename,cells_extracted,mean_cell_intensity" and len(lines) == 6
    assert lines[-1] == "zz_corrupt.tif,0,0.0"      # an int 0 among floats: pandas' upcast
    timer = trained["trainer"].timer.summary()
    assert {"extract_batch", "solidity", "train_cae", "recon_eval", "detector_fit"} <= set(timer)


def test_the_ports_screener_reads_the_trained_store(trained):
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening

    folder = str(trained["root"] / "screen_in")
    make_dataset(folder, n_frames=2, size=256, n_cells=12, mutant_fraction=0.5, seed=9)
    with contextlib.redirect_stdout(io.StringIO()):
        screener = ProductionMutantScreening(trained["out"], _CFG, device="cpu")
        results, detailed = screener.screen_mutant_samples(
            {"s": folder}, str(trained["root"] / "screen_out"), figures=False)
    assert results["s"]["total_cells"] > 5 and len(detailed) == results["s"]["total_cells"]
    assert np.all(np.isfinite([d["conservative_score"] for d in detailed]))


def _without_generated(path):
    with open(path) as f:
        return [line for line in f.read().splitlines() if not line.startswith("Generated:")]


def _jax_and_port(tmp_path, stats, summary, history=None, mse=None, mae=None):
    import pandas as pd

    from cell_image_analysis_tpu.pipeline import reports as jax_reports

    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    ref.mkdir()
    reports.write_dataset_csvs(str(port), stats, summary)
    jax_reports.write_dataset_csvs(str(ref), pd.DataFrame(stats), pd.DataFrame(summary))
    names = ["cell_statistics.csv", "file_summary.csv"]
    if stats:
        reports.generate_data_quality_report(str(port), stats, summary)
        jax_reports.generate_data_quality_report(str(ref), pd.DataFrame(stats),
                                                 pd.DataFrame(summary))
        names.append("data_quality_report.txt")
    if history is not None:
        reports.generate_final_report(str(port), stats, history, mse, mae)
        jax_reports.generate_final_report(str(ref), pd.DataFrame(stats), history, mse, mae)
        names.append("training_report.txt")
    for name in names:
        if name.endswith(".csv"):
            assert (port / name).read_bytes() == (ref / name).read_bytes(), name
        else:
            assert _without_generated(port / name) == _without_generated(ref / name), name


def _summary_rows(stats, extra):
    files = sorted({s["file"] for s in stats})
    rows = [dict(filename=f, cells_extracted=sum(s["file"] == f for s in stats),
                 mean_cell_intensity=float(np.mean([s["mean_intensity"] for s in stats
                                                    if s["file"] == f]))) for f in files]
    return rows + extra


def test_reports_equal_the_jax_writers_on_the_trainers_rows(trained, tmp_path):
    stats = trained["stats"]
    summary = _summary_rows(stats, [dict(filename="bad.tif", cells_extracted=0,
                                         mean_cell_intensity=0)])
    rng = np.random.default_rng(0)
    history = {"loss": [0.2, 0.1], "mae": [0.3, 0.2], "val_loss": [0.25, 0.15],
               "val_mae": [0.35, 0.25], "lr": [1e-3, 1e-3]}
    _jax_and_port(tmp_path, stats, summary, history, rng.gamma(2, 0.01, 50).astype(np.float32),
                  rng.gamma(2, 0.05, 50).astype(np.float32))
    with open(os.path.join(trained["out"], "cell_statistics.csv")) as f:
        assert len(f.read().splitlines()) == len(stats) + 1


def _stat(i, file):
    return dict(area=200 + 37 * i, eccentricity=0.1 + 0.07 * i, solidity=0.9 - 0.01 * i,
                mean_intensity=100.5 + i / 3, std_intensity=12.25 + i / 7, file=file)


@pytest.mark.parametrize("case", ["upcast", "all_ints", "one_row", "no_row"])
def test_reports_equal_the_jax_writers_on_edge_rows(case, tmp_path):
    if case == "no_row":
        stats, summary = [], [dict(filename="a.tif", cells_extracted=0, mean_cell_intensity=0)]
    elif case == "one_row":
        stats = [_stat(0, "a.tif")]
        summary = _summary_rows(stats, [])
    elif case == "all_ints":
        stats = [_stat(i, "a.tif") for i in range(3)]
        summary = [dict(filename=f, cells_extracted=0, mean_cell_intensity=0)
                   for f in ("a.tif", "b.tif")]
    else:
        stats = [_stat(i, f) for i, f in enumerate(["a.tif", "a.tif", "b,c.tif"])]
        summary = _summary_rows(stats, [dict(filename="d.tif", cells_extracted=0,
                                             mean_cell_intensity=0)])
    history = {"loss": [0.5], "mae": [0.4], "val_loss": [0.45], "val_mae": [0.41],
               "lr": [1e-3]} if stats else None
    mse = np.array([0.01, 0.02, 0.05], np.float32)
    _jax_and_port(tmp_path, stats, summary, history, mse, mse * 2)


def test_below_min_cells_run_returns_false_and_cli_exits_1(trained, tmp_path):
    cfg = dataclasses.replace(_CFG, train=TrainConfig(epochs=1, min_cells=10_000,
                                                      batch_size=16))
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        ok = ImprovedAnomalyDetectionTraining(str(tmp_path / "m"), cfg, device="cpu").run(
            trained["folder"], figures=False)
    assert ok is False and "Recommend >10000" in printed.getvalue()
    assert not os.path.exists(tmp_path / "m" / "scaler.pkl")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["train", trained["folder"], "--output", str(tmp_path / "c"),
                       "--backend", "threshold", "--device", "cpu", "--min-cells", "10000",
                       "--no-figures"])
    assert rc == 1


def test_cli_train_on_the_cpu(trained, tmp_path):
    out = str(tmp_path / "cli_model")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = cli.main(["train", trained["folder"], "--output", out, "--backend", "threshold",
                       "--device", "cpu", "--epochs", "1", "--batch-size", "16",
                       "--min-cells", "10", "--no-figures"])
    assert rc == 0, printed.getvalue()[-2000:]
    assert set(STORE_FILES) <= set(os.listdir(out))
    assert "Epoch 1/1" in printed.getvalue() and "Epoch 2/" not in printed.getvalue()


def test_cli_train_without_a_gpu_exits_with_an_error(trained, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["train", trained["folder"], "--output", str(tmp_path / "x"),
                  "--backend", "threshold"])
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImprovedAnomalyDetectionTraining("unused_dir_never_made", _CFG)


def test_root_script_passes_its_arguments_through(monkeypatch):
    sys.path.insert(0, _REPO)
    import CAE_improved_modeltrain_torch as script

    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or 0)
    monkeypatch.setattr(sys, "argv", ["CAE_improved_modeltrain_torch.py", "/data", "--epochs",
                                      "3", "--device", "cpu"])
    assert script.main() == 0
    monkeypatch.setattr(sys, "argv", ["CAE_improved_modeltrain_torch.py"])
    assert script.main() == 0
    assert seen[0] == ["train", "/data", "--epochs", "3", "--device", "cpu"]
    assert seen[1][:2] == ["train", "/path/to/your/training/images/"] and seen[1][2] == "--output"


def _dests(add):
    p = argparse.ArgumentParser()
    add(p)
    return {a.dest: (a.default, a.type, tuple(a.choices) if a.choices else None)
            for a in p._actions if a.dest != "help"}


def test_train_flags_equal_the_jax_train_parser():
    from cell_image_analysis_tpu import cli as jax_cli

    def jax_train(p):
        p.add_argument("input_folder")
        p.add_argument("--output", default=None)
        jax_cli._add_common(p)

    port, ref = _dests(cli.add_train_arguments), _dests(jax_train)
    assert set(ref) - set(port) == {"unet_winograd", "unet_hilo", "unet_wb16"}
    assert set(port) - set(ref) == {"device", "no_figures"}
    for dest in set(port) & set(ref):
        assert port[dest] == ref[dest], dest
    args = argparse.ArgumentParser()
    cli.add_train_arguments(args)
    cfg = cli._apply_overrides(PipelineConfig(), args.parse_args(
        ["f", "--epochs", "7", "--batch-size", "16", "--min-cells", "42"]))
    assert (cfg.train.epochs, cfg.train.batch_size, cfg.train.min_cells) == (7, 16, 42)
