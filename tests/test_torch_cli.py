"""PyTorch port: `python -m cell_image_analysis_tpu_torch.cli screen` and
the two root scripts.

The flags and their defaults against the JAX package's `screen` parser (the
TPU knobs left out, `--device` added); a run on the CPU
through `main([...])` against the JAX CLI on the same folder; the notices of
the bundled-weights fallback; the error paths (a malformed `--sample`, none
at all, no GPU and no `--device cpu`, a model directory that does not
exist); and the root scripts in a subprocess.
"""

import argparse
import os
import subprocess
import sys

import pandas as pd
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch import cli
from cell_image_analysis_tpu_torch.config import OUTPUT_FILES_SCREENING, PipelineConfig
from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(_REPO, "assets", "screening_store_synthetic")
# the TPU knobs, and the training flags (JAX's parser shares them
# between its commands; the port's `train` adds them to its own parser)
_LEFT_OUT = {"unet_winograd", "unet_hilo", "unet_wb16", "epochs", "batch_size",
             "min_cells"}


def _screen_parser(add):
    p = argparse.ArgumentParser()
    add(p)
    return p


def _defaults(parser):
    return {a.dest: (a.default, a.type, tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_equal_the_jax_cli():
    from cell_image_analysis_tpu import cli as jax_cli

    port = _defaults(_screen_parser(cli._add_common))
    ref = _defaults(_screen_parser(jax_cli._add_common))
    assert set(ref) - set(port) == _LEFT_OUT
    assert set(port) - set(ref) == {"device"}
    for dest in set(port) & set(ref):
        assert port[dest] == ref[dest], dest
    assert port["device"][0] is None


def test_overrides_reach_the_config():
    p = _screen_parser(cli.add_screen_arguments)
    args = p.parse_args(["--models", "m", "--sample", "a=b", "--backend", "threshold",
                         "--min-area", "150", "--max-eccentricity", "0.9",
                         "--nu-moderate", "0.2"])
    cfg = cli._apply_overrides(PipelineConfig(), args)
    assert cfg.seg.backend == "threshold" and cfg.qc.min_area == 150
    assert cfg.qc.max_eccentricity == 0.9 and cfg.detector.nu_moderate == 0.2
    assert cfg.qc.max_area == 8000 and cfg.extract == PipelineConfig().extract
    assert cli.parse_samples(p, args) == {"a": "b"}
    assert cli._apply_overrides(PipelineConfig(), p.parse_args(
        ["--models", "m", "--sample", "a=b"])) == PipelineConfig()
    with pytest.raises(SystemExit):   # the training flags belong to `train`
        p.parse_args(["--models", "m", "--sample", "a=b", "--epochs", "3"])


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "mut")
    make_dataset(path, n_frames=2, size=256, n_cells=12, mutant_fraction=0.7, seed=3)
    return path


def test_screen_on_the_cpu_matches_the_jax_cli(folder, tmp_path, capsys):
    from cell_image_analysis_tpu import cli as jax_cli

    out, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["screen", "--models", STORE, "--sample", f"mutantA={folder}", "--backend", "threshold"]
    assert cli.main([*argv, "--output", out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "=== SCREENING COMPLETED ===" in printed and f"Results saved to: {out}" in printed
    assert "QUICK SUMMARY:" in printed and "mutantA" in printed.split("QUICK SUMMARY:")[1]
    assert jax_cli.main([*argv, "--output", out_j]) == 0
    printed_j = capsys.readouterr().out
    assert printed.split("QUICK SUMMARY:")[1] == printed_j.split("QUICK SUMMARY:")[1]
    for name in OUTPUT_FILES_SCREENING:
        if name != "correlation_matrix.png":   # only with more than one sample
            assert os.path.exists(os.path.join(out, name)), name
    a = pd.read_csv(os.path.join(out, "screening_summary.csv"), index_col=0)
    b = pd.read_csv(os.path.join(out_j, "screening_summary.csv"), index_col=0)
    pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=0, atol=1e-4)
    assert a.loc["mutantA", "total_cells"] >= 5


def test_bundled_weights_notices(tmp_path, capsys, monkeypatch):
    from cell_image_analysis_tpu_torch.io import artifacts

    p = _screen_parser(cli.add_screen_arguments)
    args = p.parse_args(["--models", "m", "--sample", "a=b"])
    unet = cli.load_unet(args)
    assert f"--backend stardist without --unet-weights: using {artifacts.UNET_WEIGHTS_PATH}" \
        in capsys.readouterr().out
    assert sorted(unet["params"])[0] == "Conv_0" and len(unet["params"]) == 15
    explicit = cli.load_unet(p.parse_args(["--models", "m", "--sample", "a=b", "--unet-weights",
                                           artifacts.UNET_WEIGHTS_PATH]))
    assert capsys.readouterr().out == "" and explicit.keys() == unet.keys()
    assert cli.load_unet(p.parse_args(["--models", "m", "--sample", "a=b", "--backend",
                                       "threshold"])) is None
    monkeypatch.setattr(artifacts, "UNET_WEIGHTS_PATH", str(tmp_path / "missing.pkl"))
    assert cli.load_unet(args) is None
    assert "no bundled weights found: falling back to the threshold backend" \
        in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["screen", "--models", STORE, "--sample", "no_equals_sign", "--device", "cpu"],
     "--sample must be NAME=FOLDER"),
    (["screen", "--models", STORE, "--device", "cpu"], "at least one --sample"),
    (["screen", "--sample", "a=b"], "--models"),
    (["bench", "--backend", "unet"], "invalid choice"),
])
def test_argument_errors_exit_2(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")


def test_no_gpu_and_no_device_flag_is_an_error(no_gpu, folder, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["screen", "--models", STORE, "--sample", f"a={folder}", "--output",
                  str(tmp_path / "out")])
    assert e.value.code not in (0, None)
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert not os.path.exists(tmp_path / "out")


def test_missing_model_directory_fails(folder, tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["screen", "--models", str(tmp_path / "nowhere"), "--sample", f"a={folder}",
                  "--device", "cpu", "--output", str(tmp_path / "out")])


def _run_script(name, *argv):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, os.path.join(_REPO, name), *argv], cwd=_REPO,
                          capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("script,banner", [
    ("improved_detection_torch.py", "=== SCREENING COMPLETED ==="),
    ("improved_detection_v2_torch.py", "=== ENSEMBLE SCREENING COMPLETED ==="),
])
def test_root_scripts_screen_on_the_cpu(script, banner, folder, tmp_path):
    out = str(tmp_path / "out")
    done = _run_script(script, "--models", STORE, "--sample", f"mutantA={folder}", "--output",
                       out, "--device", "cpu", "--backend", "threshold")
    assert done.returncode == 0, done.stderr[-2000:]
    assert banner in done.stdout and "mutantA" in done.stdout.split(banner)[1]
    if "v2" in script:
        assert "Ensemble" in done.stdout.split(banner)[1]
    assert os.path.exists(os.path.join(out, "screening_summary.csv"))


@pytest.mark.parametrize("script", ["improved_detection_torch.py",
                                    "improved_detection_v2_torch.py"])
def test_root_scripts_need_a_gpu_or_the_device_flag(no_gpu, script, folder, tmp_path):
    done = _run_script(script, "--models", STORE, "--sample", f"mutantA={folder}", "--output",
                       str(tmp_path / "out"))
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr and "--device cpu" in done.stderr


def test_no_figures_leaves_out_only_the_figures(folder, tmp_path, capsys):
    out = str(tmp_path / "out")
    assert cli.main(["screen", "--models", STORE, "--sample", f"mutantA={folder}", "--backend",
                     "threshold", "--device", "cpu", "--no-figures", "--output", out]) == 0
    assert "Figures not written" in capsys.readouterr().out
    for name in OUTPUT_FILES_SCREENING:
        assert os.path.exists(os.path.join(out, name)) == (not name.endswith(".png")), name


def test_without_matplotlib_the_screener_raises_from_the_figures(folder, tmp_path, monkeypatch):
    """The figures are not skipped silently: without matplotlib the call that
    writes them raises (after the CSVs), unless the caller gave them up."""
    from cell_image_analysis_tpu_torch.pipeline import reports

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "out")
    with pytest.raises(ModuleNotFoundError):
        cli.main(["screen", "--models", STORE, "--sample", f"mutantA={folder}", "--backend",
                  "threshold", "--device", "cpu", "--output", out])
    assert os.path.exists(os.path.join(out, "screening_summary.csv"))
    assert not os.path.exists(os.path.join(out, "mutant_screening_report.txt"))
    with pytest.raises(ModuleNotFoundError):
        reports.create_screening_visualizations(str(tmp_path), {}, [])
