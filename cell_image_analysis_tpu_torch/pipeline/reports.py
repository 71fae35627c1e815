"""Report writers: the output-file contract of training and screening.

Counterpart of `cell_image_analysis_tpu/pipeline/reports.py`:
`run_parameters.json`; for training `cell_statistics.csv`,
`file_summary.csv`, `data_quality_report.txt`, `training_report.txt` and
the figures `training_history.png`, `reconstruction_error_distribution.png`
and `reconstruction_samples.png`; for screening `screening_summary.csv`,
`detailed_cell_results.csv`, the figures `anomaly_rates_comparison.png`,
`mse_distributions.png` and `correlation_matrix.png`, and
`mutant_screening_report.txt`.

The CSVs and the text reports are written with the standard library and
numpy from lists of row dicts, in the columns, order and number formatting
of the JAX package's pandas writers: a column that mixes floats and ints
is written as floats, as pandas upcasts it, and the reports' `±` figures
are pandas' `.std()`, ddof 1.  Only the figures need matplotlib, which is
imported inside each figure's function: without it that call raises.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from datetime import datetime

import numpy as np

from cell_image_analysis_tpu_torch.config import PipelineConfig, TriageConfig


def _now() -> str:
    return datetime.now().strftime("%Y-%m-%d %H:%M:%S")


def save_run_parameters(output_dir: str, config: PipelineConfig, extra: dict | None = None) -> None:
    """Reproducibility snapshot: the resolved config, the invocation and
    the environment (versions, device)."""
    import platform
    import sys

    import torch

    payload = dataclasses.asdict(config)
    if extra:
        payload["run"] = extra
    env: dict = {
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "timestamp": _now(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        env["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        env["devices"] = ["cpu"]
    payload["environment"] = env
    with open(os.path.join(output_dir, "run_parameters.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)


# ---------------------------------------------------------------- training --

def _write_rows(path: str, rows: list, cols: list | None = None) -> None:
    """A CSV of row dicts without an index, as `DataFrame(rows).to_csv(
    index=False)` writes it: a column holding any float is a float column,
    its ints written as floats."""
    cols = cols if cols is not None else (list(rows[0]) if rows else [])
    floats = {c for c in cols if any(isinstance(r[c], (float, np.floating)) for r in rows)}
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([repr(float(r[c])) if c in floats else _cell(r[c]) for c in cols])


def write_dataset_csvs(output_dir: str, stats: list, file_summary: list) -> None:
    """cell_statistics.csv (one row a cell) and file_summary.csv (one row a
    file) from lists of row dicts."""
    _write_rows(os.path.join(output_dir, "cell_statistics.csv"), stats)
    _write_rows(os.path.join(output_dir, "file_summary.csv"), file_summary)


def _column(rows: list, key: str) -> np.ndarray:
    return np.array([r[key] for r in rows], dtype=np.float64)


def _mean_std(rows: list, key: str) -> tuple:
    """pandas' `.mean()` and `.std()` (ddof 1; NaN for one row)."""
    v = _column(rows, key)
    with np.errstate(invalid="ignore", divide="ignore"):
        std = float(np.sqrt(np.sum((v.mean() - v) ** 2) / (len(v) - 1))) if len(v) > 1 \
            else float("nan")
    return float(v.mean()), std


def generate_data_quality_report(output_dir: str, stats: list, file_summary: list) -> None:
    """data_quality_report.txt from the rows of the two CSVs."""
    with open(os.path.join(output_dir, "data_quality_report.txt"), "w") as f:
        f.write("=== TRAINING DATA QUALITY REPORT ===\n\n")
        f.write(f"Generated: {_now()}\n\n")
        f.write("OVERALL STATISTICS:\n")
        f.write(f"Total files processed: {len(file_summary)}\n")
        f.write(f"Total cells extracted: {len(stats)}\n")
        denom = max(len(file_summary), 1)
        f.write(f"Average cells per file: {len(stats) / denom:.1f}\n\n")
        f.write("CELL MORPHOLOGY STATISTICS:\n")
        m, sd = _mean_std(stats, "area")
        f.write(f"Area: {m:.1f} ± {sd:.1f}\n")
        m, sd = _mean_std(stats, "eccentricity")
        f.write(f"Eccentricity: {m:.3f} ± {sd:.3f}\n")
        m, sd = _mean_std(stats, "solidity")
        f.write(f"Solidity: {m:.3f} ± {sd:.3f}\n\n")
        f.write("INTENSITY STATISTICS:\n")
        m, sd = _mean_std(stats, "mean_intensity")
        f.write(f"Mean intensity: {m:.3f} ± {sd:.3f}\n")
        m, sd = _mean_std(stats, "std_intensity")
        f.write(f"Std intensity: {m:.3f} ± {sd:.3f}\n\n")
        f.write("FILE-WISE SUMMARY:\n")
        for row in file_summary:
            f.write(f"{row['filename']}: {row['cells_extracted']} cells, "
                    f"avg intensity: {row['mean_cell_intensity']:.3f}\n")


def generate_final_report(output_dir: str, stats: list, history: dict, mse_errors,
                          mae_errors) -> None:
    """training_report.txt."""
    mse_errors, mae_errors = np.asarray(mse_errors), np.asarray(mae_errors)
    with open(os.path.join(output_dir, "training_report.txt"), "w") as f:
        f.write("=== IMPROVED ANOMALY DETECTION MODEL TRAINING REPORT ===\n\n")
        f.write(f"Generated: {_now()}\n\n")
        f.write("TRAINING DATA SUMMARY:\n")
        f.write(f"Total cells used for training: {len(stats)}\n")
        m, sd = _mean_std(stats, "area")
        f.write(f"Average cell area: {m:.1f} ± {sd:.1f}\n")
        m, sd = _mean_std(stats, "eccentricity")
        f.write(f"Average eccentricity: {m:.3f} ± {sd:.3f}\n\n")
        f.write("TRAINING PERFORMANCE:\n")
        f.write(f"Final training loss: {history['loss'][-1]:.6f}\n")
        f.write(f"Final validation loss: {history['val_loss'][-1]:.6f}\n")
        f.write(f"Best validation loss: {min(history['val_loss']):.6f}\n")
        f.write(f"Training epochs: {len(history['loss'])}\n\n")
        f.write("RECONSTRUCTION ERROR STATISTICS:\n")
        f.write(f"MSE - Mean: {np.mean(mse_errors):.6f}, Std: {np.std(mse_errors):.6f}\n")
        f.write(f"MSE - 95th percentile: {np.percentile(mse_errors, 95):.6f}\n")
        f.write(f"MAE - Mean: {np.mean(mae_errors):.6f}, Std: {np.std(mae_errors):.6f}\n")
        f.write(f"MAE - 95th percentile: {np.percentile(mae_errors, 95):.6f}\n\n")
        f.write("MODEL FILES GENERATED:\n")
        f.write("- best_autoencoder.keras: Best autoencoder model\n")
        f.write("- final_autoencoder.keras: Final autoencoder model\n")
        f.write("- encoder.keras: Encoder model\n")
        f.write("- scaler.pkl: Feature scaler\n")
        f.write("- pca.pkl: PCA transformer\n")
        f.write("- detector_conservative.pkl: Conservative anomaly detector\n")
        f.write("- detector_moderate.pkl: Moderate anomaly detector\n")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_training_history(output_dir: str, history: dict) -> None:
    """training_history.png.  Needs matplotlib."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    ax1.plot(history["loss"], label="Training Loss")
    ax1.plot(history["val_loss"], label="Validation Loss")
    ax1.set_title("Model Loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax1.legend()
    ax2.plot(history["mae"], label="Training MAE")
    ax2.plot(history["val_mae"], label="Validation MAE")
    ax2.set_title("Model MAE")
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("MAE")
    ax2.legend()
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "training_history.png"), dpi=300)
    plt.close(fig)


def plot_reconstruction_errors(output_dir: str, mse_errors, mae_errors) -> None:
    """reconstruction_error_distribution.png.  Needs matplotlib."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    for ax, errs, name in ((ax1, mse_errors, "MSE"), (ax2, mae_errors, "MAE")):
        ax.hist(errs, bins=50, alpha=0.7)
        ax.set_xlabel(name)
        ax.set_ylabel("Frequency")
        ax.set_title(f"Distribution of {name} Reconstruction Errors")
        ax.axvline(np.percentile(errs, 95), color="red", linestyle="--", label="95th percentile")
        ax.legend()
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "reconstruction_error_distribution.png"), dpi=300)
    plt.close(fig)


def plot_reconstruction_samples(output_dir: str, original: np.ndarray, reconstructed: np.ndarray,
                                n_samples: int = 10, seed: int = 42) -> None:
    """reconstruction_samples.png: `n_samples` cells drawn with
    `default_rng(seed)`, as JAX draws them.  Needs matplotlib."""
    plt = _pyplot()
    n_samples = min(n_samples, len(original))
    idx = np.random.default_rng(seed).choice(len(original), n_samples, replace=False)
    fig, axes = plt.subplots(2, n_samples, figsize=(2 * n_samples, 4))
    if n_samples == 1:
        axes = axes.reshape(2, 1)
    for i, j in enumerate(idx):
        axes[0, i].imshow(np.squeeze(original[j]), cmap="gray")
        axes[0, i].set_title("Original")
        axes[0, i].axis("off")
        axes[1, i].imshow(np.squeeze(reconstructed[j]), cmap="gray")
        axes[1, i].set_title("Reconstructed")
        axes[1, i].axis("off")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "reconstruction_samples.png"), dpi=300)
    plt.close(fig)


# --------------------------------------------------------------- screening --

def _cell(v):
    """A CSV field as pandas writes it: floats by `repr`, the rest by `str`."""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return v


def save_screening_csvs(output_dir: str, results: dict, detailed_results: list) -> tuple:
    """screening_summary.csv (one row a sample, the sample name as the
    unnamed index column) and detailed_cell_results.csv (one row a cell).
    Returns (results, detailed_results) as given."""
    with open(os.path.join(output_dir, "screening_summary.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        cols = list(next(iter(results.values()))) if results else []
        w.writerow(["", *cols])
        for name, row in results.items():
            w.writerow([name, *(_cell(row[c]) for c in cols)])
    with open(os.path.join(output_dir, "detailed_cell_results.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        cols = list(detailed_results[0]) if detailed_results else []
        w.writerow(cols)
        for row in detailed_results:
            w.writerow([_cell(row[c]) for c in cols])
    return results, detailed_results


def _correlation(results: dict, cols: list) -> np.ndarray:
    """Pearson correlation of the samples' columns (NaN where a column is
    constant, as pandas gives)."""
    X = np.array([[float(r[c]) for c in cols] for r in results.values()], np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.corrcoef(X, rowvar=False)


def create_screening_visualizations(output_dir: str, results: dict, detailed_results: list,
                                    triage: TriageConfig = TriageConfig()) -> None:
    """The three screening figures.  Needs matplotlib."""
    plt = _pyplot()

    # 1. anomaly-rate bars with reference lines
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 6))
    sample_names = list(results)
    cons = [r["conservative_anomaly_rate"] * 100 for r in results.values()]
    mod = [r["moderate_anomaly_rate"] * 100 for r in results.values()]
    ax1.bar(sample_names, cons, color="lightcoral", alpha=0.8)
    ax1.axhline(y=triage.expected_normal_conservative * 100, color="blue", linestyle="--",
                alpha=0.7, label="Expected Normal (~5%)")
    ax1.axhline(y=triage.high_conservative * 100, color="red", linestyle="--",
                alpha=0.7, label="High Anomaly Threshold")
    ax1.set_title("Conservative Model - Anomaly Rates")
    ax1.set_ylabel("Anomaly Rate (%)")
    ax1.tick_params(axis="x", rotation=45)
    ax1.legend()
    bars2 = ax2.bar(sample_names, mod, color="lightblue", alpha=0.8)
    ax2.axhline(y=triage.expected_normal_moderate * 100, color="blue", linestyle="--",
                alpha=0.7, label="Expected Normal (~10%)")
    ax2.axhline(y=triage.high_moderate * 100, color="red", linestyle="--",
                alpha=0.7, label="High Anomaly Threshold")
    ax2.set_title("Moderate Model - Anomaly Rates")
    ax2.set_ylabel("Anomaly Rate (%)")
    ax2.tick_params(axis="x", rotation=45)
    ax2.legend()
    for bar, rate in zip(bars2, mod):
        ax2.text(bar.get_x() + bar.get_width() / 2, bar.get_height() + 0.5,
                 f"{rate:.1f}%", ha="center", va="bottom", fontweight="bold")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "anomaly_rates_comparison.png"), dpi=300,
                bbox_inches="tight")
    plt.close(fig)

    # 2. per-sample MSE histograms
    by_sample: dict = {}
    for row in detailed_results:
        by_sample.setdefault(row["sample_name"], []).append(row["mse"])
    n = len(by_sample)
    fig, axes = plt.subplots(2, max((n + 1) // 2, 1), figsize=(15, 8))
    axes = np.atleast_1d(axes).flatten()
    for i, (name, mse) in enumerate(by_sample.items()):
        if i >= len(axes):
            break
        axes[i].hist(mse, bins=30, alpha=0.7, density=True)
        axes[i].set_title(f"{name}\n(n={len(mse)})")
        axes[i].set_xlabel("MSE")
        axes[i].set_ylabel("Density")
        mean_mse = float(np.mean(mse))
        axes[i].axvline(mean_mse, color="red", linestyle="--", label=f"Mean: {mean_mse:.4f}")
        axes[i].legend()
    for i in range(n, len(axes)):
        axes[i].set_visible(False)
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "mse_distributions.png"), dpi=300, bbox_inches="tight")
    plt.close(fig)

    # 3. correlation matrix (only with more than one sample)
    if len(results) > 1:
        cols = ["conservative_anomaly_rate", "moderate_anomaly_rate", "mean_mse", "mean_mae"]
        corr = _correlation(results, cols)
        finite = np.abs(corr[np.isfinite(corr)])
        span = float(finite.max()) if finite.size else 1.0
        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(corr, cmap="coolwarm", vmin=-span, vmax=span)
        ax.set_xticks(range(len(cols)), cols, rotation=45, ha="right")
        ax.set_yticks(range(len(cols)), cols)
        for i in range(len(cols)):
            for j in range(len(cols)):
                ax.text(j, i, f"{corr[i, j]:.2g}", ha="center", va="center")
        fig.colorbar(im, ax=ax, label="Correlation Coefficient")
        ax.set_title("Correlation Matrix of Anomaly Metrics")
        plt.tight_layout()
        plt.savefig(os.path.join(output_dir, "correlation_matrix.png"), dpi=300,
                    bbox_inches="tight")
        plt.close(fig)


def generate_screening_report(output_dir: str, results: dict,
                              triage: TriageConfig = TriageConfig()) -> None:
    """mutant_screening_report.txt with the triage rules."""
    with open(os.path.join(output_dir, "mutant_screening_report.txt"), "w") as f:
        f.write("=== MUTANT SCREENING REPORT (IMPROVED MODEL) ===\n\n")
        f.write(f"Generated: {_now()}\n\n")
        f.write("MODEL PERFORMANCE BASELINE:\n")
        f.write("- Conservative model: ~5% anomaly rate for normal cells\n")
        f.write("- Moderate model: ~10% anomaly rate for normal cells\n\n")
        f.write("SCREENING RESULTS:\n")
        f.write("-" * 80 + "\n")
        f.write(f"{'Sample':<20} {'Cells':<8} {'Conservative':<12} {'Moderate':<12} "
                f"{'Mean MSE':<12}\n")
        f.write("-" * 80 + "\n")
        for sample_name, row in results.items():
            f.write(
                f"{sample_name:<20} {row['total_cells']:<8} "
                f"{row['conservative_anomaly_rate'] * 100:>8.1f}% "
                f"{row['moderate_anomaly_rate'] * 100:>10.1f}% "
                f"{row['mean_mse']:>10.6f}\n"
            )
        f.write("\n")
        f.write("ANOMALY ANALYSIS:\n")

        def section(title: str, key: str, keep) -> None:
            rows = [(name, r[key]) for name, r in results.items() if keep(r[key])]
            if rows:
                f.write(f"\n{title}\n")
                for name, rate in rows:
                    f.write(f"- {name}: {rate * 100:.1f}%\n")

        section(f"HIGH ANOMALY CANDIDATES (Conservative >{triage.high_conservative*100:.0f}%):",
                "conservative_anomaly_rate", lambda v: v > triage.high_conservative)
        section(f"HIGH ANOMALY CANDIDATES (Moderate >{triage.high_moderate*100:.0f}%):",
                "moderate_anomaly_rate", lambda v: v > triage.high_moderate)
        section(f"NORMAL-LEVEL SAMPLES (Conservative ≤{triage.normal_conservative*100:.0f}%):",
                "conservative_anomaly_rate", lambda v: v <= triage.normal_conservative)
        if results and all("ensemble_anomaly_rate" in r for r in results.values()):
            section("ENSEMBLE (recon-error + SVM majority vote):", "ensemble_anomaly_rate",
                    lambda v: True)
        f.write("\n\nRECOMMENDATIONS:\n")
        f.write("1. Focus on samples with Conservative >15% for detailed analysis\n")
        f.write("2. Samples with Conservative ≤10% are likely normal phenotype\n")
        f.write("3. Consider morphological analysis for high-anomaly candidates\n")
        f.write("4. Validate results with independent experimental methods\n")
