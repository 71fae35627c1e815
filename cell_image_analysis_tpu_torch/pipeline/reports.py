"""Screening report writers: the output-file contract of screening.

Counterpart of `cell_image_analysis_tpu/pipeline/reports.py`'s screening
half: `run_parameters.json`, `screening_summary.csv`,
`detailed_cell_results.csv`, the three figures
(`anomaly_rates_comparison.png`, `mse_distributions.png`,
`correlation_matrix.png`) and `mutant_screening_report.txt`.

The CSVs and the text report are written with the standard library and
numpy, in the columns, order and number formatting of the JAX package's
pandas writers, so that `pandas.read_csv` reads equal frames from both.
Only the figures need matplotlib, which is imported inside
`create_screening_visualizations`: without it that call raises.  The
training reports are not ported yet.
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
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
