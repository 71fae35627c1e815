"""Training entry point: `ImprovedAnomalyDetectionTraining`.

Counterpart of `cell_image_analysis_tpu/pipeline/training.py`, stage for
stage:

  1. create_training_dataset: threaded TIFF ingest -> same-shape batches of
     8 frames through segmentation, stage A and stage B
     (`ops.extract.extract_cells_frames`, re-run through the exact twin on
     an overflow flag) -> cell_statistics.csv, file_summary.csv,
     data_quality_report.txt;
  2. train_autoencoder: `train.trainer.fit_cae` -> best / final / encoder
     model files and training_history.png;
  3. evaluate_reconstruction_quality: per-cell MSE / MAE and two figures;
  4. create_anomaly_detector: encoder features -> RobustScaler -> PCA ->
     the conservative and moderate one-class SVMs, the ensemble threshold
     and the FFT detector -> the rest of the store;
  5. generate_final_report: training_report.txt.

The segmentation backend is the screener's (`models.segmentation.
select_backend`); its label maps also give the report's solidity.
Everything runs on `device` (default: the card; without one and without
`device="cpu"` the constructor raises).  With a `mesh` (`parallel.mesh`)
`fit_cae` trains data-parallel over it, and everything else runs on its
first device, the extraction included, as in JAX.  Each stage has a `StageTimer`
entry.  Below `TrainConfig.min_cells` cells `run` returns False.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cell_image_analysis_tpu_torch import config as C
from cell_image_analysis_tpu_torch.config import PipelineConfig
from cell_image_analysis_tpu_torch.io import artifacts
from cell_image_analysis_tpu_torch.io.ingest import FrameStream, frames_to_device, list_tiffs
from cell_image_analysis_tpu_torch.models.cae import encode, reconstruction_errors
from cell_image_analysis_tpu_torch.models.ensemble import EnsembleDetector
from cell_image_analysis_tpu_torch.models.pca import PCA
from cell_image_analysis_tpu_torch.models.scaler import RobustScaler
from cell_image_analysis_tpu_torch.models.segmentation import select_backend
from cell_image_analysis_tpu_torch.models.svm import OneClassSVM
from cell_image_analysis_tpu_torch.ops.extract import extract_cells_frames
from cell_image_analysis_tpu_torch.ops.fft_features import fft_features
from cell_image_analysis_tpu_torch.ops.oracle.regionprops_np import convex_area
from cell_image_analysis_tpu_torch.parallel.mesh import canonical_device
from cell_image_analysis_tpu_torch.pipeline import reports
from cell_image_analysis_tpu_torch.train.trainer import fit_cae
from cell_image_analysis_tpu_torch.utils.profiler import StageTimer

_BATCH_FRAMES = 8  # frames an extraction batch


def _solidity_for_labels(labels: np.ndarray, label_ids: np.ndarray,
                         areas: np.ndarray) -> np.ndarray:
    """Solidity (area / convex area) of each listed label, on the host: a
    report statistic, never a QC gate.  Bounding boxes come from one
    `scipy.ndimage.find_objects` pass, so each hull scans its own box."""
    from scipy import ndimage as ndi

    out = np.zeros(len(label_ids), np.float64)
    if not len(label_ids):
        return out
    slices = ndi.find_objects(labels)
    for i, (lab, area) in enumerate(zip(label_ids, areas)):
        if lab <= 0 or lab > len(slices) or slices[lab - 1] is None:
            continue
        sl = slices[lab - 1]
        rr, cc = np.nonzero(labels[sl] == lab)
        if not len(rr):
            continue
        ca = convex_area(np.stack([rr + sl[0].start, cc + sl[1].start], axis=1))
        out[i] = float(area) / ca if ca else 0.0
    return out


class ImprovedAnomalyDetectionTraining:
    """The trainer.  `unet_variables` (flax-layout numpy, as
    `io.artifacts.load_unet_variables` returns) selects the StarDist
    backend; without them, or with `config.seg.backend == "threshold"`, the
    threshold backend runs."""

    def __init__(self, output_dir: str, config: PipelineConfig = PipelineConfig(),
                 unet_variables=None, device=None, mesh=None):
        self.output_dir = output_dir
        self.config = config
        self.unet_variables = unet_variables
        self.mesh = mesh
        if mesh is not None:
            if device is not None and canonical_device(device) != mesh.home:
                raise ValueError(f"device {device} is not the mesh's first device {mesh.home}")
            device = mesh.home
        self.device = artifacts.resolve_device(device)
        self.timer = StageTimer()
        self._segment, self._segment_fallback, self._unet = select_backend(
            config.seg, config.extract.cell_capacity, unet_variables, self.device)
        os.makedirs(output_dir, exist_ok=True)

    # stage 1 -----------------------------------------------------------------
    def extraction_arguments(self, h: int, w: int) -> dict:
        """The keyword arguments of `extract_cells_frames` for (h, w) frames."""
        cfg = self.config
        return dict(
            fallback_segment_fn=self._segment_fallback,
            out_size=cfg.extract.out_size,
            rcap=32 * max(1, w // 1024),
            label_capacity=max(cfg.extract.cell_capacity * 2, 1024),
            cell_capacity=cfg.extract.cell_capacity,
            crop_capacity=cfg.extract.crop_capacity,
            border_margin=cfg.qc.border_margin,
            min_area=cfg.qc.min_area,
            max_area=cfg.qc.max_area,
            max_eccentricity=cfg.qc.max_eccentricity,
            min_mean_intensity=cfg.qc.min_mean_intensity,
            min_std_intensity=cfg.qc.min_std_intensity,
        )

    def extract_batch(self, segs: torch.Tensor, greens: torch.Tensor):
        """(B, H, W) frames on the device -> (cells (n, 64, 64) numpy, stats
        dict with `frame_index`, (B, H, W) uint16 label maps)."""
        return extract_cells_frames(segs, greens, self._segment, return_labels=True,
                                    **self.extraction_arguments(*segs.shape[1:]))

    def create_training_dataset(self, folder_path: str):
        print("=== Creating High-Quality Training Dataset ===")
        file_paths = list_tiffs(folder_path)
        print(f"Found {len(file_paths)} image files")
        all_cells, all_stats, file_summary = [], [], []

        def flush(pend):
            if not pend:
                return
            try:
                with self.timer.stage("extract_batch"):
                    segs = frames_to_device([p[1] for p in pend], self.device)
                    greens = frames_to_device([p[2] for p in pend], self.device)
                    cells, st, labels16 = self.extract_batch(segs, greens)
            except Exception as e:  # skip-and-log (reference behavior)
                for path, _, _ in pend:
                    print(f"Error processing {path}: {e}")
                    file_summary.append(dict(filename=os.path.basename(path), cells_extracted=0,
                                             mean_cell_intensity=0))
                pend.clear()
                return
            for f, (path, _, _) in enumerate(pend):
                filename = os.path.basename(path)
                m = st["frame_index"] == f
                with self.timer.stage("solidity"):
                    sols = _solidity_for_labels(labels16[f].astype(np.int32),
                                                st["label_ids"][m], st["area"][m])
                n_f = int(m.sum())
                for a, e, s, mi, sd in zip(st["area"][m], st["eccentricity"][m], sols,
                                           st["mean_intensity"][m], st["std_intensity"][m]):
                    all_stats.append(dict(area=int(a), eccentricity=float(e), solidity=float(s),
                                          mean_intensity=float(mi), std_intensity=float(sd),
                                          file=filename))
                all_cells.append(cells[m])
                file_summary.append(dict(
                    filename=filename, cells_extracted=n_f,
                    mean_cell_intensity=float(st["mean_intensity"][m].mean()) if n_f else 0))
                print(f"  Extracted {n_f} quality cells")
            pend.clear()

        pend: list = []
        stream = FrameStream(file_paths)
        for i, (path, seg, green) in enumerate(stream):
            print(f"Processing {i + 1}/{len(file_paths)}: {os.path.basename(path)}")
            if pend and seg.shape != pend[0][1].shape:
                flush(pend)
            pend.append((path, seg, green))
            if len(pend) >= _BATCH_FRAMES:
                flush(pend)
        flush(pend)
        for path, err in stream.errors:
            print(f"Error processing {path}: {err}")
            file_summary.append(dict(filename=os.path.basename(path), cells_extracted=0,
                                     mean_cell_intensity=0))

        cells = (np.concatenate(all_cells, axis=0) if all_cells
                 else np.zeros((0, 64, 64), np.float32))
        print(f"\nTotal quality cells extracted: {len(cells)}")
        reports.write_dataset_csvs(self.output_dir, all_stats, file_summary)
        if all_stats:
            reports.generate_data_quality_report(self.output_dir, all_stats, file_summary)
        return cells, all_stats

    # stage 2 -----------------------------------------------------------------
    def train_autoencoder(self, cell_images, figures: bool = True):
        """fit_cae on the cells (moved to the device); writes the three
        model files.  Returns (model, best state dict, history)."""
        print("=== Training Autoencoder ===")
        X = torch.as_tensor(np.asarray(cell_images, np.float32), device=self.device)
        with self.timer.stage("train_cae"):
            model, best_state, history = fit_cae(X, cae_cfg=self.config.cae,
                                                 train_cfg=self.config.train,
                                                 aug_cfg=self.config.augment, mesh=self.mesh)
        self._final_state = best_state
        if figures:
            reports.plot_training_history(self.output_dir, history.history)
        for name in (C.ARTIFACT_BEST_AUTOENCODER, C.ARTIFACT_FINAL_AUTOENCODER,
                     C.ARTIFACT_ENCODER):
            artifacts.save_cae(os.path.join(self.output_dir, name), model, best_state)
        return model, best_state, history

    # stage 3 -----------------------------------------------------------------
    def evaluate_reconstruction_quality(self, model, cell_images, figures: bool = True):
        print("=== Evaluating Reconstruction Quality ===")
        X = torch.as_tensor(np.asarray(cell_images, np.float32)[..., None], device=self.device)
        with self.timer.stage("recon_eval"):
            mse, mae = (t.cpu().numpy() for t in reconstruction_errors(model, X))
        print(f"MSE - Mean: {mse.mean():.6f}, Std: {mse.std():.6f}")
        print(f"MAE - Mean: {mae.mean():.6f}, Std: {mae.std():.6f}")
        if figures:
            with torch.no_grad():
                recon = torch.cat([model(X[s:s + 1024])[0] for s in range(0, len(X), 1024)])
            reports.plot_reconstruction_errors(self.output_dir, mse, mae)
            reports.plot_reconstruction_samples(self.output_dir, X.cpu().numpy(),
                                                recon.cpu().numpy())
        return mse, mae

    # stage 4 -----------------------------------------------------------------
    def create_anomaly_detector(self, model, best_state, cell_images, mse_errors=None):
        print("=== Creating Anomaly Detector ===")
        cfg = self.config
        X = torch.as_tensor(np.asarray(cell_images, np.float32)[..., None], device=self.device)
        with self.timer.stage("detector_fit"):
            features = encode(model, X)
            print(f"Flattened features shape: {tuple(features.shape)}")
            scaler = RobustScaler()
            scaled = scaler.fit_transform(features)
            n_components = min(cfg.detector.pca_components, scaled.shape[1], scaled.shape[0] - 1)
            pca = PCA(n_components=n_components)
            reduced = pca.fit_transform(scaled)
            print(f"PCA reduced to {n_components} components")
            print(f"Explained variance ratio (first 5): {pca.explained_variance_ratio_[:5]}")
            detectors = {
                "Conservative": OneClassSVM(nu=cfg.detector.nu_conservative,
                                            gamma=cfg.detector.gamma),
                "Moderate": OneClassSVM(nu=cfg.detector.nu_moderate, gamma=cfg.detector.gamma),
            }
            for det in detectors.values():
                det.fit(reduced)

        print("\nBaseline anomaly rates:")
        for name, det in detectors.items():
            rate = (det.predict(reduced) == -1).mean()
            print(f"{name}: {rate * 100:.2f}%")

        if mse_errors is None:
            mse_errors = reconstruction_errors(model, X)[0].cpu().numpy()
        ensemble = EnsembleDetector.fit(np.asarray(mse_errors), cfg.ensemble)

        with self.timer.stage("detector_fit"):
            fft = fft_features(X, radial_bins=cfg.fft.radial_bins,
                               angular_bins=cfg.fft.angular_bins)
            fft_scaler = RobustScaler().fit(fft)
            fft_detector = OneClassSVM(nu=cfg.detector.nu_moderate, gamma=cfg.detector.gamma)
            fft_detector.fit(fft_scaler.transform(fft))
        fft_rate = (fft_detector.predict(fft_scaler.transform(fft)) == -1).mean()
        print(f"FFT: {fft_rate * 100:.2f}%")

        artifacts.save_training_artifacts(
            self.output_dir, model, best_state, self._final_state, scaler, pca, detectors,
            ensemble, fft_scaler=fft_scaler, fft_detector=fft_detector)
        return detectors, scaler, pca, ensemble

    # stage 5 -----------------------------------------------------------------
    def generate_final_report(self, stats, history, mse_errors, mae_errors):
        reports.generate_final_report(self.output_dir, stats, history.history, mse_errors,
                                      mae_errors)

    # full run ------------------------------------------------------------------
    def run(self, folder_path: str, figures: bool = True) -> bool:
        """The five stages; False below `min_cells` cells.  The three
        figures need matplotlib, and without it writing them raises;
        `figures=False` leaves them out."""
        reports.save_run_parameters(self.output_dir, self.config, {"input_folder": folder_path})
        cell_images, stats = self.create_training_dataset(folder_path)
        if len(cell_images) < self.config.train.min_cells:
            print(f"Warning: Only {len(cell_images)} cells available. "
                  f"Recommend >{self.config.train.min_cells} for stable training.")
            return False
        if not figures:
            print("Figures not written (training without figures)")
        model, best_state, history = self.train_autoencoder(cell_images, figures)
        mse_errors, mae_errors = self.evaluate_reconstruction_quality(model, cell_images, figures)
        self.create_anomaly_detector(model, best_state, cell_images, mse_errors)
        self.generate_final_report(stats, history, mse_errors, mae_errors)
        print("\n=== TRAINING COMPLETED ===")
        print(f"Models and reports saved to: {self.output_dir}")
        print(f"Quality cells used: {len(cell_images)}")
        print(self.timer.report())
        return True
