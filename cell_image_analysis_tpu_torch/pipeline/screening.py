"""Screening entry point: `ProductionMutantScreening`, on one device.

Counterpart of `cell_image_analysis_tpu/pipeline/screening.py` without a
mesh: load the artifact store, stream each sample folder's TIFFs into
same-shape batches, run every batch through the fused
segmentation -> extraction -> scoring path (`pipeline.scoring`) with one
batch in flight, and write the CSVs, the figures and the report.

The spatial tiler's route (`tiled_route` / `score_tiled` in the JAX
module) needs a mesh and is not ported; without a mesh the JAX screener
never takes it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cell_image_analysis_tpu_torch.config import PipelineConfig
from cell_image_analysis_tpu_torch.io import artifacts
from cell_image_analysis_tpu_torch.io.ingest import FrameStream, list_tiffs
from cell_image_analysis_tpu_torch.models.segmentation import (
    StarDistBackend,
    ThresholdBackend,
    segment_frame,
)
from cell_image_analysis_tpu_torch.ops.extract import extract_cells_chunked
from cell_image_analysis_tpu_torch.pipeline import reports
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    compute_anomaly_scores,
    score_frames_fused_start,
    score_frames_fused_wait,
)
from cell_image_analysis_tpu_torch.utils.profiler import StageTimer, ThroughputMeter

_SCORE_CHUNK = 512  # cells a `compute_anomaly_scores` call
_BATCH_MAX = 16     # frames a fused batch


class ProductionMutantScreening:
    """The screener.  `unet_variables` (flax-layout numpy, as
    `io.artifacts.load_unet_variables` returns) selects the StarDist
    backend; without them, or with `config.seg.backend == "threshold"`, the
    threshold backend runs.  Everything lives on `device` (default: the
    card; without one and without `device="cpu"` this raises)."""

    def __init__(self, model_dir: str, config: PipelineConfig = PipelineConfig(),
                 unet_variables=None, device=None):
        self.model_dir = model_dir
        self.config = config
        self.unet_variables = unet_variables
        self.device = artifacts.resolve_device(device)
        self.timer = StageTimer()
        self.meter = ThroughputMeter()
        self.decode_seconds = 0.0  # TIFF decode, summed over the ingest workers
        self._unet = None
        self._segment_mask = None
        if config.seg.backend == "threshold" or unet_variables is None:
            # the mask route (run-length connected components), with the
            # label route as the exact fallback of a run-table overflow
            self._segment_mask = ThresholdBackend(config.seg)
            self._segment = None
            self._segment_fallback = self._segment_mask.exact_twin()
        else:
            # raster-capped predict_instances with the run-length label
            # regionprops; the exact twin (scatter rasterizer, K^2 NMS pairs,
            # pixel regionprops) takes every overflow re-run
            seg_cfg = config.seg
            if not seg_cfg.raster_cap:
                seg_cfg = dataclasses.replace(seg_cfg, raster_cap=config.extract.cell_capacity)
            self._segment = StarDistBackend(unet_variables, seg_cfg, device=self.device)
            self._segment_fallback = self._segment.exact_twin()
            self._unet = self._segment.model
        # plate-scale backends: the capacities scale with the frame's area
        # (the defaults are tuned for frames up to 1024^2), keyed by shape
        self._plate_backends: dict = {}
        self.load_trained_models()

    def _capacity_scale(self, h: int, w: int) -> int:
        """Frame-area multiple of the 1024^2 tuning baseline (>= 1)."""
        return max(1, -(-(h * w) // (1024 * 1024)))

    def _segment_for(self, h: int, w: int):
        """(segment_fn, fallback_fn) with area-scaled capacities."""
        scale = self._capacity_scale(h, w)
        if self._segment_mask is not None or scale == 1:
            return self._segment_mask or self._segment, self._segment_fallback
        key = (h, w)
        if key not in self._plate_backends:
            base = self._segment.cfg
            cfg = dataclasses.replace(
                base,
                max_candidates=base.max_candidates * scale,
                raster_cap=(base.raster_cap or base.max_candidates) * scale,
                nms_max_pairs=base.nms_max_pairs * scale,
            )
            primary = StarDistBackend(None, cfg, model=self._unet)
            self._plate_backends[key] = (primary, primary.exact_twin())
        return self._plate_backends[key]

    def load_trained_models(self):
        """The artifact contract: CAE, scaler, PCA, detectors, ensemble."""
        print("Loading trained models...")
        (model, self.variables, self.scaler, self.pca,
         self.detectors, self.ensemble) = artifacts.load_screening_artifacts(self.model_dir)
        self.model, self.scoring_params = artifacts.build_scoring_params(
            model, self.variables, self.scaler, self.pca, self.detectors, self.ensemble,
            device=self.device)
        print("All models loaded successfully!")

    def _qc_kwargs(self) -> dict:
        cfg = self.config
        return dict(
            crop_capacity=cfg.extract.crop_capacity,
            border_margin=cfg.qc.border_margin,
            min_area=cfg.qc.min_area,
            max_area=cfg.qc.max_area,
            max_eccentricity=cfg.qc.max_eccentricity,
            min_mean_intensity=cfg.qc.min_mean_intensity,
            min_std_intensity=cfg.qc.min_std_intensity,
        )

    def extract_quality_cells(self, seg_channel: np.ndarray, green_channel: np.ndarray):
        """One frame -> (cells (n, 64, 64) float32, per-cell stats): label
        maps through the pixel regionprops, then CLAHE and resize."""
        cfg = self.config
        seg = torch.as_tensor(seg_channel.astype(np.float32), device=self.device)
        green = torch.as_tensor(green_channel.astype(np.float32), device=self.device)
        labels = segment_frame(seg[None], cfg.seg, self._unet)[0]
        cells, st = extract_cells_chunked(
            labels, green,
            out_size=cfg.extract.out_size,
            label_capacity=max(cfg.extract.cell_capacity * 2, 1024),
            cell_capacity=cfg.extract.cell_capacity,
            **self._qc_kwargs(),
        )
        stats = [
            dict(area=int(a), eccentricity=float(e), mean_intensity=float(m),
                 std_intensity=float(s))
            for a, e, m, s in zip(st["area"], st["eccentricity"], st["mean_intensity"],
                                  st["std_intensity"])
        ]
        return cells, stats

    def compute_anomaly_scores(self, cell_images: np.ndarray) -> dict:
        """Scores of host cells, `_SCORE_CHUNK` a call."""
        n = len(cell_images)
        if n == 0:
            return {}
        chunks = [
            compute_anomaly_scores(self.model, self.scoring_params,
                                   np.asarray(cell_images[start:start + _SCORE_CHUNK], np.float32),
                                   min_votes=self.config.ensemble.min_votes)
            for start in range(0, n, _SCORE_CHUNK)
        ]
        out = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in (
            "reconstruction_mse", "reconstruction_mae", "conservative_predictions",
            "moderate_predictions", "conservative_scores", "moderate_scores",
            "ensemble_predictions", "fft_features")}
        for name in ("conservative", "moderate", "ensemble"):
            out[f"{name}_anomaly_rate"] = float(np.mean(out[f"{name}_predictions"] == -1))
        return out

    def fused_arguments(self, h: int, w: int) -> tuple:
        """(segment_fn, keyword arguments) of the fused path for (h, w)
        frames: what `_score_sample_frames` hands `score_frames_fused_start`."""
        cfg = self.config
        # the threshold backend bounds the foreground at (100 -
        # threshold_percentile)% of the frame, so the regionprops compaction
        # capacity can shrink with it
        if cfg.seg.backend == "threshold":
            fg_fraction = min(0.25, (100.0 - cfg.seg.threshold_percentile) / 100.0 + 0.02)
        else:
            fg_fraction = 0.25
        scale = self._capacity_scale(h, w)
        seg_fn, fb_fn = self._segment_for(h, w)
        return seg_fn, dict(
            fallback_segment_fn=fb_fn,
            chunk=32, caps=(64, 96),
            fg_fraction=fg_fraction,
            rcap=32 * max(1, w // 1024),
            label_capacity=max(cfg.extract.cell_capacity * 2 * scale, 1024),
            cell_capacity=cfg.extract.cell_capacity * scale,
            out_size=cfg.extract.out_size,
            min_votes=cfg.ensemble.min_votes,
            **self._qc_kwargs(),
        )

    def frames_to_device(self, channels: list) -> torch.Tensor:
        """Same-shape host channels -> one (B, H, W) float32 tensor on the
        device.  For the card they are cast into pinned memory and copied
        without waiting, so the copy does not hold up the batch in flight."""
        pinned = self.device.type == "cuda"
        host = torch.empty((len(channels), *channels[0].shape), dtype=torch.float32,
                           pin_memory=pinned)
        buf = host.numpy()
        for i, c in enumerate(channels):
            buf[i] = c
        return host.to(self.device, non_blocking=True) if pinned else host

    def _score_sample_frames(self, tif_files: list) -> tuple[dict, list, list]:
        """Screen one sample: frames stream in, stack into same-shape
        batches and run the fused path; only per-cell score vectors come
        back to the host.  Returns (scores dict, per-file cell counts,
        per-file mean intensities)."""
        frame_names: list = []
        pend_frames: list = []
        pend_idx: list = []
        all_scores: list = []
        all_stats: list = []
        # One batch stays in flight: flush() only enqueues, and the host's
        # part of the previous batch runs while the new one's stage A
        # computes on the device.
        in_flight: list = []

        def drain():
            pend, idxs = in_flight.pop(0)
            with self.timer.stage("score_frames"):
                scores, stats = score_frames_fused_wait(pend)
            if scores:
                stats = dict(stats)
                stats["file_index"] = np.array(idxs)[stats["frame_index"]]
                all_scores.append(scores)
                all_stats.append(stats)

        def flush():
            if not pend_frames:
                return
            segs = self.frames_to_device([f[0] for f in pend_frames])
            greens = self.frames_to_device([f[1] for f in pend_frames])
            seg_fn, kwargs = self.fused_arguments(segs.shape[1], segs.shape[2])
            with self.timer.stage("score_frames"):
                pend = score_frames_fused_start(self.model, self.scoring_params, segs, greens,
                                                seg_fn, **kwargs)
            in_flight.append((pend, list(pend_idx)))
            pend_frames.clear()
            pend_idx.clear()
            while len(in_flight) > 1:
                drain()

        stream = FrameStream(tif_files)
        for path, seg, green in stream:
            frame_names.append(os.path.basename(path))
            if pend_frames and seg.shape != pend_frames[0][0].shape:
                flush()
            pend_frames.append((seg, green))
            pend_idx.append(len(frame_names) - 1)
            if len(pend_frames) >= _BATCH_MAX:
                flush()
        flush()
        while in_flight:
            drain()
        self.decode_seconds += stream.decode_seconds
        for path, err in stream.errors:
            print(f"Error processing {path}: {err}")

        if not all_scores:
            return {}, [], []

        merged = {k: np.concatenate([s[k] for s in all_scores])
                  for k in all_scores[0] if not k.endswith("_anomaly_rate")}
        for name in ("conservative", "moderate", "ensemble", "fft"):
            merged[f"{name}_anomaly_rate"] = float(np.mean(merged[f"{name}_predictions"] == -1))
        file_index = np.concatenate([s["file_index"] for s in all_stats])
        mean_int = np.concatenate([s["mean_intensity"] for s in all_stats])
        counts = [int((file_index == i).sum()) for i in range(len(frame_names))]
        means = [float(mean_int[file_index == i].mean()) if counts[i] else 0
                 for i in range(len(frame_names))]
        merged["_frame_names"] = frame_names
        return merged, counts, means

    def screen_mutant_samples(self, test_folders_dict: dict, output_dir: str,
                              figures: bool = True):
        """Screen every sample folder; returns (results, detailed_results)
        and writes the reports into `output_dir`.  The three figures need
        matplotlib, and without it writing them raises; `figures=False`
        leaves them out (the one switch for a machine without it)."""
        os.makedirs(output_dir, exist_ok=True)
        print("=== Starting Mutant Screening with Improved Model ===")
        reports.save_run_parameters(output_dir, self.config, {"samples": test_folders_dict})

        results: dict = {}
        detailed_results: list = []

        for sample_name, folder_path in test_folders_dict.items():
            print(f"\nProcessing {sample_name}...")
            tif_files = list_tiffs(folder_path)
            if not tif_files:
                print(f"  No .tif files found in {folder_path}")
                continue

            self.meter.start()
            scores, counts, _means = self._score_sample_frames(tif_files)
            n_cells = len(scores["reconstruction_mse"]) if scores else 0
            for fname, cnt in zip(scores.get("_frame_names", []), counts):
                print(f"  {fname}: {cnt} cells")
            print(f"  Total {sample_name} cells: {n_cells}")
            if n_cells == 0:
                print(f"  No quality cells extracted from {sample_name}")
                self.meter.stop(0)
                continue
            self.meter.stop(n_cells)

            results[sample_name] = dict(
                sample_name=sample_name,
                total_cells=n_cells,
                files_processed=len(tif_files),
                conservative_anomaly_rate=scores["conservative_anomaly_rate"],
                moderate_anomaly_rate=scores["moderate_anomaly_rate"],
                ensemble_anomaly_rate=scores["ensemble_anomaly_rate"],
                fft_anomaly_rate=scores.get("fft_anomaly_rate", 0.0),
                mean_mse=float(np.mean(scores["reconstruction_mse"])),
                std_mse=float(np.std(scores["reconstruction_mse"])),
                mean_mae=float(np.mean(scores["reconstruction_mae"])),
                std_mae=float(np.std(scores["reconstruction_mae"])),
            )

            for i in range(n_cells):
                detailed_results.append(dict(
                    sample_name=sample_name,
                    cell_id=i,
                    mse=float(scores["reconstruction_mse"][i]),
                    mae=float(scores["reconstruction_mae"][i]),
                    conservative_anomaly=bool(scores["conservative_predictions"][i] == -1),
                    moderate_anomaly=bool(scores["moderate_predictions"][i] == -1),
                    ensemble_anomaly=bool(scores["ensemble_predictions"][i] == -1),
                    fft_anomaly=bool(scores["fft_predictions"][i] == -1),
                    conservative_score=float(scores["conservative_scores"][i]),
                    moderate_score=float(scores["moderate_scores"][i]),
                ))

            r = results[sample_name]
            print(f"    Conservative anomaly rate: {r['conservative_anomaly_rate'] * 100:.2f}%")
            print(f"    Moderate anomaly rate: {r['moderate_anomaly_rate'] * 100:.2f}%")
            print(f"    Mean MSE: {r['mean_mse']:.6f}")

        self.save_and_visualize_results(results, detailed_results, output_dir, figures)
        if self.meter.items:
            print(f"\nThroughput: {self.meter.rate:.1f} cells/sec")
        print(self.timer.report())
        return results, detailed_results

    def save_and_visualize_results(self, results, detailed_results, output_dir,
                                   figures: bool = True):
        """The CSVs, the figures and the report (nothing without results)."""
        if not results:
            return
        reports.save_screening_csvs(output_dir, results, detailed_results)
        if figures:
            reports.create_screening_visualizations(output_dir, results, detailed_results,
                                                    self.config.triage)
        else:
            print("Figures not written (screening without figures)")
        reports.generate_screening_report(output_dir, results, self.config.triage)
