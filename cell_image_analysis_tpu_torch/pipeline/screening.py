"""Screening entry point: `ProductionMutantScreening`.

Counterpart of `cell_image_analysis_tpu/pipeline/screening.py`: load the
artifact store, stream each sample folder's TIFFs into same-shape batches,
run every batch through the fused segmentation -> extraction -> scoring
path (`pipeline.scoring`) with one batch in flight, and write the CSVs,
the figures and the report.

With a mesh (`parallel.mesh`) the scoring parameters, the CAE and the
segmentation backends are replicated over its devices, each fused batch is
split over the shards, and a frame whose sides are both at least
`ExtractConfig.tile_min_side` goes through the plate tiler instead
(`tiled_route` / `score_tiled`: `parallel.tiling`, its rows split over the
shards with halos, capacities scaled with each tile's area).  Without a
mesh the screener runs on one device and never takes the tiled route.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cell_image_analysis_tpu_torch.config import (
    PipelineConfig,
    capacity_scale,
    row_scale,
    scaled_seg_config,
)
from cell_image_analysis_tpu_torch.io import artifacts
from cell_image_analysis_tpu_torch.io.ingest import FrameStream, frames_to_device, list_tiffs
from cell_image_analysis_tpu_torch.models.segmentation import (
    StarDistBackend,
    segment_frame,
    select_backend,
)
from cell_image_analysis_tpu_torch.ops.extract import extract_cells_chunked
from cell_image_analysis_tpu_torch.parallel.mesh import AXIS, canonical_device
from cell_image_analysis_tpu_torch.parallel.sharding import pad_to_multiple, replicate, shard_batch
from cell_image_analysis_tpu_torch.parallel.tiling import (
    tiled_extract_cells,
    tiled_extract_cells_stardist,
)
from cell_image_analysis_tpu_torch.pipeline import reports
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    compute_anomaly_scores,
    score_frames_fused_start,
    score_frames_fused_wait,
)
from cell_image_analysis_tpu_torch.utils.profiler import (
    StageTimer,
    ThroughputMeter,
    counters,
    counters_report,
)

_SCORE_CHUNK = 512  # cells a `compute_anomaly_scores` call
_BATCH_MAX = 16     # frames a fused batch


class ProductionMutantScreening:
    """The screener.  `unet_variables` (flax-layout numpy, as
    `io.artifacts.load_unet_variables` returns) selects the StarDist
    backend; without them, or with `config.seg.backend == "threshold"`, the
    threshold backend runs.  With `config.seg.backend` "cellpose" or
    "cellpose_sam" they are the Cellpose weights
    (`io.artifacts.load_cellpose_weights`), on one
    device (no mesh).  Everything lives on `device` (default: the
    card; without one and without `device="cpu"` this raises).  With a
    `mesh` the home device is the mesh's first, which a `device` passed
    beside it must name."""

    def __init__(self, model_dir: str, config: PipelineConfig = PipelineConfig(),
                 unet_variables=None, device=None, mesh=None):
        self.model_dir = model_dir
        self.config = config
        self.unet_variables = unet_variables
        self.mesh = mesh
        if mesh is not None:
            if device is not None and canonical_device(device) != mesh.home:
                raise ValueError(f"device {device} is not the mesh's first device {mesh.home}")
            device = mesh.home
        self.device = artifacts.resolve_device(device)
        self.timer = StageTimer()
        self.meter = ThroughputMeter()
        self.decode_seconds = 0.0  # TIFF decode, summed over the ingest workers
        # the backend's label maps through the run-length regionprops
        # (StarDist raster-capped); the exact twin takes every overflow re-run
        if mesh is not None and config.seg.backend in ("cellpose", "cellpose_sam"):
            raise ValueError(f"the {config.seg.backend} backend screens on one device: no mesh")
        self._segment, self._segment_fallback, self._unet = select_backend(
            config.seg, config.extract.cell_capacity, unet_variables, self.device)
        # plate-scale backends: the capacities scale with the frame's area
        # (the defaults are tuned for frames up to 1024^2), keyed by shape
        self._plate_backends: dict = {}
        self.load_trained_models()
        # the tiler's U-Net, one copy a device of the mesh (the segmentation
        # backends keep their own copies: `StarDistBackend.to`)
        self._unets = (replicate(mesh, self._unet) if mesh is not None and self._unet is not None
                       else self._unet)

    def _segment_for(self, h: int, w: int):
        """(segment_fn, fallback_fn) with area-scaled capacities."""
        scale = capacity_scale(h, w)
        if not self._stardist() or scale == 1:
            return self._segment, self._segment_fallback
        key = (h, w)
        if key not in self._plate_backends:
            primary = StarDistBackend(None, scaled_seg_config(self._segment.cfg, scale),
                                      model=self._unet)
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
        # what scoring takes: (CAE, ScoringParams), on a mesh one copy a device
        self._scoring = (self.model, self.scoring_params) if self.mesh is None else (
            replicate(self.mesh, self.model), replicate(self.mesh, self.scoring_params))
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
        """Scores of host cells, `_SCORE_CHUNK` a call; on a mesh each
        chunk is padded to a multiple of the mesh and split over the
        shards."""
        n = len(cell_images)
        if n == 0:
            return {}
        chunks = []
        for start in range(0, n, _SCORE_CHUNK):
            block = np.asarray(cell_images[start:start + _SCORE_CHUNK], np.float32)
            valid = None
            if self.mesh is not None:
                padded, valid = pad_to_multiple(block, self.mesh.shape[AXIS])
                block = shard_batch(self.mesh, padded)
            chunks.append(compute_anomaly_scores(*self._scoring, block, valid=valid,
                                                 min_votes=self.config.ensemble.min_votes))
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
        scale = capacity_scale(h, w)
        seg_fn, fb_fn = self._segment_for(h, w)
        return seg_fn, dict(
            fallback_segment_fn=fb_fn,
            chunk=32, caps=(64, 96),
            fg_fraction=fg_fraction,
            rcap=32 * row_scale(w),
            label_capacity=max(cfg.extract.cell_capacity * 2 * scale, 1024),
            cell_capacity=cfg.extract.cell_capacity * scale,
            out_size=cfg.extract.out_size,
            min_votes=cfg.ensemble.min_votes,
            **self._qc_kwargs(),
        )

    def frames_to_device(self, channels: list) -> torch.Tensor:
        """Same-shape host channels -> one (B, H, W) float32 tensor on the
        screener's device (`io.ingest.frames_to_device`)."""
        return frames_to_device(channels, self.device)

    def _stardist(self) -> bool:
        return isinstance(self._segment, StarDistBackend)

    def tiled_route(self, shape: tuple) -> bool:
        """A frame takes the plate tiler when a mesh is attached, both its
        sides are at least `tile_min_side` and its rows split evenly over
        the shards (StarDist also needs the tile rows and the width aligned
        to the U-Net's pooling grid)."""
        if self.mesh is None or min(shape) < self.config.extract.tile_min_side:
            return False
        n = self.mesh.shape[AXIS]
        if shape[0] % n:
            return False
        align = 2 ** self.config.seg.unet_depth
        return not self._stardist() or (shape[0] // n % align == 0 and shape[1] % align == 0)

    def score_tiled(self, seg: np.ndarray, green: np.ndarray):
        """One plate through the tiler (`parallel.tiling`): halo = the crop
        capacity (aligned down to the pooling grid for StarDist), and the
        capacities scaled with each haloed tile's area, as the fused route
        scales them with the frame's.  StarDist re-runs once with the exact
        twin's settings (scatter rasterizer, every NMS pair) when a tile's
        segmentation flag fires; either backend then re-runs once at 4x
        `cell_capacity` when a tile's selection truncated, keeping the
        settings the first re-run chose, and warns for any flag still set
        after that.  Returns the `TiledCells`."""
        cfg = self.config
        rows = seg.shape[0] // self.mesh.shape[AXIS]
        align = 2 ** cfg.seg.unet_depth
        halo = min(cfg.extract.crop_capacity, rows)
        if self._stardist():
            halo = halo // align * align
        tile_scale = capacity_scale(rows + 2 * halo, seg.shape[1])
        kw = dict(halo=halo, cell_capacity=cfg.extract.cell_capacity * tile_scale,
                  out_size=cfg.extract.out_size, **self._qc_kwargs())
        seg_t, green_t = (torch.as_tensor(c.astype(np.float32)) for c in (seg, green))
        if self._stardist():
            seg_cfg = scaled_seg_config(self._segment.cfg, tile_scale)

            def run(kw):
                return tiled_extract_cells_stardist(seg_t, green_t, self.mesh,
                                                    self._unets,
                                                    seg_cfg=seg_cfg, **kw)
        else:
            # the label table scales with the tile as the fused route's does
            kw["label_capacity"] = max(cfg.extract.cell_capacity * 2 * tile_scale, 1024)

            def run(kw):
                return tiled_extract_cells(seg_t, green_t, self.mesh,
                                           threshold_percentile=cfg.seg.threshold_percentile,
                                           norm_pmin=cfg.seg.norm_pmin,
                                           norm_pmax=cfg.seg.norm_pmax, **kw)
        tiled = run(kw)
        if tiled.raster_overflow:
            print("  tiled segmentation overflow -> exact-twin re-run")
            seg_cfg = dataclasses.replace(seg_cfg, raster_mode="scatter", nms_max_pairs=None)
            tiled = run(kw)
        if tiled.cell_overflow:
            print("  tiled cell_capacity overflow -> 4x re-run")
            kw["cell_capacity"] *= 4
            tiled = run(kw)
        if tiled.raster_overflow:
            print("  WARNING: segmentation overflow persists after the exact-twin re-run — "
                  f"max_candidates ({seg_cfg.max_candidates}) likely binds; raise "
                  "SegConfig.max_candidates")
        if tiled.cell_overflow:
            print(f"  WARNING: cell_capacity still binds at {kw['cell_capacity']}/tile — cells "
                  "were dropped; raise ExtractConfig.cell_capacity")
        return tiled

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
                pend = score_frames_fused_start(*self._scoring, segs, greens, seg_fn,
                                                mesh=self.mesh, **kwargs)
            in_flight.append((pend, list(pend_idx)))
            pend_frames.clear()
            pend_idx.clear()
            while len(in_flight) > 1:
                drain()

        def screen_plate(seg, green, file_idx):
            with self.timer.stage("score_frames"):
                tiled = self.score_tiled(seg, green)
                valid = tiled.valid.cpu().numpy()
                scores = compute_anomaly_scores(
                    *self._scoring, shard_batch(self.mesh, tiled.cells), valid=valid,
                    min_votes=self.config.ensemble.min_votes)
            if scores:
                all_scores.append(scores)
                all_stats.append(dict(file_index=np.full(int(valid.sum()), file_idx),
                                      mean_intensity=tiled.mean_intensity.cpu().numpy()[valid]))

        stream = FrameStream(tif_files)
        for path, seg, green in stream:
            frame_names.append(os.path.basename(path))
            if self.tiled_route(seg.shape):
                screen_plate(seg, green, len(frame_names) - 1)
                continue
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
        counted = counters()
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
        print(counters_report(counters(since=counted)))
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
