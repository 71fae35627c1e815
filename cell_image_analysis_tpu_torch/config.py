"""Configuration of the port.

The dataclasses of `cell_image_analysis_tpu/config.py` with the same
fields and defaults (a test holds them field for field), the artifact file
names and the output-file contract.  Left out: `SegConfig`'s TPU knobs
(`unet_dtype`, `unet_precision`, `unet_lvl0_*`, `unet_wb16`, `unet_hilo`,
`unet_winograd`): the port's U-Net always runs float32 3x3 convs through
the Winograd kernel.  `ShardingConfig` is copied as it is: the JAX package
reads none of its fields, and neither does the port (its mesh is an
argument, `parallel.mesh`; the plate tiler's switch is
`ExtractConfig.tile_min_side`).  `CellposeConfig` is the port's own (the
JAX package has no Cellpose backend): `SegConfig.backend == "cellpose"`
selects it, and `SegConfig` and `PipelineConfig` keep JAX's fields.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class QCConfig:
    """Cell quality-control gates; the intensity gates apply to the raw
    analysis-channel bbox crop."""

    border_margin: int = 10          # bbox must be >= 10 px from every frame edge
    min_area: int = 200              # label-region pixel count
    max_area: int = 8000
    max_eccentricity: float = 0.95   # from central moments (skimage semantics)
    min_mean_intensity: float = 0.5  # raw bbox-crop mean
    min_std_intensity: float = 0.1   # raw bbox-crop std (population, ddof=0)


@dataclass(frozen=True)
class CLAHEConfig:
    """Contrast-limited adaptive histogram equalization (skimage
    `equalize_adapthist(cell, clip_limit=0.02)` defaults)."""

    clip_limit: float = 0.02
    nbins: int = 256
    grid: int = 8                    # tiles per axis = shape // (shape // grid)
    nr_of_gray: int = 2 ** 14        # internal quantization (skimage NR_OF_GRAY)


@dataclass(frozen=True)
class ExtractConfig:
    """Capacities of the per-frame extraction: fixed-size buffers with
    validity masks."""

    cell_capacity: int = 512         # max QC-passing cells kept per frame
    crop_capacity: int = 192         # max bbox side; area <= 8000 & ecc <= 0.95 bounds this
    out_size: int = 64               # resize target (64, 64)
    tile_min_side: int = 2048        # with a mesh, frames at least this on both sides are tiled


@dataclass(frozen=True)
class SegConfig:
    """StarDist-style segmentation settings (pretrained `2D_versatile_fluo`:
    32 rays, grid 2, U-Net depth 3 / 32 base filters / 128-channel head,
    prob threshold ~0.479, NMS 0.3)."""

    n_rays: int = 32
    grid: Tuple[int, int] = (2, 2)
    unet_depth: int = 3
    base_filters: int = 32
    head_filters: int = 128
    prob_thresh: float = 0.479071
    nms_thresh: float = 0.3
    max_candidates: int = 1024       # top-K candidate cap per frame
    nms_metric: str = "iou"          # "iou" | "ios" (intersection over smaller)
    nms_max_pairs: int | None = 8192  # sparse-NMS pair budget; overflow is reported
                                     # (None, the exact twin's: every candidate pair)
    raster_patch: int = 128          # scatter rasterizer's patch side
    raster_cap: int = 0              # >0: render only the top-N kept polygons
    raster_mode: str = "tiled"       # "tiled" | "scatter"
    raster_tile: int = 64            # tiled mode: tile side
    raster_m_cap: int = 8            # tiled mode: polygons a tile may hold
    norm_pmin: float = 3.0           # percentile normalization of the seg channel
    norm_pmax: float = 99.8
    backend: str = "stardist"        # "stardist" | "threshold" | "cellpose" ("cellpose_sam")
    threshold_percentile: float = 90.0


@dataclass(frozen=True)
class CellposeConfig:
    """Cellpose's segmentation (MouseLand/cellpose: Cellpose 3's `cyto3`
    CPnet or Cellpose 4's `cpsam` ViT, and `dynamics.compute_masks` at
    their defaults), the port's third backend (`SegConfig.backend ==
    "cellpose"`); the JAX package has none.  The channels are the frame,
    then zeros (CPnet's 2, the ViT's 3), and the rescale is 1 (no diameter
    rescale); the network and its widths are those of its weights
    (`models.cellpose.nbase_of`, `models.vit_sam.widths_of`)."""

    tile: int | None = None          # bsize of run_net's tiles; None: the network's own
                                     # (CPnet's 224, the ViT's 256)
    tile_overlap: float = 0.1
    niter: int = 200                 # Euler steps of the flow following
    cellprob_threshold: float = 0.0
    flow_threshold: float = 0.4      # flow-error QC; 0 turns it off
    min_size: int = 15               # fill_holes_and_remove_small_masks
    max_size_fraction: float = 0.4   # get_masks drops masks above it
    tile_chunk: int = 576            # tiles a network call: CPnet's on a batch of 16
                                     # 1024^2 frames (the ViT's cell runs 100)
    norm_pmin: float = 1.0           # normalize99
    norm_pmax: float = 99.0


# Capacities are tuned for frames up to 1024^2; a larger frame scales them.
# The screener, its plate tiler and the bench's plate rows share this rule.
def capacity_scale(h: int, w: int) -> int:
    """Frame-area multiple of the 1024^2 tuning (>= 1): cell, label and
    candidate capacities grow by it."""
    return max(1, -(-(h * w) // (1024 * 1024)))


def row_scale(w: int) -> int:
    """Row-width multiple of 1024 (>= 1): the runs-per-row cap grows by
    it, since a row's runs grow with its width."""
    return max(1, w // 1024)


def scaled_seg_config(cfg: SegConfig, scale: int) -> SegConfig:
    """`cfg` with K, the raster cap (K where unset) and the NMS pair budget
    times `scale` (`capacity_scale`)."""
    if scale == 1:
        return cfg
    return dataclasses.replace(cfg, max_candidates=cfg.max_candidates * scale,
                               raster_cap=(cfg.raster_cap or cfg.max_candidates) * scale,
                               nms_max_pairs=cfg.nms_max_pairs * scale)


@dataclass(frozen=True)
class CAEConfig:
    """Convolutional autoencoder: 64x64x1 -> 8x8x32 latent -> 64x64x1."""

    input_size: int = 64
    encoder_filters: Tuple[int, ...] = (32, 64, 32)
    decoder_filters: Tuple[int, ...] = (32, 64, 32)
    latent_hw: int = 8
    latent_channels: int = 32
    learning_rate: float = 1e-3
    bn_momentum: float = 0.99        # Keras BatchNormalization default
    bn_epsilon: float = 1e-3         # Keras BatchNormalization default
    adam_eps: float = 1e-7           # Keras Adam default epsilon

    @property
    def latent_dim(self) -> int:
        return self.latent_hw * self.latent_hw * self.latent_channels  # 2048


@dataclass(frozen=True)
class AugmentConfig:
    """Training augmentation (Keras ImageDataGenerator arguments)."""

    rotation_range: float = 2.0      # degrees
    width_shift_range: float = 0.02  # fraction of width
    height_shift_range: float = 0.02
    zoom_range: float = 0.02
    horizontal_flip: bool = True
    vertical_flip: bool = True
    fill_mode: str = "nearest"


@dataclass(frozen=True)
class TrainConfig:
    """Training loop and callbacks."""

    batch_size: int = 32
    epochs: int = 100
    val_split: float = 0.2
    seed: int = 42
    min_cells: int = 500             # abort threshold
    early_stop_patience: int = 10
    early_stop_min_delta: float = 0.0
    reduce_lr_factor: float = 0.5
    reduce_lr_patience: int = 5
    reduce_lr_min_lr: float = 1e-6
    reduce_lr_min_delta: float = 1e-4


@dataclass(frozen=True)
class DetectorConfig:
    """Feature pipeline and one-class SVM detectors."""

    pca_components: int = 100        # actual = min(100, n_feat, n_samples - 1)
    nu_conservative: float = 0.05
    nu_moderate: float = 0.10
    gamma: str = "scale"             # 1 / (n_features * X.var())
    svm_tol: float = 1e-3            # libsvm default stopping tolerance


@dataclass(frozen=True)
class FFTConfig:
    """Per-cell 2D-FFT spectral features."""

    radial_bins: int = 16
    angular_bins: int = 8
    log_power: bool = True


@dataclass(frozen=True)
class EnsembleConfig:
    """Ensemble combiner.  Votes: recon-MSE over its training 95th
    percentile, conservative SVM flag, moderate SVM flag."""

    enabled: bool = True
    mse_percentile: float = 95.0     # recon-error vote threshold (training set)
    min_votes: int = 2               # majority of the three votes


@dataclass(frozen=True)
class TriageConfig:
    """Screening-report triage thresholds."""

    expected_normal_conservative: float = 0.05
    expected_normal_moderate: float = 0.10
    high_conservative: float = 0.15
    high_moderate: float = 0.25
    normal_conservative: float = 0.10


@dataclass(frozen=True)
class ShardingConfig:
    """Multi-device execution."""

    data_axis: str = "data"
    # Halo width for spatial frame tiling: U-Net receptive field plus the
    # 10 px QC border margin.
    halo: int = 64
    tile_frames: bool = False        # enable spatial tiling for >=4096^2 frames
    tile_threshold: int = 4096


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration bundling every subsystem."""

    qc: QCConfig = field(default_factory=QCConfig)
    clahe: CLAHEConfig = field(default_factory=CLAHEConfig)
    extract: ExtractConfig = field(default_factory=ExtractConfig)
    seg: SegConfig = field(default_factory=SegConfig)
    cae: CAEConfig = field(default_factory=CAEConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    fft: FFTConfig = field(default_factory=FFTConfig)
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    triage: TriageConfig = field(default_factory=TriageConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    seed: int = 42

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# The artifact contract: the files training writes and screening reads.
ARTIFACT_BEST_AUTOENCODER = "best_autoencoder.keras"
ARTIFACT_FINAL_AUTOENCODER = "final_autoencoder.keras"
ARTIFACT_ENCODER = "encoder.keras"
ARTIFACT_SCALER = "scaler.pkl"
ARTIFACT_PCA = "pca.pkl"
ARTIFACT_DETECTOR_CONSERVATIVE = "detector_conservative.pkl"
ARTIFACT_DETECTOR_MODERATE = "detector_moderate.pkl"

# Report/CSV/plot output contract.
OUTPUT_FILES_TRAINING = (
    "cell_statistics.csv",
    "file_summary.csv",
    "data_quality_report.txt",
    "training_history.png",
    "reconstruction_error_distribution.png",
    "reconstruction_samples.png",
    "training_report.txt",
)
OUTPUT_FILES_SCREENING = (
    "screening_summary.csv",
    "detailed_cell_results.csv",
    "anomaly_rates_comparison.png",
    "mse_distributions.png",
    "correlation_matrix.png",
    "mutant_screening_report.txt",
)
