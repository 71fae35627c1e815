#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one GPU

Phases (any failure exits non-zero before the last line is printed):

0. environment: the GPU's name and power limit, nvcc, torch/CUDA/triton
   versions, CUTLASS headers; no GPU -> exit 1 at once, no CPU run;
1. build `cell_image_analysis_tpu_torch/csrc/*.cu` with nvcc (sm_90a);
2. each hand-written kernel against its plain PyTorch version on the card
   at main-path shapes, with the kernel's device time (torch.profiler over
   20 launches), an event-timed wrapper call, the plain version's time,
   the one PyTorch call that computes the same function where there is
   one, and the bound (the least time the card could take: bytes over
   3.35 TB/s or operations over their peak, H100 SXM published figures):
   Winograd conv at all 13 U-Net layers, B = 16, with the output ReLU the
   U-Net launches: max|y - ref| / max|ref| < 1e-5 and bit for bit the
   plain instance's output after `torch.relu_`, its row summed over
   Conv_1, Conv_7 and Conv_8, library call cuDNN fp32; at CPnet's 32 convs
   (the committed Cellpose weights on 576 random 224^2 tiles, the
   BatchNorm, style and ReLU as the input prologue the network launches),
   each within 1e-5 with its device time, its bound and the plain
   instance's device time on the input activated beforehand (the row's
   `cpnet_*` keys); segment sum on the 16 frames' run table (524,288 x 6):
   equal, library call `index_add_`; the fused CLAHE kernel on 32 random
   cells at each bucket capacity, on the main path's own size buckets
   (StarDist stage A of the 16 frames; its row sums these) and on the
   threshold path's (the threshold backend's stage A; the row's
   `threshold_*` keys): bit-equal; `label_components` (the tile CC kernel, compaction
   included) on the 16 frames' threshold masks at connectivity 1 and 2:
   labels and counts equal to `label_components_plain`, with the eager
   compaction that the parent ran after its kernel timed for the record;
   then on 1024^2 structural masks (all-true, a full-frame serpentine,
   random at 0.59 density) at connectivity 1 and 2: equal to labels
   derived from `scipy.ndimage.label` on the host; the device time of
   CC and Winograd at the shapes of phase 12's haloed tiles; the radix
   select (`kth_smallest`) on the 16 frames at the normalization's 4
   ranks and the threshold's 6, bit-equal to its plain version and to
   torch.kthvalue (the library call); the flow following kernel
   (`csrc/follow_flows.cu`, Cellpose's 200 steps) on (16, 2, 1024, 1024)
   flows made from the 16 frames' StarDist labels: within 1e-4 px of its
   plain version, every pixel truncated alike; the ViT attention kernel
   (`csrc/vit_attention.cu`) at Cellpose-SAM's batch, 100 tiles x 16
   heads of 1,024 tokens (random q, k, v and bias terms): within 1e-5 of
   the largest output of the plain materialised form computed in float64
   (the float32 plain form's own error printed beside it), its bound from
   the benchmark's `attention_work` rule; the ViT linear kernel
   (`csrc/vit_linear.cu`) at the four block linears of Cellpose-SAM's
   batch (M = 102,400 rows; (K, N) of qkv, proj, lin1 and lin2, random x,
   W and bias): each within 2x cuBLAS float32's max |error| against the
   product in float64 on the same inputs, its device time summed over the
   four (a block's), its bound (3 x 2MNK at the TF32 peak, the 1xTF32 time
   beside it) and cuBLAS float32 as the library call; and, with phase 16, at the 4096^2
   plate row's shapes: Winograd's Conv_1 on (2, 4096, 4096, 32 -> 32)
   within 1e-5 of cuDNN, segment sum, CLAHE and the select (4 ranks) on
   the row's first batch (its frames made by a worker process that starts
   with the smoke) bit-equal (every profiler time of the run is taken
   here);
3. the main path — StarDist screening of the bench's 16 synthetic
   1024^2 frames (made once, on the host, for phases 2, 3, 5 and 6)
   through `score_frames_fused`, run twice; the launch counts of the
   second run must all be > 0, CLAHE at most once a non-empty size bucket,
   and no overflow flag may fire;
4. the port on the GPU against the port on the CPU on one 512^2 frame,
   StarDist, the threshold backend and its exact twin: identical cell sets, predictions
   and scores within 1e-4, except what `utils.parity` allows and lists
   (label pixels within 1e-3 px of a polygon boundary, decisions within
   1e-4 of their threshold);
5. threshold screening of the 16 frames at the bench's threshold
   settings: (a) the threshold backend (CC kernel, run-length
   regionprops) with its exact twin as fallback, run twice, the second
   timed; (b) the twin alone (CC kernel, pixel regionprops); (c) the
   backend at rcap 8, whose fallback must fire once.  (a) and (b) give the
   same cells, areas and predictions, scores within 1e-4; (c) equals (b)
   exactly.  The counts are set to 0 before each run and read after it:
   (a) and (b) launch the CC kernel (one call a batch, each
   `ops.cuda.cc.KERNELS_PER_CALL` launches; (a)'s is its row's count),
   segment sum and CLAHE (at most once a size bucket), and (c) twice as
   many CC calls as (b) (the backend's and the twin's);
6. the StarDist exact twin (scatter rasterizer, K^2 NMS pairs, pixel
   regionprops) on the 16 frames: phase 3's cells, areas and scores
   within 1e-4, except the listed cells of polygons that the scatter
   rasterizer clips to its patch; then a run at an NMS budget of 64
   pairs must fall back to the twin and equal it;
7. screening from files at full width: four sample folders of synthetic
   TIFFs (`wildtype`, 40 frames of 1024^2, so batches of 16, 16 and 8 with
   two in flight; `mutantA`, 8 frames and a corrupt file; `odd`, 2 frames
   of 1004 x 1020; `empty`), written in worker processes while phases 1-3
   run, go through `ProductionMutantScreening(assets/screening_store_synthetic,
   PipelineConfig())` with the bundled U-Net at the default capacities.
   The three samples with cells come back, the skip messages are printed,
   the output files exist (the three figures only where matplotlib is
   installed: without it the screener is told to leave them out, which the
   log says),
   per-file counts sum to `total_cells`, and `wildtype`'s scores equal, bit
   for bit, `score_frames_fused` called on the same decoded frames in the
   same three batches; Winograd, segment sum and CLAHE were launched.
   Those direct calls, and one on `odd`, run with every call of a kernel's
   wrapper held against the kernel's plain version on the same tensors
   (`_HeldAgainstPlain`), so each kernel is checked at the screener's own
   shapes, which are not phase 2's: B = 16, 8 and 2, frames padded to
   1008 x 1024, label capacity 1024, 16 x 512 crop slots, the exact twin's
   pixel-regionprops table.  Cells/s, the stage report and the TIFF decode
   seconds of the timed run are printed, and the host waits inside
   `score_frames_fused_start`, counted in a second pass over `wildtype`;
8. the threshold screener on 16 of those frames; the same 16 frames
   through `score_frames_fused` and `extract_quality_cells` on one frame
   with each backend, again with every kernel call held against its plain
   version (the threshold backend's goes through the CC kernel), and
   `extract_quality_cells` on the card against the same call on the CPU;
9. `python -m cell_image_analysis_tpu_torch.cli screen` in a subprocess on
   `mutantA` (exit 0, summary CSV), and on a model directory that does not
   exist (exit code not 0);
10. training on the card: `ImprovedAnomalyDetectionTraining` on phase 7's
   `wildtype` folder (40 frames of 1024^2, so five extraction batches of
   8) at `PipelineConfig()` defaults but `TRAIN_EPOCHS` epochs, no
   figures, the CAE at full width (32/64/32).  The counts are set to 0
   before the timed run and read after it (each kernel's
   `training_launches`; Winograd, segment sum and CLAHE must be > 0); the
   store's ten files and the four CSV and report files must exist, and the
   port's screener must load the store and screen `mutantA`.  Then the
   five batches are extracted again with every kernel call held against
   its plain version (`_HeldAgainstPlain`: B = 8, label capacity 1024, 8 x
   512 crop slots, the exact twin's pixel table) and must give the timed
   run's cells.  Card against CPU: (a) two frames cut to 512^2 through
   `extract_batch`: the same cells, those of equal area within TOL, at most
   2 whose area differs (label pixels at a polygon's knife edge); (b) one
   epoch of `fit_cae` on 512 of the extracted cells, augmentation off, each
   from the init that `fit_cae` draws on the CPU for either device: each
   history value within `TRAIN_RTOL`.  Printed: the `StageTimer` stages, extraction cells/s,
   training images/s, detector-fit seconds (SMO included), the solidity
   loop's seconds and peak device memory, with the `nvidia-smi` line;
11. U-Net training on the card, at full width (depth 3, 32 base filters,
   32 rays, 128 head filters, grid 2) with the recipe of the committed
   `assets/unet_synthetic.pkl` (`make_unet_weights.py --dense`: 8 crowded
   256^2 frames with their true instance labels, 400 full-batch epochs at
   lr 3e-3) from the port's own init.  The host ground truth is timed;
   three steps run with every Winograd wrapper call held against
   `F.conv2d` (forward and the data gradient, 1e-5), counted forward and
   backward apart; 20 event-timed steps give ms a step (median), images/s
   and peak memory.  Then `train.unet_trainer.fit_unet` trains, the counts
   set to 0 before and read after (`unet_training_launches`; Winograd must
   be > 0), and the loss at epochs 0, 10, ... and the last is printed.
   Gates: the last loss below half the first; the self-check of
   `scripts/make_unet_weights.py` (`predict_instances` at max_candidates
   256, raster patch 96, on the `default_rng(999)` frame): coverage >= 0.5
   and |n_pred - n_true| <= 2 (JAX's own run of the recipe read 0.709, 9
   of 10); the written payload, loaded by `load_unet_variables` into a
   `StarDistBackend`, segments that frame to the in-memory module's
   labels; card against CPU on 2 frames from one init: 10 steps each, loss
   histories within `UNET_RTOL`, and at each of the CPU's 10 points the
   card's loss and each leaf's gradient from the CPU's weights
   (`UNET_LOSS_RTOL`, `UNET_GRAD_RTOL`: the data gradient through the
   kernel).  Printed beside the `nvidia-smi` line;
12. the mesh and plates: a mesh of 4 shards (`parallel.mesh`), one GPU a
   shard where the machine has 4, else all on cuda:0 (a virtual mesh: every
   line of the mesh path runs except the copies between distinct cards;
   the phase prints which, and the device count).  Every kernel call is
   held against its plain version (`_HeldAgainstPlain`) and the counts are
   set to 0 before each route and read after it; each route must launch
   its kernels.  (a) the 16 frames through `score_frames_fused(mesh=)`,
   StarDist at phase 3's settings and threshold at phase 5 (a)'s, against
   the same calls without a mesh: frame_index, label ids, areas,
   predictions and rates equal, scores within 1e-5
   (tests/test_sharded_scoring.py's contract); (b) `tiled_extract_cells`
   on a 2048^2 plate of 320 cells (`make_plate`, halo 192, 256 cells a
   tile), scored on the mesh, against the fused threshold path on the
   whole plate: the same number of cells, > 20, sorted areas equal, sorted
   MSE within 1e-6, rates equal (tests/test_tiling_pipeline.py); (c) `tiled_extract_cells_stardist`
   on a 2048^2 plate of 128 cells with the bundled U-Net at capacities
   where no flag fires and no cap binds (16,384 candidates, more than the
   plate's grid pixels above the prob threshold, which it counts; scatter
   rasterizer, every NMS pair), the same contract (`TILED_MSE_GATE`); (d)
   a 4096^2 plate of 1280 cells as a TIFF through `ProductionMutantScreening` at `PipelineConfig()` but
   `tile_min_side` 2048, on the mesh (the tiled route) and on one device
   (the whole frame): each route's grid pixels above the prob threshold
   against its top-K, a held first run, then a timed one; wall seconds,
   peak device memory, cells, the re-runs through the exact twin and the
   launches of each route; (e) `fit_cae(mesh=)` against `fit_cae` on one
   device from the same init, 3 epochs of phase 10's cells (without phase
   10: the 16 frames') at batch 32; `fit_cae` runs cuDNN's deterministic
   algorithms (a second single-device run must equal the first).  The free
   float32 runs drift apart as Adam and the batch statistics amplify the
   sums' order; their gaps are printed, not gated.  Gates: float64 free
   runs over the same batches on PyTorch's own convolutions, mesh against
   one shard, losses and weights within `F64_LOSS_GATE` and
   `F64_WEIGHT_GATE` (the same runs on cuDNN are printed beside them, not
   gated: `F64_LOSS_GATE`'s note); each float32 step from the one-device run's weights, the
   loss, the gradient and each leaf's within `STEP_*_GATE`, the first
   step's BatchNorm statistics within `BN_STATS_GATE`; and fit_cae on
   tests/test_sharded_training.py's workload (80 cells, batch 16) at its
   gates (histories 2e-3, weights 2e-2).  (Phase 2 times CC and Winograd
   at the haloed tiles' shapes.)  `--phases 0,1,12` runs it
   alone (exit 1: no result line);
13. the port's bench and parity harness (`utils/bench.py`,
   `utils/parity.py`): (a) `run_bench` for each backend at the bench's full
   workload, 48 frames of 1024^2 (made from seed 7 by a worker process
   that starts with the smoke; its first 16 are phase 3's frames) in 3
   batches of 16 all started before the first wait, two warm-ups, best of
   2, the counts set to 0 before each and read after (each path's kernels
   must launch); no batch may fall back to the exact twin (the count is
   printed), nor may the held batch below; the pending handles' and the
   peak device memory are printed; then the first batch again through the
   bench's pipeline with every kernel call held against its plain version
   (`_HeldAgainstPlain`), StarDist's equal to phase 3's result: the same
   cells and areas, scores within TOL; (b) `run_train_bench`, 2,048 cells,
   12 epochs; (c) `measure_parity` on the three workloads of JAX's
   tests/test_parity.py (threshold, 4 x 512^2, 30 cells, seed 11; the same
   with `fit_on_extracted`; StarDist, 2 x 512^2, 24 cells, seed 13), each
   with equal cell counts and a max anomaly-rate deviation below
   PARITY_GATE, the `fit_on_extracted` one with a rate in (0, 0.9); (d)
   `python -m cell_image_analysis_tpu_torch.cli bench` (started before
   (c): it makes its 8 frames while (c) runs) and `python bench_torch.py
   --mode train` in subprocesses at their defaults, each exit 0 with one
   JSON line.  The bench's JSON lines and the parity dicts
   are printed with the `nvidia-smi` line.  `--phases 0,1,13` runs it
   alone (exit 1: no result line; the first batch is then not compared
   with phase 3);
14. the multi-process runtime (`parallel/distributed.py`) through
   `scripts/dryrun_dist_torch.py`: its 2 fresh interpreters joined
   by `torch.distributed` with gloo, all on cuda:0 (NCCL refuses two ranks
   on one GPU), each with a virtual mesh of `DIST_LOCAL_SHARDS` shards of
   one global mesh.  (a) StarDist: phase 3's 16 frames at phase 3's
   settings, each process screening its 8 through `score_frames_fused`
   (a warm-up run, then a timed one, the counts set to 0 between them): the
   result that every process holds (all-gathered, global frame indices)
   equals phase 3's under the sharded contract (frame_index, label ids and
   areas equal, scores within 1e-5, predictions and rates equal; without
   phase 3 the same call is made here first), and each worker launched the
   Winograd, segment-sum and CLAHE kernels; (b) the threshold backend
   at the size of JAX's `scripts/dryrun_dcn.py` (8 frames of
   128^2, 4 cells each) and its three checks, each worker against its own
   single-process run: masked counts, the detectors' counts of 64 cells,
   `score_frames_fused` (the CC kernel too).  The workers' wall seconds,
   peak memory and launches are printed with the `nvidia-smi` line.
   `--phases 0,1,14` runs it alone (exit 1: no result line);
15. the train round trip, card against CPU (JAX's
   `scripts/parity_train_onchip.py`): `ROUND_TRIP`'s synthetic training
   frames, StarDist extraction, `fit_cae` with the augmentation on, the
   detector fits, the store written and read back by the screener, which
   screens a wildtype and a mutant folder; once on the card and once on
   the CPU, from the same seeds, with no monkeypatch.  Gates: (a) the
   extraction: equal cell counts, at most 2 cells of other area, the rest
   within TOL; (b) float64 free runs over `fit_cae`'s batches and draws,
   card against CPU: losses within `F64_LOSS_GATE`, weights within
   `F64_WEIGHT_GATE`, and the first batch warped on the card equal to the
   CPU's bit for bit; (c) every float32 step from the CPU run's weights:
   the loss and each leaf's gradient within `STEP_*_GATE`; (d) the two
   float32 `fit_cae` runs stop at the same epoch with the same lr history
   (else both histories are printed).  The two stores' screening rates are
   printed side by side, not gated (JAX's rate band is vacuous), with the
   phase's seconds.  `--phases 0,1,15` runs it alone;
16. JAX's plate-scale rows (scripts/bench_2048.py: 12 frames of 2048^2,
   320 cells; scripts/bench_4096.py: 4 frames of 4096^2, 1,280 cells;
   made by worker processes) through `utils/bench.run_device_bench` at
   `scripts/bench_*_torch.py`'s defaults: batches of 2, all started
   before the first wait, two warm-ups, best of 2, at
   `plate_settings(size)` (the capacities scaled with the frame's area),
   the counts set to 0 before each row and read after (Winograd, segment
   sum and CLAHE must launch; each kernel's launches a batch are
   printed); cells/s, frames/s, Mpx/s, pending and peak memory and the
   batches that fell back to the exact twin (printed, not an error);
   each frame's geometry-passing labels in the timed run against the
   cell capacity (a frame that reaches it fails the phase) and, in a
   second pass through the row's backend, the instances against
   the planted cells (`scripts/probe_plate_cells.py`'s method: found,
   missed); then the row's first batch through the bench's pipeline with
   every kernel call held against its plain version (`_HeldAgainstPlain`).
   `--phases 0,1,16` runs it alone (exit 1: no result line; without phase
   2 the kernels are not timed at the row's shapes);
17. the Cellpose backend's main path: `CellposeBackend` at
   `CellposeConfig()` over `benchmark/data/cellpose_synthetic.npz` (CPnet
   at nbase 2-32-64-128-256, 576 224^2 tiles in one call, 200 steps)
   screening the 16 frames through `score_frames_fused_start` / `_wait`
   at phase 3's capacities, a warm-up, then a run with the counts set to 0
   just before and read after: the flow following, Winograd, the select,
   segment sum, CLAHE and CC must each launch, no batch may fall back to
   the exact twin, and the cells pass `_check_result`; cells/s and peak
   memory are printed.  The warm-up runs with every kernel call held
   against its plain version (`_HeldAgainstPlain`; each of CPnet's 32
   convs with its input prologue at 1e-5).  `--phases 0,1,17` runs it
   alone (exit 1: no result line);
18. the Cellpose backend with Cellpose-SAM's ViT: `CellposeBackend` over
   `benchmark/data/cellpose_sam_synthetic.npz` (ViT-L at its published
   widths, 100 256^2 tiles in one call, as the benchmark's cell) screening
   the first 4 of the 16 frames through `score_frames_fused_start` /
   `_wait`, a warm-up with every kernel call held against its plain
   version (each of the 24 attention calls within 1e-5 of the largest
   output of the plain form in float64: on the card the float32 plain
   form itself reads up to ~1e-5 from it at these activations, the
   kernel ~3.5e-6; each of the 96 linear calls within 2x cuBLAS
   float32's max |error| against the product in float64 on the same
   activations), then a run with the counts set to 0 just
   before and read after: the attention kernel must launch once a block
   and the linear kernel four times a block in each, and the kernels of phase 17 must launch, no batch may fall
   back to the exact twin, and the cells pass `_check_result`; cells/s
   and peak memory are printed.  `--phases 0,1,18` runs it alone (exit 1:
   no result line);
19. a JSON line with each kernel's numbers, the `nvidia-smi` name/power
   line, and the final `{"ok": true, "device": {...}}` line.

It imports no JAX.  Needs the rest of the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "cell_image_analysis_tpu_torch"
WINO_LAYERS = {  # the U-Net's 13 3x3 convs on the bench's 16 frames: (B, H, W, Ci, Co)
    "Conv_0": (16, 1024, 1024, 1, 32), "Conv_1": (16, 1024, 1024, 32, 32),
    "Conv_2": (16, 512, 512, 32, 64), "Conv_3": (16, 512, 512, 64, 64),
    "Conv_4": (16, 256, 256, 64, 128), "Conv_5": (16, 256, 256, 128, 128),
    "Conv_6": (16, 128, 128, 128, 256), "Conv_7": (16, 128, 128, 256, 256),
    "Conv_8": (16, 256, 256, 384, 128), "Conv_9": (16, 256, 256, 128, 128),
    "Conv_10": (16, 512, 512, 192, 64), "Conv_11": (16, 512, 512, 64, 64),
    "Conv_12": (16, 512, 512, 64, 128),
}
WINO_ROW = ("Conv_1", "Conv_7", "Conv_8")  # the kernels row's ms sum these three
CLAHE_CAPS = ((64, 12), (96, 12), (192, 16))  # bucket capacity, ns_cap
TOL = 1e-4  # GPU-vs-CPU score tolerance, and the near-threshold band
H100_HBM_BYTES_S = 3.35e12  # H100 SXM published peaks (NVIDIA data sheet), at 700 W
H100_TF32_FLOPS = 495e12
# utils/bench.py:250-253, the threshold backend's screening settings
THRESH_KW = dict(chunk=32, caps=(64, 96), label_capacity=4096, cell_capacity=128,
                 fg_fraction=0.12)
N_BUCKETS = 3  # caps 64 and 96, and the full crop capacity
ALL_PHASES = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18}
TRAIN_EPOCHS = 5  # phase 10's epochs (the CAE's width is never cut)
# phase 11: the recipe of assets/unet_synthetic.pkl (scripts/make_unet_weights.py
# --dense: 8 crowded frames of 256^2, 400 full-batch epochs at lr 3e-3), at
# full width; its self-check read 9 of 10 instances and coverage 0.709 in JAX
UNET_EPOCHS, UNET_FRAMES, UNET_SIZE, UNET_LR = 400, 8, 256, 3e-3
UNET_TIMED_STEPS = 20      # event-timed steps (median) after the 3 held ones
UNET_CPU_STEPS = 10        # card against CPU, 2 frames, one init
# (a) their free-running loss histories, relative: the loss spikes at the
# third step (lr 3e-3 from a fresh init), which amplifies float32
# reassociation about 3x a step: 2.405e-3 to 2.407e-3 at the tenth step in
# four runs on an H100 80GB HBM3 at 700 W (the first two steps agreed
# within 3e-6), so the gate is 1e-2, not 1e-3; (b) holds each step without
# that amplification: the card's loss and gradients from the CPU's weights
UNET_RTOL = 1e-2
UNET_LOSS_RTOL = 5e-5      # (b) the loss, relative (6.883e-6 at most in those runs)
UNET_GRAD_RTOL = 5e-4      # (b) each leaf's gradient, of its norm (the CPU tests' gate;
                           # 1.384e-4 at most in those runs)
# phase 10 (b): one epoch card against CPU from one init; cuDNN and the
# CPU's convolutions sum in other orders, and the batch-statistics
# BatchNorm and Adam carry that through 12 steps: at most 2.36e-4, 2.17e-4
# and 2.13e-4 in three runs on an H100 80GB HBM3 at 700 W
TRAIN_RTOL = 1e-3
STORE = os.path.join(REPO, "assets", "screening_store_synthetic")
# phase 7's sample folders: (name, frames, seed, mutant_fraction, crop)
SAMPLES = (("wildtype", 40, 21, 0.0, None), ("mutantA", 8, 22, 0.7, None),
           ("odd", 2, 23, 0.0, (1004, 1020)))
CHUNK_FRAMES = 8  # frames a worker process writes
FRAME_SIZE, FRAME_CELLS = 1024, 80  # phase 7's frames, as the bench's
# phase 12: the mesh's shards (distinct GPUs where there are as many, else
# all on cuda:0), the plates (side, cells, seed) of (b), (c) and (d), the
# tiles' halo (the crop capacity, a multiple of the U-Net's pooling grid),
# and (e)'s workload
MESH_SHARDS = 4
TILE_PLATE = (2048, 320, 31)
STARDIST_PLATE = (2048, 128, 33)
BIG_PLATE = (4096, 1280, 32)
MESH_HALO = 192
MESH_TRAIN_EPOCHS = 3   # (e): tests/test_sharded_training.py's epochs, on phase 10's cells
MESH_TRAIN_CELLS, MESH_TRAIN_BATCH = 80, 16   # and that test's own workload
# (e)'s gates.  float64 free runs, mesh against one shard, the relative
# loss at every step and the weights at the end, on PyTorch's own
# convolutions: 6.6e-15 and 1.4e-14 after 78 steps of 842 cells on the
# CPU, 2.3e-14 and 8.6e-13 after 249 steps of 3,322 on an H100 80GB HBM3
# at 700 W.  (On cuDNN, whose float64 rounding follows the shard's batch
# size, the runs are ~1e-12 apart in the weights by step 7; at step 8
# that gap flips the sign of 181 of conv 0's ReLU inputs, which lie
# within it of 0; the flipped pixels move convs.0.bias's gradient by
# 3.9e-5, which Adam, dividing by the root of a running square, turns
# into a 1.1e-1 difference in that leaf's step direction; later flips add
# to it, and after 249 steps the runs are 1.1e-3 (losses) and 3.1e-2
# (weights) apart.  scripts/probe_mesh_f64.py traces it step by step.)
# Per-shard BatchNorm statistics move the first step's loss by 1.5e-4 and
# a run's weights at the 1e-1 level
F64_LOSS_GATE, F64_WEIGHT_GATE = 1e-6, 1e-3
# float32 steps from shared weights: the relative loss, the whole
# gradient's difference over its norm, and each leaf's.  On the CPU (842
# cells, batch 32, 63 steps) right sharding read at most 1.9e-7, 2.0e-3 and
# 1.3e-2; per-shard BatchNorm statistics at least 1.5e-4, 3.4e-2 and 1.8e-1
STEP_LOSS_GATE, STEP_GRAD_GATE, STEP_LEAF_GATE = 1e-5, 1e-2, 5e-2
BN_STATS_GATE = 1e-5    # each shard's (mean, var) against the batch's, of its largest
# (c): sorted reconstruction MSE, tiled against the whole plate
# (tests/test_tiling_pipeline.py's gate)
TILED_MSE_GATE = 1e-6
TILED_MIN_CELLS = 20
# phase 13: the bench's workload (JAX utils/bench.run_bench), and the
# parity harness's three workloads (JAX tests/test_parity.py)
BENCH_FRAMES = 48
PARITY_WORKLOADS = (
    ("threshold", dict(n_frames=4, size=512, n_cells=30, seed=11)),
    ("threshold, fit_on_extracted", dict(n_frames=4, size=512, n_cells=30, seed=11,
                                         fit_on_extracted=True)),
    ("stardist", dict(n_frames=2, size=512, n_cells=24, seed=13, backend="stardist")))
PARITY_GATE = 1e-3      # the largest anomaly-rate deviation (BASELINE.md's north star)
# phase 14: the processes of scripts/dryrun_dist_torch.py, all on cuda:0 with
# gloo (NCCL refuses two ranks on one GPU), each with a virtual mesh of 2
DIST_LOCAL_SHARDS, DIST_TIMEOUT = 2, 600
# phase 17: the Cellpose backend's weights (CPnet trained in the repository,
# scripts/make_cellpose_weights_torch.py) and the kernels its path launches
CELLPOSE_WEIGHTS = os.path.join(REPO, "benchmark", "data", "cellpose_synthetic.npz")
CELLPOSE_KERNELS = ("follow_flows", "winograd_conv3x3", "kthvalue_radix", "segment_sum",
                    "clahe_cells", "cc_tile_labels")
CELLPOSE_TILES = 576   # phase 2: CPnet's tiles a call, `CellposeConfig().tile_chunk`
# phase 18: Cellpose-SAM's weights (scripts/make_cellpose_sam_weights_torch.py),
# the kernels its path launches, and the benchmark cell's batch: 4 frames,
# 100 tiles of 256^2 in one ViT call; phase 2: its attention, 16 heads of 64
# over a 32 x 32 token grid
CELLPOSE_SAM_WEIGHTS = os.path.join(REPO, "benchmark", "data", "cellpose_sam_synthetic.npz")
CELLPOSE_SAM_KERNELS = ("vit_attention", "vit_linear", *CELLPOSE_KERNELS)
CELLPOSE_SAM_FRAMES, CELLPOSE_SAM_TILES = 4, 100
VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM, VIT_GRID = 16, 1024, 64, 32
# phase 2: the blocks' linears, (K, N) of qkv, proj, lin1 and lin2 (ViT-L)
VIT_LINEARS = {"qkv": (1024, 3072), "proj": (1024, 1024), "lin1": (1024, 4096),
               "lin2": (4096, 1024)}
# phase 15: the train round trip of JAX's scripts/parity_train_onchip.py (6
# training frames, 8 epochs) at 512^2 and 50 cells a frame, a few hundred
# cells, so that its CPU half stays near two minutes: frames, side, cells, epochs
ROUND_TRIP = (6, 512, 50, 8)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 7) -> float:
    """Median CUDA-event time of `fn()` over n runs after one warm-up: one
    host-wrapped call between two events, so at tens of microseconds it
    measures the wrapper as much as the kernel."""
    import torch

    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_times(fn, n: int) -> dict:
    """{event name: device microseconds} of n calls of `fn()` under
    torch.profiler, after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.self_device_time_total > 0}


def device_ms(fn, kernels: tuple, n: int = 20) -> float:
    """The device time a call of `fn()` spends in the kernels whose names
    contain one of `kernels`: torch.profiler's device time over n calls
    after one warm-up, divided by n (no wrapper or launch gap in it).
    Fails when the profiler saw none of them.  Every such time is taken in
    phase 2: later in a run, or after an earlier session, the profiler has
    come back without any device activity (PERF.md §6)."""
    times = _device_times(fn, n)
    total = sum(t for key, t in times.items() if any(name in key for name in kernels))
    if not total > 0:
        raise AssertionError(f"torch.profiler saw no device time of {kernels}; it saw "
                             f"{sorted(times.items(), key=lambda kv: -kv[1])[:5]}")
    return total / 1e3 / n


def bound(n_bytes: float, flops: float = 0.0, flop_rate: float = 0.0) -> tuple:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate (H100 SXM
    published peaks), with which of the two sets it."""
    t_bytes = n_bytes / H100_HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3 if flops else 0.0
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def winograd_bound(B: int, H: int, W: int, ci: int, co: int) -> tuple:
    """A Winograd F(2,3) layer at the layer's own Ci and Co (not the
    kernel's padded ones): 16 positions x 2x2 tiles x Ci x Co products,
    2 operations each, three times over at the TF32 tensor-core peak,
    since three TF32 products (3xTF32) are the price of float32 accuracy
    on the TF32 tensor cores; bytes: x read and y written once, U_hi,
    U_lo and the bias read once."""
    tiles = B * -(-H // 2) * -(-W // 2)
    flops = 3 * 2 * 16 * tiles * ci * co
    n_bytes = 4 * (B * H * W * (ci + co) + 2 * 16 * ci * co + co)
    return bound(n_bytes, flops, H100_TF32_FLOPS)


def phase_env(torch) -> None:
    log(f"[0] nvidia-smi: {smi_line()}")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True)
    if nvcc.returncode != 0:
        nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                              capture_output=True, text=True, check=True)
    log(f"[0] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    triton = importlib.util.find_spec("triton")
    triton_v = "not installed"
    if triton is not None:
        import triton as triton_mod

        triton_v = triton_mod.__version__
    log(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton_v}, "
        f"jax {'importable' if importlib.util.find_spec('jax') else 'not installed'}")
    log(f"[0] CUTLASS headers at /usr/local/cutlass/include: "
        f"{os.path.isdir('/usr/local/cutlass/include')}")
    log(f"[0] device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def phase_build() -> float:
    from cell_image_analysis_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[1] built {os.path.relpath(path, REPO)} in {secs:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'reused'})")
    return secs


def stage_a_buckets(torch, segment_fn, segs, greens, candidate_kwargs) -> dict:
    """A path's stage A on the 16 frames, as `score_frames_fused` runs it:
    the candidates' crops (N, 192, 192), heights and widths (N,) and the
    size buckets [(ids, cap, ns_cap)]."""
    from cell_image_analysis_tpu_torch.ops.clahe import size_buckets
    from cell_image_analysis_tpu_torch.ops.extract import stage_a

    with torch.inference_mode():
        cand, _, _ = stage_a(segment_fn, segs, greens, candidate_kwargs)
    B, ccap, full_cap = cand.crops.shape[:3]
    crops = cand.crops.reshape(B * ccap, full_cap, full_cap).float().contiguous()
    heights, widths = cand.heights.reshape(-1).int(), cand.widths.reshape(-1).int()
    buckets = size_buckets(heights, widths, cand.valid.reshape(-1), (64, 96), full_cap)
    return dict(crops=crops, heights=heights, widths=widths, buckets=buckets)


def _clahe_check(torch, crops, ids, hs, ws, cap, ns_cap, what: str) -> dict:
    """The fused CLAHE kernel bit-equal to its plain version on one bucket,
    its device time, the event-timed wrapper call, the plain version's
    time and its bound."""
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, clahe_cells_plain

    idx = ids.long()

    def plain():
        return clahe_cells_plain(crops[idx][:, :cap, :cap], hs[idx], ws[idx], ns_cap=ns_cap)

    ref = plain()
    got = clahe_bucket(crops, ids, hs, ws, cap, ns_cap=ns_cap)
    torch.cuda.synchronize()
    if not torch.equal(got, ref) or bool(torch.isnan(got).any()):
        raise AssertionError(f"clahe_cells {what}: {int((got != ref).sum())} values differ")
    ms = device_ms(lambda: clahe_bucket(crops, ids, hs, ws, cap, ns_cap=ns_cap),
                   ("clahe_cells_kernel",))
    t_k = time_ms(lambda: clahe_bucket(crops, ids, hs, ws, cap, ns_cap=ns_cap))
    t_p = time_ms(plain, n=3)
    C = ids.numel()
    n_bytes = 4 * (float((hs[idx].long() * ws[idx].long()).sum()) + C * cap * cap + 3 * C)
    b_ms, _ = bound(n_bytes)
    log(f"[2] clahe_cells {what}, {C} cells cap {cap} ns_cap {ns_cap}: bit-equal; kernel "
        f"device {ms:.4f} ms, wrapper call {t_k:.4f} ms; bound {b_ms * 1e3:.2f} us "
        f"({n_bytes / 1e6:.2f} MB), {100 * b_ms / ms:.1f}% of it; plain {t_p:.3f} ms")
    return dict(ms=ms, event_ms=t_k, plain_ms=t_p, bound_ms=b_ms)


def _clahe_buckets(torch, path: dict, what: str) -> dict:
    """`_clahe_check` on each non-empty bucket of a path, summed."""
    row = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for ids, cap, ns_cap in path["buckets"]:
        if ids.numel():
            r = _clahe_check(torch, path["crops"], ids.int(), path["heights"], path["widths"],
                             cap, ns_cap, f"{what} bucket")
            row = {k: row[k] + r[k] for k in row}
    log(f"[2] clahe_cells, the {what}'s buckets: kernel device {row['ms']:.4f} ms, bound "
        f"{row['bound_ms'] * 1e3:.2f} us, plain {row['plain_ms']:.3f} ms")
    return row


def _segsum_check(torch, dev, table: tuple, what: str) -> dict:
    """The segment-sum kernel equal to its plain version on a run table
    (seg, data, n_seg) as stage A builds it, its device time, the
    event-timed wrapper call, the plain version's and `index_add_`'s times
    and its bound."""
    from cell_image_analysis_tpu_torch.ops.cuda.segsum import segment_sums_cuda
    from cell_image_analysis_tpu_torch.ops.segsum import segment_sums_plain

    seg, data, n_seg = table
    got = segment_sums_cuda(seg, data, n_seg)
    ref = segment_sums_plain(seg, data, n_seg)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"segment_sum on {what}: kernel differs from index_add_")
    keep = (seg >= 0) & (seg < n_seg)
    seg_k, data_k = seg[keep].long(), data[keep]
    out = torch.zeros((n_seg, data.shape[1]), dtype=torch.int64, device=dev)
    t_d = device_ms(lambda: segment_sums_cuda(seg, data, n_seg), ("segment_sum_kernel",))
    t_k = time_ms(lambda: segment_sums_cuda(seg, data, n_seg))
    t_p = time_ms(lambda: segment_sums_plain(seg, data, n_seg))
    t_l = time_ms(lambda: out.index_add_(0, seg_k, data_k))
    b_ms, b_by = bound(seg.numel() * 4 + data.numel() * 8 + n_seg * data.shape[1] * 8)
    log(f"[2] segment_sum on {what} {tuple(data.shape)} -> ({n_seg}, 6), "
        f"{int((ref[:, 0] > 0).sum())} labels: equal; kernel device {t_d:.4f} ms, wrapper "
        f"call {t_k:.4f} ms; bound {b_ms * 1e3:.2f} us ({b_by}), {100 * b_ms / t_d:.1f}% of "
        f"it; plain {t_p:.3f} ms, index_add_ alone {t_l:.3f} ms")
    return dict(ms=t_d, event_ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_l, shape=list(data.shape))


def _kthvalue_check(torch, segs, qs: tuple, what: str) -> dict:
    """The radix select on frames as `normalize_percentile` (qs 3, 99.8) or
    `threshold_mask` (3, 99.8, 90) take them, at those ranks: bit-equal to
    its plain version and to torch.kthvalue; its device time, the
    event-timed call, the plain version's and torch.kthvalue's times (the
    library call, once a distinct rank) and its bound, each frame read
    once."""
    from cell_image_analysis_tpu_torch.ops.cuda.kthvalue import kth_smallest_cuda
    from cell_image_analysis_tpu_torch.ops.percentile import kth_smallest_plain, percentile_ranks

    flat = segs.reshape(segs.shape[0], -1).float()
    B, n = flat.shape
    ks = tuple(k for r in percentile_ranks(n, qs) for k in r[:2])

    def library():
        return [torch.kthvalue(flat, k + 1, dim=1).values for k in dict.fromkeys(ks)]

    got = kth_smallest_cuda(flat, ks)
    ref = kth_smallest_plain(flat, ks)
    lib = dict(zip(dict.fromkeys(ks), library()))
    lib = torch.stack([lib[k] for k in ks], dim=1)
    torch.cuda.synchronize()
    for other, name in ((ref, "its plain version"), (lib, "torch.kthvalue")):
        if not torch.equal(got.view(torch.int32), other.view(torch.int32)):
            raise AssertionError(f"[2] kthvalue_radix on {what}: differs from {name}")
    t_d = device_ms(lambda: kth_smallest_cuda(flat, ks), ("kthvalue",))
    t_k = time_ms(lambda: kth_smallest_cuda(flat, ks))
    t_p = time_ms(lambda: kth_smallest_plain(flat, ks), n=3)
    t_l = time_ms(library, n=3)
    b_ms, b_by = bound(B * n * 4)
    log(f"[2] kthvalue_radix on {what} ({B}, {n}), ranks {ks}: bit-equal to its plain version "
        f"and torch.kthvalue; kernels device {t_d:.4f} ms, wrapper call {t_k:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / t_d:.1f}% of it; plain {t_p:.3f} ms, "
        f"torch.kthvalue {t_l:.3f} ms")
    return dict(ms=t_d, event_ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_l, shape=[B, n], ranks=len(ks))


def _follow_flows_check(torch, labels, niter: int = 200) -> dict:
    """The flow following kernel on flows made from the 16 frames' StarDist
    label maps (5 x `masks_to_flows` plus noise, a +-2 cell probability
    plus noise, as `tests/test_torch_cellpose.py` makes them): final
    positions within 1e-4 px of its plain version and every moving pixel
    truncated to the same one, the others where they started; its device
    time, the event-timed call, the plain version's time and its bound
    (flows and cell probability read once, every final position written
    once).  No library computes it."""
    from cell_image_analysis_tpu_torch.ops.cellpose_masks import masks_to_flows
    from cell_image_analysis_tpu_torch.ops.cuda.flows import follow_flows_cuda
    from cell_image_analysis_tpu_torch.ops.flows import flow_field, follow_flows_plain, moving_points

    dev = labels.device
    gen = torch.Generator(device=dev).manual_seed(6)
    mu, _ = masks_to_flows(labels)
    dP = (5 * mu.float() + 0.3 * torch.randn(mu.shape, generator=gen, device=dev)).contiguous()
    prob = (torch.where(labels > 0, 2.0, -2.0)
            + 0.5 * torch.randn(labels.shape, generator=gen, device=dev)).float().contiguous()
    del mu
    got, n_moving = follow_flows_cuda(dP, prob, niter)
    want = follow_flows_plain(dP, prob, niter)
    moving = moving_points(flow_field(dP, prob))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = (got.to(torch.int32) == want.to(torch.int32)).all(dim=1)
    n_points = int(moving.sum())
    if not (err <= 1e-4 and bool(same.all()) and torch.equal(n_moving.long(),
                                                             moving.flatten(1).sum(1))):
        raise AssertionError(f"[2] follow_flows: max |kernel - plain| {err:.3e} px, "
                             f"{int((~same).sum())} pixels truncated elsewhere, moving "
                             f"{n_moving.tolist()} vs {moving.flatten(1).sum(1).tolist()}")
    B, _, h, w = dP.shape
    t_d = device_ms(lambda: follow_flows_cuda(dP, prob, niter), ("follow_flows",))
    t_k = time_ms(lambda: follow_flows_cuda(dP, prob, niter))
    t_p = time_ms(lambda: follow_flows_plain(dP, prob, niter), n=3)
    b_ms, b_by = bound(B * h * w * (2 + 1 + 2) * 4)
    log(f"[2] follow_flows on {B} x {h}x{w} flows of the frames' StarDist labels, {niter} "
        f"steps, {n_points} moving pixels: max |kernel - plain| {err:.3e} px, every pixel "
        f"truncated alike; kernels device {t_d:.4f} ms, wrapper call {t_k:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / t_d:.1f}% of it; plain {t_p:.3f} ms")
    return dict(max_abs_err=err, ms=t_d, event_ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape=[B, 2, h, w], moving=n_points)


def _winograd_prologue_check(torch, dev) -> dict:
    """Phase 2's Winograd at CPnet's 32 convs: the committed Cellpose
    weights on CELLPOSE_TILES random 224^2 tiles, each conv's call (its
    BatchNorm, style and ReLU as the kernel's input prologue) within 1e-5
    of the plain version on its own inputs, its device time beside its
    bound, and beside the plain instance's device time on the same input
    activated beforehand (what the prologue costs the kernel).  Returns the
    Winograd row's `cpnet_*` keys: the sums over the 32 convs."""
    from cell_image_analysis_tpu_torch.io.artifacts import load_cellpose_weights
    from cell_image_analysis_tpu_torch.models.cellpose import build_cpnet
    from cell_image_analysis_tpu_torch.ops import winograd
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda

    model = build_cpnet(load_cellpose_weights(CELLPOSE_WEIGHTS), dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    tiles = torch.randn((CELLPOSE_TILES, 224, 224, 2), generator=gen, device=dev)
    real, sums, err = winograd.winograd_conv3x3, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0), 0.0

    def checked(x, W, bias=None, **act):
        nonlocal err
        if act.get("in_scale") is None:
            raise AssertionError("[2] a CPnet conv was launched without its input prologue")
        y = real(x, W, bias, **act)
        ref = winograd.winograd_conv3x3_plain(x, W, bias, **act)
        rel = float((y - ref).abs().max()) / float(ref.abs().max())
        del ref
        B, H, Wd, ci = x.shape
        co = W.shape[-1]
        if not rel < 1e-5:
            raise AssertionError(f"[2] winograd {B}x{H}x{Wd}x{ci}->{co} +in: relative error "
                                 f"{rel:.3e} >= 1e-5")
        d_k = device_ms(lambda: real(x, W, bias, **act), ("winograd_kernel",), n=3)
        xa = winograd.pad_input(winograd.activate_input(x, act["in_scale"], act["in_shift"]))
        ops = winograd.winograd_operands(W, bias)
        d_p = device_ms(lambda: winograd_conv3x3_cuda(xa, *ops), ("winograd_kernel",), n=3)
        del xa
        b_ms, b_by = winograd_bound(B, H, Wd, ci, co)
        log(f"[2] winograd CPnet {B}x{H}x{Wd}x{ci}->{co} +in (shift "
            f"{tuple(act['in_shift'].shape)}): rel {rel:.3e}; kernel device {d_k:.3f} ms, the "
            f"plain instance on the activated input {d_p:.3f} ms; bound {b_ms:.3f} ms ({b_by}), "
            f"{100 * b_ms / d_k:.1f}% of it")
        err = max(err, rel)
        for k, v in (("ms", d_k), ("plain_ms", d_p), ("bound_ms", b_ms)):
            sums[k] += v
        return y

    winograd.winograd_conv3x3 = checked
    try:
        with torch.no_grad():
            model(tiles)
    finally:
        winograd.winograd_conv3x3 = real
    log(f"[2] winograd, CPnet's 32 convs on {CELLPOSE_TILES} tiles of 224^2 with the input "
        f"prologue: kernel device {sums['ms']:.3f} ms, the plain instance on activated inputs "
        f"{sums['plain_ms']:.3f} ms (+{100 * (sums['ms'] / sums['plain_ms'] - 1):.1f}%), bound "
        f"{sums['bound_ms']:.3f} ms, max relative error {err:.3e}")
    return {f"cpnet_{k}": v for k, v in sums.items()} | dict(cpnet_max_rel_err=err)


def _vit_attention_errors(got, q, k, v, rel_h, rel_w, scale) -> tuple:
    """(the kernel's output `got`, the float32 plain form's): each one's
    max |error| over the largest output, against the plain form computed
    in float64, 100 heads at a time."""
    from cell_image_analysis_tpu_torch.ops.vit_attention import vit_attention_plain

    err = err32 = top = 0.0
    for s in range(0, q.shape[0], 100):
        ins = [t[s:s + 100] for t in (q, k, v, rel_h, rel_w)]
        ref = vit_attention_plain(*(t.double() for t in ins), scale)
        err = max(err, float((got[s:s + 100].double() - ref).abs().max()))
        err32 = max(err32, float((vit_attention_plain(*ins, scale).double() - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
    return err / top, err32 / top


def _vit_attention_check(torch, dev) -> dict:
    """The ViT attention kernel at Cellpose-SAM's batch: 100 tiles x 16
    heads of 1,024 tokens and 64 channels, random q, k, v and bias terms;
    max |kernel - plain| within 1e-5 of the largest output, the plain
    materialised form computed in float64; its device time, the event-timed call, the plain
    form's time and its bound by the benchmark's rule (`backends/
    cellpose_sam/counts.attention_work`: the scores' and P V's products
    once, at the TF32 peak, and the two bias adds; q, k, v, the bias terms
    and the output once in float32).  No library call takes the bias
    without materialising it."""
    from cell_image_analysis_tpu_torch.ops.cuda.vit_attention import vit_attention_cuda
    from cell_image_analysis_tpu_torch.ops.vit_attention import vit_attention_plain

    bh, n, d, grid = CELLPOSE_SAM_TILES * VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM, VIT_GRID
    gen = torch.Generator(device=dev).manual_seed(25)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev) for _ in range(3))
    rel_h, rel_w = (torch.randn((bh, n, grid), generator=gen, device=dev) for _ in range(2))
    scale = d ** -0.5
    got = vit_attention_cuda(q, k, v, rel_h, rel_w, scale)
    rel, rel32 = _vit_attention_errors(got, q, k, v, rel_h, rel_w, scale)
    del got
    if not rel <= 1e-5:
        raise AssertionError(f"[2] vit_attention ({bh}, {n}, {d}): max |kernel - plain, "
                             f"float64| {rel:.3e} of the largest output > 1e-5")
    t_d = device_ms(lambda: vit_attention_cuda(q, k, v, rel_h, rel_w, scale),
                    ("vit_attention",), n=5)
    t_k = time_ms(lambda: vit_attention_cuda(q, k, v, rel_h, rel_w, scale), n=5)
    t_p = time_ms(lambda: vit_attention_plain(q, k, v, rel_h, rel_w, scale), n=3)
    b_ms, b_by = bound(4 * bh * n * (4 * d + 2 * grid), 4.0 * bh * n * n * d + 2.0 * bh * n * n,
                       H100_TF32_FLOPS)
    log(f"[2] vit_attention at {CELLPOSE_SAM_TILES} tiles x {VIT_HEADS} heads of {n} tokens x "
        f"{d}: max |kernel - plain, float64| {rel:.3e} of the largest output (the float32 "
        f"plain form's {rel32:.3e}); kernel device {t_d:.3f} ms, "
        f"wrapper call {t_k:.3f} ms; bound {b_ms:.3f} ms ({b_by}; its 3xTF32 products "
        f"{3 * b_ms:.3f} ms), {100 * b_ms / t_d:.1f}% of it; plain (materialised scores) "
        f"{t_p:.3f} ms")
    return dict(max_rel_err=rel, plain32_max_rel_err=rel32, ms=t_d, event_ms=t_k, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=[bh, n, d])


def _vit_linear_errors(got, x, w, b) -> tuple:
    """(the kernel's output `got`, cuBLAS float32's `F.linear`): each one's
    max |error| over the largest output, against the product in float64."""
    import torch.nn.functional as F

    ref = F.linear(x.double(), w.double(), None if b is None else b.double())
    top = float(ref.abs().max())
    err = float((got.double() - ref).abs().max()) / top
    lib = float((F.linear(x, w, b).double() - ref).abs().max()) / top
    return err, lib


def _vit_linear_check(torch, dev) -> dict:
    """The ViT linear kernel at Cellpose-SAM's four block linears, M =
    100 tiles x 1,024 tokens, random x, W (x 0.02) and bias: each within 2x
    cuBLAS float32's max |error| against float64; the row sums the four
    (a block's): device time, the event-timed call, cuBLAS float32 (the
    plain version and the library call: `F.linear`), the bound (3 x 2MNK at
    the TF32 peak, the 3xTF32 products; x and y once in float32 set none of
    them) with the 1xTF32 time beside it."""
    import torch.nn.functional as F

    from cell_image_analysis_tpu_torch.ops.cuda.vit_linear import vit_linear_cuda

    M = CELLPOSE_SAM_TILES * VIT_TOKENS
    gen = torch.Generator(device=dev).manual_seed(26)
    res, sums = {}, dict(ms=0.0, event_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_1xtf32_ms=0.0)
    worst = 0.0
    for name, (K, N) in VIT_LINEARS.items():
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((N, K), generator=gen, device=dev) * 0.02
        b = torch.randn((N,), generator=gen, device=dev) * 0.1
        err, lib = _vit_linear_errors(vit_linear_cuda(x, w, b), x, w, b)
        if not err <= 2 * lib:
            raise AssertionError(f"[2] vit_linear {name} ({M}, {K}) x ({N}, {K}): max |kernel - "
                                 f"float64| {err:.3e} of the largest output > 2x cuBLAS "
                                 f"float32's {lib:.3e}")
        t_d = device_ms(lambda: vit_linear_cuda(x, w, b), ("vit_linear",), n=5)
        t_k = time_ms(lambda: vit_linear_cuda(x, w, b), n=5)
        t_l = time_ms(lambda: F.linear(x, w, b), n=5)
        b_ms, b_by = bound(4.0 * (M * K + N * K + N + M * N), 3 * 2.0 * M * N * K, H100_TF32_FLOPS)
        one = 2.0 * M * N * K / H100_TF32_FLOPS * 1e3
        res[name] = dict(shape=[M, K, N], max_rel_err=err, cublas_max_rel_err=lib, ms=t_d,
                         event_ms=t_k, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                         bound_1xtf32_ms=one)
        for k, v in (("ms", t_d), ("event_ms", t_k), ("library_ms", t_l), ("bound_ms", b_ms),
                     ("bound_1xtf32_ms", one)):
            sums[k] += v
        worst = max(worst, err / lib)
        log(f"[2] vit_linear {name} ({M} x {K} -> {N}): max |kernel - float64| {err:.3e} of the "
            f"largest output (cuBLAS float32 {lib:.3e}); kernel device {t_d:.3f} ms "
            f"({2.0 * M * N * K / t_d / 1e9:.1f} TFLOP/s of float32 work), wrapper call "
            f"{t_k:.3f} ms; bound {b_ms:.3f} ms ({b_by}, 3xTF32), {100 * b_ms / t_d:.1f}% of it; "
            f"1xTF32 {one:.3f} ms; cuBLAS float32 {t_l:.3f} ms")
        del x, w, b
    log(f"[2] vit_linear, a block's four: kernel device {sums['ms']:.3f} ms, cuBLAS float32 "
        f"{sums['library_ms']:.3f} ms ({sums['library_ms'] / sums['ms']:.2f}x), bound "
        f"{sums['bound_ms']:.3f} ms ({100 * sums['bound_ms'] / sums['ms']:.1f}%); error at most "
        f"{worst:.2f}x cuBLAS float32's (gate 2)")
    return dict(sums, plain_ms=sums["library_ms"], bound_by="operations",
                max_err_over_cublas=worst, shapes=res)


def phase_kernels(torch, dev, unet_vars, main, thresh, plate=None) -> dict:
    from cell_image_analysis_tpu_torch.models.segmentation import threshold_mask
    from cell_image_analysis_tpu_torch.ops.cc import (
        cc_min_labels_plain,
        compact_labels,
        label_components,
        label_components_plain,
    )
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
    from cell_image_analysis_tpu_torch.ops.runs import run_moment_table
    from cell_image_analysis_tpu_torch.ops.winograd import (
        pad_input,
        winograd_conv3x3_plain,
        winograd_operands,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}

    # Winograd conv, the committed U-Net weights of all 13 layers at main-path
    # shapes, with the output ReLU that the U-Net launches
    err_w, all_k, all_p = 0.0, 0.0, 0.0
    row = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    largest = (0.0, "operations")   # the row's bound_by: that of its largest layer bound
    for name, (B, H, W, ci, co) in WINO_LAYERS.items():
        Wt = torch.tensor(unet_vars["params"][name]["kernel"], device=dev)
        bias = torch.tensor(unet_vars["params"][name]["bias"], device=dev)
        x = torch.relu(torch.randn((B, H, W, ci), generator=gen, device=dev))
        xp, ops = pad_input(x), winograd_operands(Wt, bias)
        y = winograd_conv3x3_cuda(xp, *ops, out_relu=True)
        ref = winograd_conv3x3_plain(x, Wt, bias, out_relu=True)
        if not torch.equal(y, torch.relu_(winograd_conv3x3_cuda(xp, *ops))):
            raise AssertionError(f"winograd {name}: the output ReLU is not relu_ of the plain "
                                 "instance bit for bit")
        torch.cuda.synchronize()
        abs_err = float((y - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        t_k = time_ms(lambda: winograd_conv3x3_cuda(xp, *ops, out_relu=True))
        t_p = time_ms(lambda: winograd_conv3x3_plain(x, Wt, bias, out_relu=True))
        pad = (f"; the wrapper's channel pad {ci}->{xp.shape[-1]} {time_ms(lambda: pad_input(x)):.3f} ms"
               if xp.shape != x.shape else "")
        log(f"[2] winograd {name} {B}x{H}x{W}x{ci}->{co} +out: max abs err {abs_err:.3e}, "
            f"rel {rel:.3e}, relu_ of the plain instance bit for bit; kernel {t_k:.3f} ms, "
            f"plain F.conv2d + relu_ {t_p:.3f} ms{pad}")
        if not rel < 1e-5:
            raise AssertionError(f"winograd {name}: relative error {rel:.3e} >= 1e-5")
        err_w, all_k, all_p = max(err_w, abs_err), all_k + t_k, all_p + t_p
        if name in WINO_ROW:
            d_k = device_ms(lambda: winograd_conv3x3_cuda(xp, *ops, out_relu=True),
                            ("winograd_kernel",), n=5)
            b_ms, b_by = winograd_bound(B, H, W, ci, co)
            largest = max(largest, (b_ms, b_by))
            # the plain version is one cuDNN fp32 call, the library's
            t_l = time_ms(lambda: torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), Wt.permute(3, 2, 0, 1), bias, padding=1))
            log(f"[2] winograd {name}: kernel device {d_k:.3f} ms; bound {b_ms:.3f} ms "
                f"({b_by}), {100 * b_ms / d_k:.1f}% of it; F.conv2d alone {t_l:.3f} ms")
            for k, v in (("ms", d_k), ("event_ms", t_k), ("plain_ms", t_p), ("bound_ms", b_ms),
                         ("library_ms", t_l)):
                row[k] += v
        del x, xp, y, ref
    log(f"[2] winograd, all 13 layers: kernel {all_k:.3f} ms, plain {all_p:.3f} ms; "
        f"{' + '.join(WINO_ROW)}: kernel device {row['ms']:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms")
    res["winograd_conv3x3"] = dict(max_abs_err=err_w, bound_by=largest[1], **row,
                                   **_winograd_prologue_check(torch, dev))

    # segment sum over the 16 frames' run table, as stage A of the main path builds it
    res["segment_sum"] = dict(max_abs_err=0.0, **_segsum_check(
        torch, dev, run_moment_table(main["labels"], capacity=128, rcap=32), "the 16 frames"))

    # CLAHE: 32 random cells at each bucket capacity, then the main path's buckets
    rng = np.random.default_rng(3)
    for cap, ns_cap in CLAHE_CAPS:
        lo_side = 16 if ns_cap == 12 else 13
        hs = rng.integers(lo_side, cap + 1, size=32).astype(np.int32)
        ws = rng.integers(lo_side, cap + 1, size=32).astype(np.int32)
        crops = np.round(rng.uniform(80, 3000, size=(32, cap, cap))).astype(np.float32)
        t = [torch.tensor(a, device=dev) for a in (crops, hs, ws)]
        _clahe_check(torch, t[0], torch.arange(32, dtype=torch.int32, device=dev), t[1], t[2],
                     cap, ns_cap, "32 random cells")
    row = _clahe_buckets(torch, main, "main path")
    thr = _clahe_buckets(torch, thresh, "threshold path")
    res["clahe_cells"] = dict(max_abs_err=0.0, bound_by="bytes", library_ms=None, **row,
                              threshold_ms=thr["ms"], threshold_bound_ms=thr["bound_ms"])

    # CC on the 16 frames' threshold masks (the threshold backend's input)
    masks = threshold_mask(main["segs"])
    log(f"[2] label_components input: {tuple(masks.shape)} masks, "
        f"{float(masks.float().mean()):.4f} foreground")
    for conn in (1, 2):
        got, count = label_components(masks, conn)
        ref, ref_count = label_components_plain(masks, conn)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(count, ref_count)):
            n_bad = int((got != ref).sum())
            raise AssertionError(f"label_components connectivity {conn}: {n_bad} labels, "
                                 f"{int((count != ref_count).sum())} counts differ")
        err = float((got - ref).abs().max())
        t_d = device_ms(lambda: label_components(masks, conn), ("cc_tile_",))
        t_k = time_ms(lambda: label_components(masks, conn))
        t_p = time_ms(lambda: label_components_plain(masks, conn), n=3)
        raw = cc_min_labels_plain(masks, conn)
        t_c = time_ms(lambda: compact_labels(raw))
        b_ms, b_by = bound(masks.numel() * (1 + 4))
        log(f"[2] label_components connectivity {conn}: {int(count.sum())} components, labels "
            f"and counts equal; kernels device {t_d:.4f} ms, wrapper call {t_k:.4f} ms; bound "
            f"{b_ms * 1e3:.2f} us ({b_by}), {100 * b_ms / t_d:.1f}% of it; plain {t_p:.3f} ms; "
            f"for the record, the eager compaction alone (the parent's route after its "
            f"raw-label kernel) {t_c:.4f} ms")
        if conn == 1:   # the connectivity of the main path
            res["cc_tile_labels"] = dict(max_abs_err=err, ms=t_d, event_ms=t_k, plain_ms=t_p,
                                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, ref, raw
    for name, tile in _tile_times(torch, dev, masks, unet_vars).items():
        res[name].update(tile)

    # the radix select on the 16 frames: StarDist's normalization, the threshold's six ranks
    row = _kthvalue_check(torch, main["segs"], (3.0, 99.8), "the 16 frames")
    thr = _kthvalue_check(torch, main["segs"], (3.0, 99.8, 90.0), "the 16 frames, threshold")
    res["kthvalue_radix"] = dict(max_abs_err=0.0, **row, threshold_ms=thr["ms"],
                                 threshold_event_ms=thr["event_ms"],
                                 threshold_library_ms=thr["library_ms"])
    res["follow_flows"] = _follow_flows_check(torch, main["labels"])
    res["vit_attention"] = _vit_attention_check(torch, dev)
    res["vit_linear"] = _vit_linear_check(torch, dev)
    _cc_structural(torch, dev)
    if plate is not None:
        del masks
        for name, at_plate in _plate_times(torch, dev, unet_vars, plate).items():
            res[name].update(at_plate)
    return res


def _cc_structural(torch, dev, side: int = 1024) -> None:
    """`label_components` on masks that cross every tile, which the plain
    sweeps cannot finish (a geodesic of ~side^2 / 2 pixels): all true, a
    serpentine over the whole frame, random at 0.59 density; labels and
    counts equal to those of `scipy.ndimage.label` on the host."""
    from scipy import ndimage as ndi

    from cell_image_analysis_tpu_torch.ops.cc import label_components

    serpentine = np.zeros((side, side), bool)
    serpentine[::2] = True
    serpentine[1::4, -1] = True
    serpentine[3::4, 0] = True
    rng = np.random.default_rng(5)
    host = np.stack([np.ones((side, side), bool), serpentine,
                     rng.random((side, side)) < 0.59, rng.random((side, side)) < 0.59])
    masks = torch.from_numpy(host).to(dev)
    for conn in (1, 2):
        got, count = label_components(masks, conn)
        got, count = got.cpu().numpy(), count.cpu().numpy()
        for b, name in enumerate(("all-true", "serpentine", "random 0.59 #1", "random 0.59 #2")):
            ref, n = ndi.label(host[b], structure=None if conn == 1 else np.ones((3, 3), bool))
            if count[b] != n or not np.array_equal(got[b], ref):
                raise AssertionError(f"label_components {name} {side}^2, connectivity {conn}: "
                                     f"{int((got[b] != ref).sum())} labels differ, count "
                                     f"{count[b]} vs scipy {n}")
        log(f"[2] label_components on {side}^2 all-true, serpentine and two random 0.59 masks, "
            f"connectivity {conn}: counts {count.tolist()}, equal to scipy.ndimage.label")


class _Recording:
    """Wraps a segment_fn, keeping its flags, its number of calls and the
    last batch's overflow flags."""

    def __init__(self, fn):
        self.fn, self.calls, self.overflow = fn, 0, None
        for flag in ("returns_overflow", "runs_props"):
            if hasattr(fn, flag):
                setattr(self, flag, getattr(fn, flag))

    def __call__(self, segs):
        self.calls += 1
        out = self.fn(segs)
        if getattr(self.fn, "returns_overflow", False):
            self.overflow = out[1]
        return out


def _check_result(scores: dict, stats: dict, n_frames: int) -> int:
    n = len(stats["area"])
    if n < 10 * n_frames:
        raise AssertionError(f"only {n} cells from {n_frames} frames")
    for k in ("reconstruction_mse", "conservative_scores", "moderate_scores", "fft_scores"):
        if scores[k].shape != (n,) or not np.all(np.isfinite(scores[k])):
            raise AssertionError(f"{k}: shape {scores[k].shape} or non-finite values")
    if scores["fft_features"].shape != (n, 27) or not np.all(np.isfinite(scores["fft_features"])):
        raise AssertionError("fft_features: bad shape or non-finite values")
    for k in ("conservative", "moderate", "ensemble", "fft"):
        if not set(np.unique(scores[f"{k}_predictions"])) <= {-1, 1}:
            raise AssertionError(f"{k}_predictions outside {{-1, +1}}")
    return n


def make_frames(torch, dev) -> tuple:
    """The bench's first 16 frames (utils/bench._make_frames(16, 1024, 80)):
    (seg channels, green channels), each (16, 1024, 1024) on the card, and
    the frames' SHA-1."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    frames = np.stack([make_frame(rng, size=1024, n_cells=80) for _ in range(16)])
    log(f"[3] made 16 frames 1024^2 in {time.perf_counter() - t0:.1f} s (host numpy)")
    return (torch.tensor(frames[..., 2].astype(np.float32), device=dev),
            torch.tensor(frames[..., 1].astype(np.float32), device=dev),
            hashlib.sha1(frames.tobytes()).hexdigest())


def _kernel_modules():
    from cell_image_analysis_tpu_torch.ops.cuda import (
        cc,
        clahe_kernel,
        flows,
        kthvalue,
        segsum,
        vit_attention,
        vit_linear,
        winograd,
    )

    return {"winograd_conv3x3": winograd, "segment_sum": segsum, "clahe_cells": clahe_kernel,
            "cc_tile_labels": cc, "kthvalue_radix": kthvalue, "follow_flows": flows,
            "vit_attention": vit_attention, "vit_linear": vit_linear}


def _reset_launches() -> None:
    for m in _kernel_modules().values():
        m.LAUNCHES = 0


def _read_launches() -> dict:
    return {name: m.LAUNCHES for name, m in _kernel_modules().items()}


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_main_path(torch, dev, unet_vars, seg_cfg, stage_a, segs, greens,
                    n_buckets: int) -> tuple:
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    backend = _Recording(StarDistBackend(unet_vars, seg_cfg, device=dev))
    model, params = load_scoring_params(device=dev)

    def run():
        return _timed(torch, lambda: score_frames_fused(
            model, params, segs, greens, backend, chunk=32, caps=(64, 96), **stage_a))

    (_, _), t_first = run()
    log(f"[3] first run (warm-up) {t_first:.2f} s")
    _reset_launches()
    (scores, stats), t_run = run()
    launches = _read_launches()
    n_frames = segs.shape[0]
    n = _check_result(scores, stats, n_frames)
    log(f"[3] segmentation overflow flags per frame: "
        f"{backend.overflow.int().tolist()}")
    log(f"[3] cells {n}; rates " + ", ".join(
        f"{k} {scores[f'{k}_anomaly_rate']:.4f}"
        for k in ("conservative", "moderate", "ensemble", "fft")))
    log(f"[3] launches in the timed run: {launches}")
    log(f"[3] timed run: {t_run:.3f} s wall, {n / t_run:.1f} cells/s "
        f"({n_frames / t_run:.2f} frames/s)")
    if bool(backend.overflow.any()):
        raise AssertionError("a segmentation overflow flag is set on the smoke frames")
    missing = [k for k in ("winograd_conv3x3", "segment_sum", "clahe_cells", "kthvalue_radix")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the path were not launched: {missing}")
    if launches["clahe_cells"] > n_buckets:
        raise AssertionError(f"[3] {launches['clahe_cells']} CLAHE launches for {n_buckets} "
                             "non-empty size buckets")
    log(f"[3] CLAHE: {launches['clahe_cells']} launches, {n_buckets} non-empty size buckets")
    return launches, (scores, stats), backend.fn


def _screen_threshold(torch, d, segs, greens, params_model, rcap=32, twin_alone=False,
                      fallback=True):
    """One threshold screening on device d, through the backend or with
    `twin_alone` its exact twin; returns ((scores, stats), the fallback's
    recorder)."""
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    model, params = params_model
    backend = ThresholdBackend()
    twin = _Recording(backend.exact_twin())
    fn = backend.exact_twin() if twin_alone else backend
    out = score_frames_fused(model, params, segs, greens, fn, rcap=rcap,
                             fallback_segment_fn=twin if fallback else None, **THRESH_KW)
    return out, twin


def phase_gpu_vs_cpu(torch, dev, unet_vars, seg_cfg, stage_a) -> None:
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.utils.parity import boundary_flips, compare_screens

    frame = make_frame(np.random.default_rng(11), size=512, n_cells=25)
    results, labels, thresh = [], [], []
    for d in (dev, torch.device("cpu")):
        backend = StarDistBackend(unet_vars, seg_cfg, device=d)
        model, params = load_scoring_params(device=d)
        segs = torch.tensor(frame[None, ..., 2].astype(np.float32), device=d)
        greens = torch.tensor(frame[None, ..., 1].astype(np.float32), device=d)
        results.append(score_frames_fused(model, params, segs, greens, backend, chunk=32,
                                          caps=(64, 96), **stage_a))
        with torch.inference_mode():
            lab, det = predict_instances(segs, backend.model, seg_cfg)
        labels.append(lab[0].cpu())
        main, twin = _screen_threshold(torch, d, segs, greens, (model, params))
        if twin.calls:
            raise AssertionError(f"[4] the threshold backend overflowed on {d}")
        twin_alone, _ = _screen_threshold(torch, d, segs, greens, (model, params),
                                          twin_alone=True, fallback=False)
        thresh.append((main, twin_alone))
    # the CPU run is the reference; label maps may differ only at knife edges
    flips = {(0, lab): n for lab, n in boundary_flips(
        labels[1], labels[0], det.points[0], det.dists[0], det.keep[0]).items()}
    thr = float(params.ensemble_mse_threshold)
    report = compare_screens(results[1], results[0], flips, thr, tol=TOL)
    log(f"[4] 512^2 frame, StarDist GPU vs CPU: {report['n_cells']} cells, same cell set; "
        f"max score difference {report['max_score_diff']:.3e}; knife-edge cells "
        f"{report['knife_edge_cells']}; within {TOL} of a threshold "
        f"{report['near_threshold']}")
    (gpu_main, gpu_twin), (cpu_main, cpu_twin) = thresh
    for name, ref, got in (("backend GPU vs CPU", cpu_main, gpu_main),
                           ("exact twin GPU vs CPU", cpu_twin, gpu_twin),
                           ("GPU backend vs exact twin", gpu_twin, gpu_main)):
        report = compare_screens(ref, got, {}, thr, tol=TOL)
        _check_result(*got, 1)
        log(f"[4] 512^2 frame, threshold {name}: {report['n_cells']} cells, same cell set; "
            f"max score difference {report['max_score_diff']:.3e}; within {TOL} of a "
            f"threshold {report['near_threshold']}")


def _assert_same(a: tuple, b: tuple, what: str) -> None:
    """Two (scores, stats) results are identical."""
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            raise AssertionError(f"{what}: different keys")
        for k in x:
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{what}: {k} differs")


def phase_threshold(torch, dev, segs, greens, params_model) -> dict:
    from cell_image_analysis_tpu_torch.utils.parity import compare_screens

    def run(**kw):
        return _timed(torch, lambda: _screen_threshold(torch, dev, segs, greens, params_model,
                                                       **kw))

    def counted(**kw):
        """One run with the launch counts set to 0 just before it and read
        just after."""
        _reset_launches()
        out = run(**kw)
        return out, _read_launches()

    (_, _), t_first = run()
    log(f"[5] (a) threshold backend, first run (warm-up) {t_first:.2f} s")
    ((res_a, twin_a), t_a), launches_a = counted()
    ((res_b, _), t_b), launches_b = counted(twin_alone=True, fallback=False)
    ((res_c, twin_c), t_c), launches_c = counted(rcap=8)
    n_frames = segs.shape[0]
    n = _check_result(*res_a, n_frames)
    log(f"[5] (a) backend (CC kernel, run-length regionprops) + fallback: {n} cells, "
        f"{n / t_a:.1f} cells/s, {t_a:.3f} s wall ({n_frames / t_a:.2f} frames/s); fallback "
        f"calls {twin_a.calls}; launches {launches_a}")
    log(f"[5] (b) exact twin (CC kernel, pixel regionprops): {len(res_b[1]['area'])} cells, "
        f"{t_b:.3f} s wall (one run); launches {launches_b}")
    log(f"[5] (c) backend at rcap 8: fallback calls {twin_c.calls}, {t_c:.3f} s wall "
        f"(one run, backend and twin); launches {launches_c}")
    if twin_a.calls != 0:
        raise AssertionError("[5] (a) the threshold backend overflowed at rcap 32")
    if twin_c.calls != 1:
        raise AssertionError("[5] (c) the fallback did not fire once at rcap 8")
    missing = [f"({run}) {k}" for run, launches in (("a", launches_a), ("b", launches_b))
               for k in ("cc_tile_labels", "segment_sum", "clahe_cells") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"[5] kernels of the threshold path were not launched: {missing}")
    if max(launches_a["clahe_cells"], launches_b["clahe_cells"]) > N_BUCKETS:
        raise AssertionError(f"[5] more CLAHE launches than the {N_BUCKETS} size buckets")
    if launches_a["cc_tile_labels"] != launches_b["cc_tile_labels"]:
        raise AssertionError(f"[5] (a) made {launches_a['cc_tile_labels']} CC calls, the twin "
                             f"{launches_b['cc_tile_labels']}")
    # the fallback re-runs the whole batch through the twin once
    if launches_c["cc_tile_labels"] != 2 * launches_b["cc_tile_labels"]:
        raise AssertionError(f"[5] (c) made {launches_c['cc_tile_labels']} CC calls, the twin "
                             f"{launches_b['cc_tile_labels']}")
    report = compare_screens(res_b, res_a, {}, float(params_model[1].ensemble_mse_threshold),
                             tol=TOL)
    log(f"[5] (a) vs (b): same {report['n_cells']} cells and areas; max score difference "
        f"{report['max_score_diff']:.3e}; within {TOL} of a threshold "
        f"{report['near_threshold']}")
    _assert_same(res_c, res_b, "(c) vs (b)")
    log("[5] (c) equals (b) exactly")
    return launches_a, launches_b


def _clipped_cells(torch, model, seg_cfg, twin_cfg, segs) -> set:
    """(frame, label id) of the cells whose label pixels differ between the
    tiled and the scatter rasterizer.  Each differing pixel must lie outside
    the scatter patch of the polygon that the tiled render gave it: the
    scatter rasterizer clips polygons wider than its patch, and nothing
    else may differ."""
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.ops.rasterize import _compact_and_key

    with torch.inference_mode():
        tiled, det = predict_instances(segs, model, seg_cfg)
        scatter, _ = predict_instances(segs, model, twin_cfg)
    centers, _, keys, keep = _compact_and_key(det.points, det.dists, det.probs, det.keep,
                                              seg_cfg.raster_cap or None)
    diff = torch.nonzero(tiled != scatter)
    if diff.numel() == 0:
        return set()
    b, r, c = diff.T
    lab, lab_s = tiled[b, r, c], scatter[b, r, c]
    slot_labels = torch.where(keep, 0xFFFF - (keys & 0xFFFF), -1)          # (B, K)
    match = slot_labels[b] == lab[:, None]
    if bool((lab == 0).any()) or bool((match.sum(dim=1) != 1).any()):
        raise AssertionError("[6] the scatter render differs where the tiled one drew "
                             "no polygon")
    k = match.int().argmax(dim=1)
    half = twin_cfg.raster_patch // 2
    r0 = torch.round(centers[b, k, 0]).int() - half
    c0 = torch.round(centers[b, k, 1]).int() - half
    inside = ((r >= r0) & (r < r0 + twin_cfg.raster_patch)
              & (c >= c0) & (c < c0 + twin_cfg.raster_patch))
    if bool(inside.any()):
        raise AssertionError(f"[6] {int(inside.sum())} label pixels differ inside their "
                             "polygon's scatter patch")
    pairs = torch.cat([torch.stack([b, lab], 1), torch.stack([b, lab_s], 1)]).tolist()
    return {(f, lb) for f, lb in pairs if lb > 0}


def phase_twin(torch, dev, seg_cfg, stage_a, segs, greens, backend, params_model,
               main_result) -> None:
    import dataclasses

    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.utils.parity import compare_screens

    model, params = params_model
    twin = backend.exact_twin()

    def run(fn, fallback=None):
        return _timed(torch, lambda: score_frames_fused(
            model, params, segs, greens, fn, chunk=32, caps=(64, 96),
            fallback_segment_fn=fallback, **stage_a))

    _reset_launches()
    res_twin, t_twin = run(twin)
    launches = _read_launches()
    n = _check_result(*res_twin, segs.shape[0])
    log(f"[6] exact twin: {n} cells, {t_twin:.3f} s wall (one run), {n / t_twin:.1f} cells/s; "
        f"launches {launches}")
    clipped = _clipped_cells(torch, backend.model, seg_cfg, twin.cfg, segs)
    report = compare_screens(main_result, res_twin, {}, float(params.ensemble_mse_threshold),
                             tol=TOL, exclude=clipped)
    log(f"[6] twin vs phase 3: same {report['n_cells']} cells and areas, max score difference "
        f"{report['max_score_diff']:.3e}; patch-clipped cells left out: {sorted(clipped)}")

    tight = _Recording(StarDistBackend(None, dataclasses.replace(seg_cfg, nms_max_pairs=64),
                                       model=backend.model))
    twin_rec = _Recording(twin)
    res_forced, t_forced = run(tight, fallback=twin_rec)
    if not (bool(tight.overflow.any()) and twin_rec.calls == 1):
        raise AssertionError("[6] the 64-pair NMS budget did not fall back to the twin")
    _assert_same(res_forced, res_twin, "forced fallback vs twin")
    log(f"[6] NMS budget 64 pairs: overflow in frames "
        f"{torch.nonzero(tight.overflow).flatten().tolist()}, fell back to the twin, equal to "
        f"it; {t_forced:.3f} s wall")


def phase_cellpose(torch, dev, stage_a, segs, greens, params_model) -> dict:
    """Phase 17 (see the module docstring): the Cellpose backend at
    `CellposeConfig()` through `score_frames_fused_start` / `_wait` on the
    16 frames, a warm-up held against the plain versions, then a run with
    the counts set to 0 just before; returns its launches, cells, wall
    seconds and peak memory."""
    from cell_image_analysis_tpu_torch.io.artifacts import load_cellpose_weights
    from cell_image_analysis_tpu_torch.models.segmentation import CellposeBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import (
        score_frames_fused_start,
        score_frames_fused_wait,
    )

    model, params = params_model
    backend = CellposeBackend(load_cellpose_weights(CELLPOSE_WEIGHTS), device=dev)
    twin = _Recording(backend.exact_twin())

    def run():
        return score_frames_fused_wait(score_frames_fused_start(
            model, params, segs, greens, backend, chunk=32, caps=(64, 96),
            fallback_segment_fn=twin, **stage_a))

    _counted(torch, run, CELLPOSE_KERNELS, "[17] Cellpose, first run (warm-up), held")
    torch.cuda.reset_peak_memory_stats(dev)
    (scores, stats), launches, seconds = _counted(torch, run, CELLPOSE_KERNELS,
                                                  "[17] Cellpose main path", held=False)
    n_frames = segs.shape[0]
    n = _check_result(scores, stats, n_frames)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if twin.calls:
        raise AssertionError(f"[17] Cellpose: {twin.calls} batches fell back to the exact twin")
    log(f"[17] Cellpose (CPnet nbase {backend.model.nbase}, {backend.model.tile}^2 tiles, "
        f"{backend.cfg.niter} steps) on the {n_frames} frames: {n} cells, {seconds:.3f} s wall, "
        f"{n / seconds:.1f} cells/s; peak {peak_gib:.3f} GiB; no fallback [{smi_line()}]")
    return dict(launches=launches, cells=n, seconds=seconds, peak_gib=peak_gib)


def phase_cellpose_sam(torch, dev, stage_a, segs, greens, params_model) -> dict:
    """Phase 18 (see the module docstring): the Cellpose backend with
    Cellpose-SAM's ViT on the first 4 of the 16 frames (100 tiles, one ViT
    call), a warm-up held against the plain versions, then a run with the
    counts set to 0 just before; returns its launches, cells, wall
    seconds and peak memory."""
    from cell_image_analysis_tpu_torch.config import CellposeConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_cellpose_weights
    from cell_image_analysis_tpu_torch.models.segmentation import CellposeBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import (
        score_frames_fused_start,
        score_frames_fused_wait,
    )

    model, params = params_model
    backend = CellposeBackend(load_cellpose_weights(CELLPOSE_SAM_WEIGHTS),
                              CellposeConfig(tile_chunk=CELLPOSE_SAM_TILES), device=dev)
    depth = len(backend.model.encoder.blocks)
    twin = _Recording(backend.exact_twin())
    segs, greens = segs[:CELLPOSE_SAM_FRAMES], greens[:CELLPOSE_SAM_FRAMES]

    def run():
        return score_frames_fused_wait(score_frames_fused_start(
            model, params, segs, greens, backend, chunk=32, caps=(64, 96),
            fallback_segment_fn=twin, **stage_a))

    _, held, _ = _counted(torch, run, CELLPOSE_SAM_KERNELS,
                          "[18] Cellpose-SAM, first run (warm-up), held")
    torch.cuda.reset_peak_memory_stats(dev)
    (scores, stats), launches, seconds = _counted(torch, run, CELLPOSE_SAM_KERNELS,
                                                  "[18] Cellpose-SAM main path", held=False)
    for tag, got in (("held warm-up", held), ("main path", launches)):
        if got["vit_attention"] != depth or got["vit_linear"] != 4 * depth:
            raise AssertionError(f"[18] Cellpose-SAM {tag}: {got['vit_attention']} attention "
                                 f"and {got['vit_linear']} linear launches for the ViT's "
                                 f"{depth} blocks (want {depth} and {4 * depth})")
    n = _check_result(scores, stats, CELLPOSE_SAM_FRAMES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if twin.calls:
        raise AssertionError(f"[18] Cellpose-SAM: {twin.calls} batches fell back to the exact "
                             "twin")
    log(f"[18] Cellpose-SAM (ViT depth {depth}, {backend.model.tile}^2 tiles, "
        f"{CELLPOSE_SAM_TILES} a call, {backend.cfg.niter} steps) on {CELLPOSE_SAM_FRAMES} "
        f"frames: {n} cells, {seconds:.3f} s wall, {n / seconds:.1f} cells/s; peak "
        f"{peak_gib:.3f} GiB; no fallback [{smi_line()}]")
    return dict(launches=launches, cells=n, seconds=seconds, peak_gib=peak_gib)


def write_frames(folder: str, first: int, n: int, seed: int, mutant_fraction: float,
                 crop, size: int, n_cells: int) -> int:
    """Worker process: frames `first .. first + n - 1` of a sample folder
    (`make_dataset` with its own seed into a scratch folder, renamed),
    cropped to `crop` = (h, w) if given."""
    from cell_image_analysis_tpu_torch.io.tiff import imread, imwrite
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    scratch = f"{folder}.part{first}"
    for i, path in enumerate(make_dataset(scratch, n_frames=n, size=size, n_cells=n_cells,
                                          mutant_fraction=mutant_fraction, seed=seed)):
        target = os.path.join(folder, f"frame_{first + i:03d}.tif")
        if crop is not None:
            imwrite(target, imread(path)[:crop[0], :crop[1]])
        else:
            os.replace(path, target)
    shutil.rmtree(scratch)
    return n


def write_bench_frames(path: str) -> int:
    """Worker process: the bench's frames (`utils/bench._make_frames(48,
    1024, 80)`, one rng stream: they cannot be split over processes) into
    an .npy file."""
    from cell_image_analysis_tpu_torch.utils.bench import _make_frames

    np.save(path, np.stack(_make_frames(BENCH_FRAMES, FRAME_SIZE, FRAME_CELLS)))
    return BENCH_FRAMES


def start_sample_folders(pool, root: str):
    """Submit to `pool` the tasks that write phase 7's folders under
    `root`; returns (futures, {sample: folder}).  A folder of more than
    CHUNK_FRAMES frames is written in chunks, the k-th with seed
    `seed + 1000 * k`."""
    folders, futures = {}, []
    for name, n, seed, mutant, crop in SAMPLES:
        folders[name] = os.path.join(root, name)
        os.makedirs(folders[name])
        for k, first in enumerate(range(0, n, CHUNK_FRAMES)):
            futures.append(pool.submit(write_frames, folders[name], first,
                                       min(CHUNK_FRAMES, n - first), seed + 1000 * k, mutant,
                                       crop, FRAME_SIZE, FRAME_CELLS))
    folders["empty"] = os.path.join(root, "empty")
    os.makedirs(folders["empty"])
    with open(os.path.join(folders["mutantA"], "corrupt.tif"), "wb") as f:
        f.write(b"not a tiff at all")
    return futures, folders


class _HeldAgainstPlain:
    """While active, every call the port makes of a kernel's wrapper is held
    against the kernel's plain version on the same tensors, so each kernel
    is checked at the very shapes and data a path gives it: segment sum,
    CLAHE and connected components bit-equal, Winograd
    max|y - ref| / max|ref| < 1e-5 (a Winograd call on the autograd route
    is held where its forward and its data gradient call the wrapper with
    grad off), the ViT attention max|y - ref| <= 1e-5 max|ref| with ref
    the plain form in float64 (the float32 plain form's own error beside),
    the ViT linears max|y - ref| at most 2x cuBLAS float32's, ref the
    product in float64.  The path gets the kernel's result.  The plain versions
    launch no kernel of the port, so the launch counts see the path's
    launches only.  `held` maps a kernel to {input signature:
    calls}."""

    def __init__(self, torch):
        from cell_image_analysis_tpu_torch.ops import winograd
        from cell_image_analysis_tpu_torch.ops.cuda import (
            cc,
            clahe_kernel,
            segsum,
            vit_attention,
            vit_linear,
        )

        self.torch = torch
        self.held = {"winograd_conv3x3": {}, "segment_sum": {}, "clahe_cells": {},
                     "cc_tile_labels": {}, "vit_attention": {}, "vit_linear": {}}
        self.max_rel_err = {"winograd_conv3x3": 0.0, "vit_attention": 0.0}
        self.vit_plain32_err = 0.0
        self.linear_err = self.linear_cublas_err = self.linear_ratio = 0.0
        self._targets = ((segsum, "segment_sums_cuda", self._segsum),
                         (clahe_kernel, "clahe_cells_cuda", self._clahe),
                         (cc, "label_components_cuda", self._cc),
                         (winograd, "winograd_conv3x3", self._winograd),
                         (vit_attention, "vit_attention_cuda", self._vit),
                         (vit_linear, "vit_linear_cuda", self._linear))
        self._real = {}

    def __enter__(self):
        for module, name, checker in self._targets:
            self._real[name] = getattr(module, name)
            setattr(module, name, checker)
        return self

    def __exit__(self, *exc):
        for module, name, _ in self._targets:
            setattr(module, name, self._real[name])

    def _note(self, kernel: str, signature: tuple) -> None:
        self.held[kernel][signature] = self.held[kernel].get(signature, 0) + 1

    def _segsum(self, seg, data, n_seg):
        from cell_image_analysis_tpu_torch.ops.segsum import segment_sums_plain

        got = self._real["segment_sums_cuda"](seg, data, n_seg)
        if not self.torch.equal(got, segment_sums_plain(seg, data, n_seg)):
            raise AssertionError(f"segment_sum {tuple(data.shape)} -> {n_seg} segments differs "
                                 "from its plain version on a path's own table")
        self._note("segment_sum", (tuple(data.shape), n_seg))
        return got

    def _clahe(self, crops, ids, heights, widths, cap, **kw):
        from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells_plain

        got = self._real["clahe_cells_cuda"](crops, ids, heights, widths, cap, **kw)
        idx = ids.long()
        ref = clahe_cells_plain(crops[idx][:, :cap, :cap], heights[idx], widths[idx], **kw)
        if not self.torch.equal(got, ref):
            raise AssertionError(f"clahe_cells, {ids.numel()} of {crops.shape[0]} slots at cap "
                                 f"{cap}: {int((got != ref).sum())} values differ from the "
                                 "plain version on a path's own bucket")
        self._note("clahe_cells", (tuple(crops.shape), cap, kw.get("ns_cap")))
        return got

    def _cc(self, mask, connectivity):
        from cell_image_analysis_tpu_torch.ops.cc import label_components_plain

        got, count = self._real["label_components_cuda"](mask, connectivity)
        ref, ref_count = label_components_plain(mask, connectivity)
        if not (self.torch.equal(got, ref) and self.torch.equal(count, ref_count)):
            raise AssertionError(f"label_components {tuple(mask.shape)}, connectivity "
                                 f"{connectivity}, differs from its plain version")
        self._note("cc_tile_labels", (tuple(mask.shape), connectivity))
        return got, count

    def _winograd(self, x, W, bias=None, **act):
        from cell_image_analysis_tpu_torch.ops.winograd import winograd_conv3x3_plain

        if self.torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, W, bias, act.get("in_scale"), act.get("in_shift"))):
            # the autograd route: its forward and data gradient come back
            # here with grad off, and are held then
            return self._real["winograd_conv3x3"](x, W, bias, **act)
        y = self._real["winograd_conv3x3"](x, W, bias, **act)
        ref = winograd_conv3x3_plain(x, W, bias, **act)
        rel = float((y - ref).abs().max()) / float(ref.abs().max())
        # the activation fused beside the conv: the input prologue or the output ReLU
        fused = ("+in" if act.get("in_scale") is not None else
                 "+out" if act.get("out_relu") else "")
        if not rel < 1e-5:
            raise AssertionError(f"winograd {tuple(x.shape)} -> {W.shape[-1]} {fused}: relative "
                                 f"error {rel:.3e} >= 1e-5 on a path's own activations")
        self.max_rel_err["winograd_conv3x3"] = max(self.max_rel_err["winograd_conv3x3"], rel)
        self._note("winograd_conv3x3", (tuple(x.shape), W.shape[-1], fused))
        return y

    def _vit(self, q, k, v, rel_h, rel_w, scale):
        got = self._real["vit_attention_cuda"](q, k, v, rel_h, rel_w, scale)
        rel, rel32 = _vit_attention_errors(got, q, k, v, rel_h, rel_w, scale)
        if not rel <= 1e-5:
            raise AssertionError(f"vit_attention {tuple(q.shape)}: max |kernel - plain, float64| "
                                 f"{rel:.3e} of the largest output > 1e-5 on a path's own "
                                 f"activations (the float32 plain form's {rel32:.3e})")
        self.max_rel_err["vit_attention"] = max(self.max_rel_err["vit_attention"], rel)
        self.vit_plain32_err = max(self.vit_plain32_err, rel32)
        self._note("vit_attention", (tuple(q.shape), rel_h.shape[-1]))
        return got

    def _linear(self, x, w, b):
        got = self._real["vit_linear_cuda"](x, w, b)
        err, lib = _vit_linear_errors(got, x, w, b)
        if not err <= 2 * lib:
            raise AssertionError(f"vit_linear {tuple(x.shape)} -> {w.shape[0]}: max |kernel - "
                                 f"float64| {err:.3e} of the largest output > 2x cuBLAS "
                                 f"float32's {lib:.3e} on a path's own activations")
        self.linear_err = max(self.linear_err, err)
        self.linear_cublas_err = max(self.linear_cublas_err, lib)
        self.linear_ratio = max(self.linear_ratio, err / lib)
        self._note("vit_linear", (tuple(x.shape), w.shape[0]))
        return got

    def report(self, tag: str, needed: tuple) -> None:
        """Log what was held; fail if a kernel in `needed` was held no time."""
        for kernel, seen in self.held.items():
            if not seen:
                if kernel in needed:
                    raise AssertionError(f"{tag} no call of {kernel} was held against its "
                                         "plain version")
                continue
            shapes = "; ".join(f"{sig} x{n}" for sig, n in sorted(seen.items(), key=str))
            extra = (f", max relative error {self.max_rel_err[kernel]:.3e} (gate 1e-5)"
                     if kernel in self.max_rel_err else ", bit-equal")
            if kernel == "vit_linear":
                extra = (f", max |error| against float64 {self.linear_err:.3e} of the largest "
                         f"output (cuBLAS float32's up to {self.linear_cublas_err:.3e}), at most "
                         f"{self.linear_ratio:.2f}x cuBLAS's on the same call (gate 2)")
            if kernel == "vit_attention":
                extra += (f" against the plain form in float64 (the float32 plain form's "
                          f"{self.vit_plain32_err:.3e})")
            log(f"{tag} {kernel}: {sum(seen.values())} calls held against the plain version at "
                f"the path's own inputs{extra}: {shapes}")


class _CountedStart:
    """Stands in for `score_frames_fused_start` in the screener's module:
    the same call under `torch.cuda.set_sync_debug_mode("warn")`, counting
    the host waits that the call makes."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls, self.waits, self.where = torch, fn, 0, 0, {}

    def __call__(self, *args, **kwargs):
        torch = self.torch
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = self.fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.calls += 1
        for w in caught:
            if "synchroniz" in str(w.message):
                self.waits += 1
                key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                self.where[key] = self.where.get(key, 0) + 1
        return out


def _per_file_counts(printed: str) -> dict:
    """{sample: [cells of each file]} from the screener's console lines."""
    counts, sample = {}, None
    for line in printed.splitlines():
        if line.startswith("Processing "):
            sample = line[len("Processing "):].rstrip(".")
            counts[sample] = []
        elif sample and ".tif: " in line and line.rstrip().endswith(" cells"):
            counts[sample].append(int(line.split(": ")[1].split()[0]))
    return counts


def phase_screening(torch, dev, unet_vars, folders: dict, out_root: str, figures: bool):
    from cell_image_analysis_tpu_torch.config import OUTPUT_FILES_SCREENING, PipelineConfig
    from cell_image_analysis_tpu_torch.io.ingest import FrameStream, list_tiffs
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances
    from cell_image_analysis_tpu_torch.pipeline import screening
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    screener = screening.ProductionMutantScreening(STORE, PipelineConfig(), unet_vars)
    if screener.device.type != dev.type:
        raise AssertionError(f"[7] the screener's default device is {screener.device}")
    out = os.path.join(out_root, "screen_stardist")
    twin = screener._segment_fallback = _Recording(screener._segment_fallback)
    n_batches = sum(-(-n // 16) for _, n, *_ in SAMPLES)   # one shape a folder
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:   # the timed run: nothing of the smoke's stands in the screener's way
        with contextlib.redirect_stdout(printed):
            (results, detailed), t_all = _timed(torch, lambda: screener.screen_mutant_samples(
                folders, out, figures=figures))
    finally:
        log(printed.getvalue().rstrip())
    launches = _read_launches()
    printed = printed.getvalue()
    smi = smi_line()
    meter_line = (f"[7] screening cells/s (ThroughputMeter, {screener.meter.items} cells, "
                  f"{screener.meter.seconds:.3f} s): {screener.meter.rate:.1f} [{smi}]")
    timer_line = f"[7] {screener.timer.report().replace(chr(10), ' |')} [{smi}]"
    decode_line = (f"[7] TIFF decode seconds, summed over the ingest workers: "
                   f"{screener.decode_seconds:.3f} [{smi}]")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fallback_runs = twin.calls

    if set(results) != {"wildtype", "mutantA", "odd"}:
        raise AssertionError(f"[7] samples with results: {sorted(results)}")
    for needle in ("No .tif files found", "Error processing", "corrupt.tif"):
        if needle not in printed:
            raise AssertionError(f"[7] {needle!r} was not printed")
    for name in OUTPUT_FILES_SCREENING:
        if name.endswith(".png") and not figures:
            continue
        if not os.path.getsize(os.path.join(out, name)) > 0:
            raise AssertionError(f"[7] output file {name} is empty")
    log(f"[7] output files present: {'all of' if figures else 'the CSVs and the report of'} "
        f"OUTPUT_FILES_SCREENING ({'figures asserted' if figures else 'no matplotlib: figures not asserted'})")
    per_file = _per_file_counts(printed)
    for name, n_files, *_ in SAMPLES:
        if len(per_file[name]) != n_files or sum(per_file[name]) != results[name]["total_cells"]:
            raise AssertionError(f"[7] {name}: per-file counts {per_file[name]} vs total "
                                 f"{results[name]['total_cells']}")
        if results[name]["total_cells"] < 10 * n_files:
            raise AssertionError(f"[7] {name}: only {results[name]['total_cells']} cells")
    missing = [k for k in ("winograd_conv3x3", "segment_sum", "clahe_cells") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"[7] kernels of the screening path were not launched: {missing}")
    for k in ("mse", "conservative_score", "moderate_score"):
        if not np.all(np.isfinite([row[k] for row in detailed])):
            raise AssertionError(f"[7] non-finite {k}")

    # wildtype again through the in-flight path, and directly: the same
    # decoded frames in the same batches through score_frames_fused
    # (that second pass, not the timed run, counts the host waits in _start)
    files = list_tiffs(folders["wildtype"])
    counted = _CountedStart(torch, screening.score_frames_fused_start)
    screening.score_frames_fused_start = counted
    try:
        merged, counts, _ = screener._score_sample_frames(files)
    finally:
        screening.score_frames_fused_start = counted.fn

    def direct_batches(folder: str) -> tuple:
        """A folder's decoded frames, the `score_frames_fused` result of each
        batch of 16 with the screener's own arguments, and the last batch's
        seg channels on the card."""
        frames = [(seg, green) for _, seg, green in FrameStream(list_tiffs(folder))]
        out = []
        for at in range(0, len(frames), 16):
            segs = screener.frames_to_device([f[0] for f in frames[at:at + 16]])
            greens = screener.frames_to_device([f[1] for f in frames[at:at + 16]])
            seg_fn, kwargs = screener.fused_arguments(*segs.shape[1:])
            out.append(score_frames_fused(screener.model, screener.scoring_params, segs,
                                          greens, seg_fn, **kwargs))
        return frames, out, segs

    # The direct calls run with every kernel call held against its plain
    # version: the screener's own shapes (16 x 512 crop slots, label capacity
    # 1024, B = 16, 8 and 2, 1004 x 1020 frames padded to 1008 x 1024) on
    # both the main route and the exact twin that every overflow re-runs
    # through (its pixel-regionprops table, its crops).
    with _HeldAgainstPlain(torch) as held:
        frames, direct, segs = direct_batches(folders["wildtype"])
        _, odd_direct, _ = direct_batches(folders["odd"])
    held.report("[7]", needed=("winograd_conv3x3", "segment_sum", "clahe_cells"))
    if len(odd_direct[0][1]["area"]) != results["odd"]["total_cells"]:
        raise AssertionError("[7] odd: the held direct call found other cells than the screener")
    if SAMPLES[0][:2] == ("wildtype", 40) and [len(st["frame_index"]) > 0 for _, st in direct] \
            != [True] * 3:
        raise AssertionError("[7] wildtype did not make three batches with cells")
    for k, v in merged.items():
        if k.endswith("_anomaly_rate") or k == "_frame_names":
            continue
        if not np.array_equal(v, np.concatenate([s[k] for s, _ in direct])):
            raise AssertionError(f"[7] wildtype {k}: the screener differs from direct "
                                 "score_frames_fused calls")
    direct_counts = []
    for (_, st), at in zip(direct, range(0, len(frames), 16)):
        direct_counts += [int((st["frame_index"] == i).sum())
                          for i in range(len(frames[at:at + 16]))]
    if counts != direct_counts or counts != per_file["wildtype"]:
        raise AssertionError("[7] wildtype per-file counts differ between the screener and "
                             "direct calls")
    rows = [r for r in detailed if r["sample_name"] == "wildtype"]
    if [r["mse"] for r in rows] != [float(v) for v in merged["reconstruction_mse"]]:
        raise AssertionError("[7] wildtype: the report's rows differ from a second screening")
    n_cells = sum(r["total_cells"] for r in results.values())
    log(f"[7] wildtype: {len(rows)} cells in {len(direct)} batches; every score array and "
        "the per-file counts equal, bit for bit, direct score_frames_fused calls on the same "
        "decoded frames")
    log("[7] rates: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {r[f'{k}_anomaly_rate']:.4f}"
                               for k in ("conservative", "moderate", "ensemble", "fft"))
        for name, r in results.items()))
    log(f"[7] launches while screening: {launches}; peak device memory {peak_gib:.2f} GiB")
    with torch.inference_mode():
        _, det = predict_instances(segs, screener._segment.model, screener._segment.cfg)
    log(f"[7] batches that re-ran through the exact twin: {fallback_runs} of {n_batches}; "
        f"overflow flags of wildtype's last batch ({segs.shape[0]} frames): NMS pair budget "
        f"{int(det.nms_overflow.sum())}, raster tile cap {int(det.raster_overflow.sum())}, "
        f"candidate cap {int(det.cand_overflow.sum())}")
    log(meter_line)
    log(f"[7] screen_mutant_samples wall (reports included): {t_all:.3f} s, {n_cells} cells "
        f"[{smi}]")
    log(timer_line)
    log(f"[7] host waits inside score_frames_fused_start (counted in a second pass over "
        f"wildtype, not in the timed run): {counted.waits} in {counted.calls} calls, at "
        f"{counted.where} [{smi}]")
    log(decode_line)
    return launches


def _cells_close(got, ref, what: str, allowed: int) -> None:
    """Two `extract_quality_cells` results: the same number of cells; cells
    of equal area within TOL; at most `allowed` cells whose area differs
    (label pixels at a polygon's knife edge)."""
    (cells, stats), (cells_c, stats_c) = got, ref
    if len(cells) != len(cells_c) or len(cells) < 10:
        raise AssertionError(f"[8] {what}: {len(cells)} cells on the card, {len(cells_c)} "
                             "on the CPU")
    same = np.array([a["area"] == b["area"] for a, b in zip(stats, stats_c)])
    worst = float(np.abs(cells[same] - cells_c[same]).max())
    log(f"[8] extract_quality_cells, {what}: {len(cells)} cells on the card and on the CPU, "
        f"max difference {worst:.3e}; cells whose area differs: {int((~same).sum())}")
    if worst > TOL or int((~same).sum()) > allowed:
        raise AssertionError(f"[8] {what}: the card's cells differ from the CPU's")


def phase_threshold_screener(torch, dev, unet_vars, folders: dict, out_root: str,
                             figures: bool) -> None:
    import dataclasses

    from cell_image_analysis_tpu_torch.config import PipelineConfig, SegConfig
    from cell_image_analysis_tpu_torch.io.ingest import list_tiffs, split_channels
    from cell_image_analysis_tpu_torch.io.tiff import imread
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening

    files = list_tiffs(folders["wildtype"])[:16]
    cut = os.path.join(out_root, "wildtype16")
    os.makedirs(cut)
    for path in files:
        os.link(path, os.path.join(cut, os.path.basename(path)))
    cfg = dataclasses.replace(PipelineConfig(), seg=SegConfig(backend="threshold"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        screener = ProductionMutantScreening(STORE, cfg)
        cpu = ProductionMutantScreening(STORE, cfg, device="cpu")
    _reset_launches()
    with contextlib.redirect_stdout(printed):
        (results, _), t_all = _timed(torch, lambda: screener.screen_mutant_samples(
            {"wildtype": cut}, os.path.join(out_root, "screen_threshold"), figures=figures))
    launches = _read_launches()
    r = results["wildtype"]
    if r["total_cells"] < 10 * len(files) or sum(_per_file_counts(printed.getvalue())["wildtype"]) \
            != r["total_cells"]:
        raise AssertionError(f"[8] threshold screener: {r['total_cells']} cells")
    if launches["segment_sum"] <= 0 or launches["clahe_cells"] <= 0:
        raise AssertionError(f"[8] threshold screener launched {launches}")
    log(f"[8] threshold screener, {len(files)} frames: {r['total_cells']} cells, "
        f"{screener.meter.rate:.1f} cells/s, {t_all:.3f} s wall with reports; rates "
        f"conservative {r['conservative_anomaly_rate']:.4f}, moderate "
        f"{r['moderate_anomaly_rate']:.4f}; launches {launches} [{smi_line()}]")

    # the same 16 frames once more, directly, and one frame through
    # extract_quality_cells, with every kernel call held against its plain
    # version: the CC kernel, the run table and the crops at the screener's
    # capacities
    decoded = [split_channels(imread(path)) for path in files]
    seg, green = decoded[0]
    seg_fn, kwargs = screener.fused_arguments(*seg.shape)
    with _HeldAgainstPlain(torch) as held:
        direct = score_frames_fused(screener.model, screener.scoring_params,
                                    screener.frames_to_device([d[0] for d in decoded]),
                                    screener.frames_to_device([d[1] for d in decoded]),
                                    seg_fn, **kwargs)
        _reset_launches()
        got = screener.extract_quality_cells(seg, green)
    launches = _read_launches()
    held.report("[8]", needed=("segment_sum", "clahe_cells", "cc_tile_labels"))
    if len(direct[1]["area"]) != r["total_cells"]:
        raise AssertionError("[8] the held direct call found other cells than the screener")
    if launches["cc_tile_labels"] <= 0 or launches["clahe_cells"] <= 0:
        raise AssertionError(f"[8] extract_quality_cells (threshold) launched {launches}")
    _cells_close(got, cpu.extract_quality_cells(seg, green),
                 f"threshold backend (launches {launches})", allowed=0)
    with contextlib.redirect_stdout(io.StringIO()):
        star = ProductionMutantScreening(STORE, PipelineConfig(), unet_vars)
        star_cpu = ProductionMutantScreening(STORE, PipelineConfig(), unet_vars, device="cpu")
    _reset_launches()
    with _HeldAgainstPlain(torch) as held:
        got = star.extract_quality_cells(seg, green)
    launches = _read_launches()
    held.report("[8] StarDist extract_quality_cells,",
                needed=("winograd_conv3x3", "segment_sum", "clahe_cells"))
    if launches["winograd_conv3x3"] <= 0 or launches["segment_sum"] <= 0:
        raise AssertionError(f"[8] extract_quality_cells (StarDist) launched {launches}")
    _cells_close(got, star_cpu.extract_quality_cells(seg, green),
                 f"StarDist backend (launches {launches})", allowed=2)
    scores = star.compute_anomaly_scores(got[0])
    if scores["reconstruction_mse"].shape != (len(got[0]),) or not np.all(
            np.isfinite(scores["conservative_scores"])):
        raise AssertionError("[8] compute_anomaly_scores: bad shape or non-finite values")
    log(f"[8] compute_anomaly_scores on those {len(got[0])} cells: conservative rate "
        f"{scores['conservative_anomaly_rate']:.4f}, ensemble {scores['ensemble_anomaly_rate']:.4f}")


def phase_cli(folders: dict, out_root: str, figures: bool) -> None:
    out = os.path.join(out_root, "cli")
    base = [sys.executable, "-m", "cell_image_analysis_tpu_torch.cli", "screen", "--sample",
            f"mutantA={folders['mutantA']}", *([] if figures else ["--no-figures"])]
    t0 = time.perf_counter()
    done = subprocess.run([*base, "--models", STORE, "--output", out], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0 or not os.path.exists(os.path.join(out, "screening_summary.csv")):
        raise AssertionError(f"[9] cli screen exited {done.returncode}:\n{done.stdout[-2000:]}\n"
                             f"{done.stderr[-2000:]}")
    summary = done.stdout.split("QUICK SUMMARY:")[1].strip().splitlines()[-1]
    log(f"[9] cli screen on mutantA: exit 0 in {time.perf_counter() - t0:.1f} s, summary CSV "
        f"present; {summary}")
    bad = subprocess.run([*base, "--models", os.path.join(out_root, "no_such_models"),
                          "--output", os.path.join(out_root, "cli_bad")], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if bad.returncode == 0:
        raise AssertionError("[9] cli screen with a missing model directory exited 0")
    log(f"[9] cli screen with a missing model directory: exit {bad.returncode} "
        f"({bad.stderr.strip().splitlines()[-1][:120]})")


def phase_training(torch, dev, unet_vars, folders: dict, out_root: str, figures: bool) -> dict:
    import dataclasses

    from cell_image_analysis_tpu_torch.config import (
        ARTIFACT_BEST_AUTOENCODER,
        ARTIFACT_DETECTOR_CONSERVATIVE,
        ARTIFACT_DETECTOR_MODERATE,
        ARTIFACT_ENCODER,
        ARTIFACT_FINAL_AUTOENCODER,
        ARTIFACT_PCA,
        ARTIFACT_SCALER,
        AugmentConfig,
        PipelineConfig,
        TrainConfig,
    )
    from cell_image_analysis_tpu_torch.io.ingest import FrameStream, frames_to_device, list_tiffs
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu_torch.pipeline.training import ImprovedAnomalyDetectionTraining
    from cell_image_analysis_tpu_torch.train import trainer as trainer_mod

    cfg = dataclasses.replace(PipelineConfig(), train=TrainConfig(epochs=TRAIN_EPOCHS))
    out = os.path.join(out_root, "train_stardist")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = ImprovedAnomalyDetectionTraining(out, cfg, unet_vars)
    if trainer.device.type != dev.type:
        raise AssertionError(f"[10] the trainer's default device is {trainer.device}")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:   # the timed run: nothing of the smoke's stands in the trainer's way
        with contextlib.redirect_stdout(printed):
            ok, t_all = _timed(torch, lambda: trainer.run(folders["wildtype"], figures=False))
    finally:
        log(printed.getvalue().rstrip())
    launches = _read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    smi = smi_line()
    if not ok:
        raise AssertionError("[10] training returned False")
    missing = [k for k in ("winograd_conv3x3", "segment_sum", "clahe_cells") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"[10] kernels of the training path were not launched: {missing}")
    store = (ARTIFACT_BEST_AUTOENCODER, ARTIFACT_FINAL_AUTOENCODER, ARTIFACT_ENCODER,
             ARTIFACT_SCALER, ARTIFACT_PCA, ARTIFACT_DETECTOR_CONSERVATIVE,
             ARTIFACT_DETECTOR_MODERATE, "ensemble.json", "fft_scaler.pkl", "detector_fft.pkl")
    reports_ = ("cell_statistics.csv", "file_summary.csv", "data_quality_report.txt",
                "training_report.txt")
    for name in store + reports_:
        if not os.path.getsize(os.path.join(out, name)) > 0:
            raise AssertionError(f"[10] {name} is missing or empty")
    with open(os.path.join(out, "cell_statistics.csv")) as f:
        n_cells = sum(1 for _ in f) - 1
    timer = trainer.timer
    n_train = n_cells - int(np.ceil(cfg.train.val_split * n_cells))
    n_frames = len(list_tiffs(folders["wildtype"]))
    log(f"[10] trained on {n_cells} cells of {n_frames} frames in {t_all:.3f} s: the ten "
        f"store files and the four CSV and report files written; launches {launches}")
    log(f"[10] {timer.report().replace(chr(10), ' |')} [{smi}]")
    log(f"[10] extraction: {n_cells / timer.totals['extract_batch']:.1f} cells/s "
        f"({timer.totals['extract_batch']:.3f} s in {timer.counts['extract_batch']} batches, "
        f"the solidity loop's {timer.totals['solidity']:.3f} s outside it); training: "
        f"{n_train * TRAIN_EPOCHS / timer.totals['train_cae']:.1f} images/s over "
        f"{TRAIN_EPOCHS} epoch(s) of {n_train} cells ({timer.totals['train_cae']:.3f} s); "
        f"detector fits, SMO included: {timer.totals['detector_fit']:.3f} s; peak device "
        f"memory {peak_gib:.2f} GiB [{smi}]")

    # the port's screener reads the store that the port trained
    with contextlib.redirect_stdout(io.StringIO()):
        screener = ProductionMutantScreening(out, PipelineConfig(), unet_vars)
        results, detailed = screener.screen_mutant_samples(
            {"mutantA": folders["mutantA"]}, os.path.join(out_root, "screen_trained"),
            figures=figures)
    r = results["mutantA"]
    if r["total_cells"] < 80 or not np.all(np.isfinite([d["mse"] for d in detailed])):
        raise AssertionError(f"[10] screening with the trained store: {r}")
    log(f"[10] the screener read the trained store and screened mutantA: {r['total_cells']} "
        f"cells, rates conservative {r['conservative_anomaly_rate']:.4f}, moderate "
        f"{r['moderate_anomaly_rate']:.4f}, ensemble {r['ensemble_anomaly_rate']:.4f}, fft "
        f"{r['fft_anomaly_rate']:.4f}")

    # the five batches again, every kernel call held against its plain version
    frames = [(seg, green) for _, seg, green in FrameStream(list_tiffs(folders["wildtype"]))]
    held_cells = []
    with _HeldAgainstPlain(torch) as held:
        for at in range(0, len(frames), 8):
            batch = frames[at:at + 8]
            segs = frames_to_device([f[0] for f in batch], dev)
            greens = frames_to_device([f[1] for f in batch], dev)
            held_cells.append(trainer.extract_batch(segs, greens)[0])
    held.report("[10]", needed=("winograd_conv3x3", "segment_sum", "clahe_cells"))
    cells = np.concatenate(held_cells)
    if len(cells) != n_cells:
        raise AssertionError(f"[10] the held extraction found {len(cells)} cells, the timed "
                             f"run {n_cells}")

    # card against CPU from one init made without JAX
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = ImprovedAnomalyDetectionTraining(os.path.join(out_root, "train_cpu"), cfg,
                                               unet_vars, device="cpu")
    two = [(seg[:512, :512], green[:512, :512]) for seg, green in frames[:2]]
    got, ref = (t.extract_batch(frames_to_device([f[0] for f in two], d),
                                frames_to_device([f[1] for f in two], d))
                for t, d in ((trainer, dev), (cpu, torch.device("cpu"))))
    if len(got[0]) != len(ref[0]) or len(got[0]) < 10:
        raise AssertionError(f"[10] two 512^2 frames: {len(got[0])} cells on the card, "
                             f"{len(ref[0])} on the CPU")
    same = got[1]["area"] == ref[1]["area"]
    if int((~same).sum()) > 2:
        raise AssertionError(f"[10] two 512^2 frames: {len(got[0])} cells on the card, "
                             f"{len(ref[0])} on the CPU, {int((~same).sum())} of other area")
    worst = float(np.abs(got[0][same] - ref[0][same]).max())
    if worst > TOL:
        raise AssertionError(f"[10] two 512^2 frames: cells differ by {worst:.3e}")
    log(f"[10] extraction card vs CPU, two frames cut to 512^2: {len(got[0])} cells on both, "
        f"max difference {worst:.3e}; cells whose area differs: {int((~same).sum())}")

    # fit_cae draws its init from a CPU generator on either device
    off = AugmentConfig(rotation_range=0, width_shift_range=0, height_shift_range=0,
                        zoom_range=0, horizontal_flip=False, vertical_flip=False)
    one = TrainConfig(epochs=1)
    hist = [trainer_mod.fit_cae(torch.as_tensor(cells[:512], device=d), train_cfg=one,
                                aug_cfg=off, verbose=False)[2].history
            for d in (dev, torch.device("cpu"))]
    rel = {k: abs(hist[0][k][0] - hist[1][k][0]) / abs(hist[1][k][0])
           for k in ("loss", "mae", "val_loss", "val_mae")}
    if max(rel.values()) > TRAIN_RTOL:
        raise AssertionError(f"[10] one epoch card vs CPU: relative differences {rel}")
    log(f"[10] one epoch of fit_cae on 512 cells, card vs CPU from one init: relative "
        f"differences {', '.join(f'{k} {v:.2e}' for k, v in rel.items())} (gate {TRAIN_RTOL})")
    return launches, cells


def phase_unet_training(torch, dev, out_root: str) -> dict:
    """Phase 11: the U-Net trained on the card with `fit_unet`, the recipe of
    the committed asset at full width; see the module docstring."""
    import copy

    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import (
        load_unet_variables,
        save_unet_variables,
    )
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.models.unet import init_unet
    from cell_image_analysis_tpu_torch.ops.cuda import winograd as wino_cuda
    from cell_image_analysis_tpu_torch.train import unet_trainer as ut

    smi = smi_line()
    frames, labels = ut.synthetic_training_set(UNET_FRAMES, UNET_SIZE, dense=True)
    t0 = time.perf_counter()
    batch = ut.training_tensors(frames, labels, device=dev)
    t_gt = time.perf_counter() - t0
    log(f"[11] {UNET_FRAMES} dense frames of {UNET_SIZE}^2, {sum(int(lab.max()) for lab in labels)}"
        f" instances; host ground truth (prob and {batch[2].shape[-1]} rays at grid 2): "
        f"{t_gt:.3f} s")

    # three steps with every Winograd call held against F.conv2d, forward and
    # backward counted apart; then event-timed steps
    model = init_unet(42, device=dev)
    opt = ut.make_unet_optimizer(model, UNET_LR)
    split = []
    with _HeldAgainstPlain(torch) as held:
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            wino_cuda.LAUNCHES = 0
            loss, _, _ = ut.unet_loss(model, batch)
            fwd = wino_cuda.LAUNCHES
            loss.backward()
            split.append((fwd, wino_cuda.LAUNCHES - fwd))
            opt.step()
    held.report("[11]", needed=("winograd_conv3x3",))
    # 13 3x3 convs forward, 12 data gradients (Conv_0's input needs none)
    if any(calls != (13, 12) for calls in split):
        raise AssertionError(f"[11] Winograd wrapper calls (forward, backward) a step: {split}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(UNET_TIMED_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ut.unet_train_step(model, opt, batch)
        b.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(b))
    ms = statistics.median(step_ms)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[11] a step at B = {UNET_FRAMES}, {UNET_SIZE}^2: {ms:.3f} ms (median of "
        f"{UNET_TIMED_STEPS}, event-timed), {UNET_FRAMES / ms * 1e3:.1f} images/s, peak device "
        f"memory {peak_gib:.3f} GiB; Winograd wrapper calls a step (forward, backward): "
        f"{split[0]} [{smi}]")
    del model, opt

    # the run: fit_unet, the entry point, counts zeroed before and read after
    history = []
    _reset_launches()
    model, t_fit = _timed(torch, lambda: ut.fit_unet(
        frames, labels, epochs=UNET_EPOCHS, lr=UNET_LR, device=dev, history=history))
    launches = _read_launches()
    if launches["winograd_conv3x3"] <= 0:
        raise AssertionError(f"[11] fit_unet launched no Winograd kernel: {launches}")
    losses = [float(h[0]) for h in history]
    shown = sorted(set(range(0, UNET_EPOCHS, 10)) | {UNET_EPOCHS - 1})
    log(f"[11] fit_unet, {UNET_EPOCHS} epochs: {t_fit:.3f} s (the host ground truth "
        f"included), launches {launches}; loss at epochs "
        + ", ".join(f"{e} {losses[e]:.4f}" for e in shown) + f" [{smi}]")
    if not (np.all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]):
        raise AssertionError(f"[11] loss {losses[0]:.4f} -> {losses[-1]:.4f}: not below half")

    check = ut.self_check(model, UNET_SIZE, dense=True)
    log(f"[11] self-check: {check['n_pred']} predicted vs {check['n_true']} true instances, "
        f"fg coverage {check['coverage']:.3f} (gates: >= 0.5, |n_pred - n_true| <= 2)")
    if check["coverage"] < 0.5 or abs(check["n_pred"] - check["n_true"]) > 2:
        raise AssertionError(f"[11] self-check failed: {check}")

    # the written payload segments the check frame as the module in memory does
    path = os.path.join(out_root, "unet_trained.pkl")
    save_unet_variables(path, model, {"epochs": UNET_EPOCHS, "coverage": check["coverage"]})
    backend = StarDistBackend(load_unet_variables(path),
                              SegConfig(max_candidates=256, raster_patch=96), device=dev)
    seg, _ = ut.self_check_frame(UNET_SIZE, dense=True)
    got = backend(torch.as_tensor(seg[None], device=dev))[0][0].cpu().numpy()
    if not np.array_equal(got, check["labels"]):
        raise AssertionError("[11] the written weights segment the check frame otherwise")
    log(f"[11] {os.path.basename(path)} loads into a StarDistBackend that segments the check "
        "frame to the in-memory module's labels")

    # card against CPU from one init on two frames: (a) each takes its own
    # 10 steps; (b) at each of the CPU's 10 points, the card's loss and
    # gradients from the CPU's weights
    init = init_unet(7, device="cpu")
    cpu = torch.device("cpu")
    m_cpu, m_card, probe = (copy.deepcopy(init).to(d) for d in (cpu, dev, dev))
    o_cpu, o_card = ut.make_unet_optimizer(m_cpu, UNET_LR), ut.make_unet_optimizer(m_card, UNET_LR)
    two_card = tuple(t[:2] for t in batch)
    two_cpu = tuple(t.to(cpu) for t in two_card)
    hist, worst_loss, worst_grad = ([], []), 0.0, 0.0
    for _ in range(UNET_CPU_STEPS):
        probe.load_state_dict(m_cpu.state_dict())
        loss_cpu = ut.unet_train_step(m_cpu, o_cpu, two_cpu)[0]   # leaves its gradients
        probe.zero_grad(set_to_none=True)
        loss_probe = ut.unet_loss(probe, two_card)[0]
        loss_probe.backward()
        worst_loss = max(worst_loss,
                         abs(float(loss_probe.detach()) - float(loss_cpu)) / float(loss_cpu))
        for p, q in zip(probe.parameters(), m_cpu.parameters()):
            worst_grad = max(worst_grad, float((p.grad.cpu() - q.grad).norm() / q.grad.norm()))
        hist[0].append(float(ut.unet_train_step(m_card, o_card, two_card)[0]))
        hist[1].append(float(loss_cpu))
    rel = max(abs(a - b) / abs(b) for a, b in zip(*hist))
    log(f"[11] card vs CPU from one init, 2 frames: (a) {UNET_CPU_STEPS} steps each, loss "
        f"{hist[0][0]:.6f} -> {hist[0][-1]:.6f} on the card, largest relative difference "
        f"{rel:.3e} (gate {UNET_RTOL}); (b) at the CPU's {UNET_CPU_STEPS} points, the card's "
        f"loss within {worst_loss:.3e} relative (gate {UNET_LOSS_RTOL}), each leaf's gradient "
        f"within {worst_grad:.3e} of its norm (gate {UNET_GRAD_RTOL})")
    if not (rel <= UNET_RTOL and worst_loss <= UNET_LOSS_RTOL and worst_grad <= UNET_GRAD_RTOL):
        raise AssertionError(f"[11] card vs CPU: histories {hist}")
    return dict(launches, unet_step_ms=ms, unet_images_per_s=UNET_FRAMES / ms * 1e3,
                unet_gt_s=t_gt, unet_peak_gib=peak_gib, unet_fwd_bwd_calls=split[0])


# ----------------------------------------------------------- phase 12: mesh --

def make_mesh_for_smoke(torch):
    """A mesh of MESH_SHARDS shards: one GPU each where the machine has
    that many, else all on cuda:0 (a virtual mesh: every line of the mesh
    path runs, except the copies between distinct cards)."""
    from cell_image_analysis_tpu_torch.parallel.mesh import make_mesh, virtual_mesh

    count = torch.cuda.device_count()
    distinct = count >= MESH_SHARDS
    mesh = make_mesh(MESH_SHARDS) if distinct else virtual_mesh("cuda:0", MESH_SHARDS)
    where = ("one GPU a shard" if distinct else
             "all on one GPU, a virtual mesh: no copy between distinct cards runs")
    log(f"[12] torch.cuda.device_count() = {count}: a mesh of {MESH_SHARDS} shards on "
        f"{', '.join(str(d) for d in mesh.devices)} ({where})")
    return mesh


def _counted(torch, fn, needed: tuple, tag: str, held: bool = True):
    """fn() with the launch counts set to 0 just before it and read just
    after, every kernel call held against its plain version when `held`;
    fails if a kernel in `needed` was not launched.  Returns (result,
    launches, wall seconds)."""
    with (_HeldAgainstPlain(torch) if held else contextlib.nullcontext()) as checks:
        torch.cuda.synchronize()
        _reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = _read_launches()
    if held:
        checks.report(tag, needed)
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag} kernels of the path were not launched: {missing}")
    log(f"{tag}: launches {launches}, {seconds:.3f} s wall")
    return out, launches, seconds


def _assert_sharded_equal(ref: tuple, got: tuple, tag: str) -> None:
    """tests/test_sharded_scoring.py's contract: frame_index, areas and
    predictions equal, rates equal, the other floats within 1e-5."""
    (r, rs), (g, gs) = ref, got
    for k in ("frame_index", "label_ids", "area"):
        if not np.array_equal(rs[k], gs[k]):
            raise AssertionError(f"{tag}: {k} differs from the single-device run")
    worst = 0.0
    for k in r:
        if k.endswith("_rate") or k.endswith("_predictions"):
            if not np.array_equal(r[k], g[k]):
                raise AssertionError(f"{tag}: {k} differs from the single-device run")
        else:
            worst = max(worst, float(np.abs(r[k] - g[k]).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"{tag}: scores differ by {worst:.3e} > 1e-5")
    log(f"{tag}: {len(rs['area'])} cells; frame_index, label ids, areas, predictions and rates "
        f"equal to the single-device run; scores within {worst:.3e} (gate 1e-5)")


def _assert_tiled_equal(tiled_scores: dict, tiled, fused: tuple, gate: float, tag: str) -> None:
    """tests/test_tiling_pipeline.py's contract: the same number of cells,
    more than TILED_MIN_CELLS, sorted areas equal, sorted reconstruction MSE within
    `gate`, the four rates equal."""
    scores, stats = fused
    valid = tiled.valid.cpu().numpy()
    n_t, n_f = int(valid.sum()), len(stats["area"])
    log(f"{tag}: tiled {n_t} cells (n_cells {tiled.n_cells}), fused single-device {n_f}")
    if not n_t == n_f == tiled.n_cells > TILED_MIN_CELLS:
        raise AssertionError(f"{tag}: {n_t} tiled cells against {n_f} fused")
    if not np.array_equal(np.sort(tiled.area.cpu().numpy()[valid]), np.sort(stats["area"])):
        raise AssertionError(f"{tag}: sorted areas differ")
    gap = float(np.abs(np.sort(tiled_scores["reconstruction_mse"])
                       - np.sort(scores["reconstruction_mse"])).max())
    rates = {k: (tiled_scores[f"{k}_anomaly_rate"], scores[f"{k}_anomaly_rate"])
             for k in ("conservative", "moderate", "ensemble", "fft")}
    log(f"{tag}: sorted areas equal; sorted MSE within {gap:.3e} (gate {gate:.0e}); "
        f"rates tiled/fused {rates}")
    if not gap <= gate:
        raise AssertionError(f"{tag}: sorted MSE differ by {gap:.3e} > {gate}")
    if any(a != b for a, b in rates.values()):
        raise AssertionError(f"{tag}: rates differ")


def _plate(torch, dev, side: int, n_cells: int, seed: int) -> tuple:
    from cell_image_analysis_tpu_torch.utils.synthetic import make_plate

    t = time.perf_counter()
    plate = make_plate(np.random.default_rng(seed), size=side, n_cells=n_cells)
    log(f"[12] made a {side}^2 plate of {n_cells} cells in {time.perf_counter() - t:.1f} s "
        "(host numpy, `make_plate`)")
    return (plate, torch.tensor(plate[..., 2].astype(np.float32), device=dev),
            torch.tensor(plate[..., 1].astype(np.float32), device=dev))


def _tiled_scores(mesh, params_model, tiled) -> dict:
    from cell_image_analysis_tpu_torch.parallel.sharding import replicate, shard_batch
    from cell_image_analysis_tpu_torch.pipeline.scoring import compute_anomaly_scores

    model, params = params_model
    return compute_anomaly_scores(replicate(mesh, model), replicate(mesh, params),
                                  shard_batch(mesh, tiled.cells),
                                  valid=tiled.valid.cpu().numpy())


def _mesh_a(torch, mesh, backend, stage_a, segs, greens, params_model) -> dict:
    """(a) phase 3's and phase 5 (a)'s batches on the mesh against their
    single-device runs."""
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    model, params = params_model
    kw = dict(chunk=32, caps=(64, 96), **stage_a)
    ref = score_frames_fused(model, params, segs, greens, backend, **kw)
    got, launches, _ = _counted(
        torch, lambda: score_frames_fused(model, params, segs, greens, backend, mesh=mesh, **kw),
        ("winograd_conv3x3", "segment_sum", "clahe_cells"),
        f"[12] (a) StarDist, {segs.shape[0]} frames")
    _assert_sharded_equal(ref, got, "[12] (a) StarDist")
    thresh = ThresholdBackend()
    tkw = dict(THRESH_KW, rcap=32, fallback_segment_fn=thresh.exact_twin())
    ref = score_frames_fused(model, params, segs, greens, thresh, **tkw)
    got, launches_t, _ = _counted(
        torch, lambda: score_frames_fused(model, params, segs, greens, thresh, mesh=mesh, **tkw),
        ("segment_sum", "clahe_cells"), f"[12] (a) threshold, {segs.shape[0]} frames")
    _assert_sharded_equal(ref, got, "[12] (a) threshold")
    return {"a_stardist": launches, "a_threshold": launches_t}


def _mesh_b(torch, dev, mesh, params_model) -> dict:
    """(b) the threshold tiler on a 2048^2 plate against the fused
    single-device path."""
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.parallel.tiling import tiled_extract_cells
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    model, params = params_model
    _, seg, green = _plate(torch, dev, *TILE_PLATE)
    thresh = ThresholdBackend()
    fused = score_frames_fused(model, params, seg[None], green[None], thresh,
                               fallback_segment_fn=thresh.exact_twin(), chunk=32, caps=(64, 96),
                               cell_capacity=1024, label_capacity=8192, fg_fraction=0.12,
                               rcap=64)
    tiled, launches, _ = _counted(
        torch, lambda: tiled_extract_cells(seg, green, mesh, halo=MESH_HALO, cell_capacity=256,
                                           label_capacity=2048),
        ("cc_tile_labels", "segment_sum", "clahe_cells"),
        f"[12] (b) threshold tiler, {TILE_PLATE[0]}^2")
    if tiled.cell_overflow:
        raise AssertionError("[12] (b) a tile overflowed its cell capacity")
    _assert_tiled_equal(_tiled_scores(mesh, params_model, tiled), tiled, fused, 1e-6,
                        "[12] (b) threshold tiler")
    return launches


def _mesh_c(torch, dev, mesh, unet_vars, params_model) -> dict:
    """(c) the StarDist tiler on a 2048^2 plate against the fused
    single-device path, at capacities where no overflow flag fires."""
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
    from cell_image_analysis_tpu_torch.parallel.tiling import tiled_extract_cells_stardist
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    model, params = params_model
    _, seg, green = _plate(torch, dev, *STARDIST_PLATE)
    # the whole plate's top-K must not bind (checked below): 128 cells, as
    # 320 need ~32k candidates, whose dense K x K pair search in NMS took a
    # full smoke past 69 GiB; every candidate pair in NMS
    cfg = SegConfig(max_candidates=1 << 14, raster_mode="scatter", nms_max_pairs=None,
                    raster_patch=96, raster_cap=1024)
    backend = StarDistBackend(unet_vars, cfg, device=dev)
    with torch.inference_mode():
        prob, _ = backend.model(normalize_percentile(seg)[None, ..., None])
    above = int((prob > cfg.prob_thresh).sum())
    log(f"[12] (c) {above} grid pixels of the whole plate pass the prob threshold, "
        f"{cfg.max_candidates} candidates")
    if above >= cfg.max_candidates:
        raise AssertionError("[12] (c) the whole plate's top-K binds")
    twin = _Recording(backend.exact_twin())
    fused = score_frames_fused(model, params, seg[None], green[None], backend,
                               fallback_segment_fn=twin, chunk=32, caps=(64, 96),
                               cell_capacity=1024, label_capacity=1024, rcap=64)
    if twin.calls:
        raise AssertionError("[12] (c) an overflow flag fired on the whole plate")
    tiled, launches, _ = _counted(
        torch, lambda: tiled_extract_cells_stardist(seg, green, mesh, backend.model, seg_cfg=cfg,
                                                    halo=MESH_HALO, cell_capacity=256),
        ("winograd_conv3x3", "segment_sum", "clahe_cells"),
        f"[12] (c) StarDist tiler, {STARDIST_PLATE[0]}^2")
    if tiled.raster_overflow or tiled.cell_overflow:
        raise AssertionError(f"[12] (c) a tile's flag fired: segmentation "
                             f"{tiled.raster_overflow}, cells {tiled.cell_overflow}")
    _assert_tiled_equal(_tiled_scores(mesh, params_model, tiled), tiled, fused, TILED_MSE_GATE,
                        "[12] (c) StarDist tiler")
    return launches


def _plate_candidates(torch, dev, mesh, unet_vars, cfg, seg) -> dict:
    """The grid pixels above the prob threshold, against the candidate
    capacity (top-K) that the screener gives each route: the whole plate at
    its area-scaled K, and each haloed tile at the tile's (as
    `ProductionMutantScreening.score_tiled` sizes them)."""
    from cell_image_analysis_tpu_torch.models.segmentation import select_backend
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
    from cell_image_analysis_tpu_torch.parallel.tiling import halo_tiles

    side = seg.shape[0]
    backend = select_backend(cfg.seg, cfg.extract.cell_capacity, unet_vars, dev)[0]
    scale = lambda h, w: max(1, -(-(h * w) // (1024 * 1024)))
    rows = side // MESH_SHARDS
    align = 2 ** cfg.seg.unet_depth
    halo = min(cfg.extract.crop_capacity, rows) // align * align
    norm = normalize_percentile(seg, pmin=cfg.seg.norm_pmin, pmax=cfg.seg.norm_pmax)
    out = {}
    with torch.inference_mode():
        whole = int((backend.model(norm[None, ..., None])[0] > cfg.seg.prob_thresh).sum())
        k = cfg.seg.max_candidates * scale(side, side)
        out["whole"] = dict(above=whole, k=k, binds=whole > k)
        tiles = [int((backend.model(t[None, ..., None].to(dev))[0] > cfg.seg.prob_thresh).sum())
                 for t in halo_tiles(norm, mesh, halo)]
        k = cfg.seg.max_candidates * scale(rows + 2 * halo, side)
        out["tiled"] = dict(above=tiles, k=k, binds=max(tiles) > k)
    log(f"[12] (d) grid pixels above the prob threshold {cfg.seg.prob_thresh}: whole plate "
        f"{out['whole']['above']} against K = {out['whole']['k']} (binds: "
        f"{out['whole']['binds']}); haloed tiles (halo {halo}) {tiles} against K = "
        f"{out['tiled']['k']} a tile (binds: {out['tiled']['binds']})")
    return out


def _mesh_d(torch, dev, mesh, unet_vars, tmp_root: str) -> tuple:
    """(d) a 4096^2 plate through the screener: tiled on the mesh, and the
    whole frame without one; each route's candidates against its top-K."""
    from cell_image_analysis_tpu_torch.config import ExtractConfig, PipelineConfig
    from cell_image_analysis_tpu_torch.io.tiff import imwrite
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening

    side, n_cells, seed = BIG_PLATE
    plate, seg, _ = _plate(torch, torch.device("cpu"), side, n_cells, seed)
    folder = os.path.join(tmp_root, f"plate{side}")
    os.makedirs(folder)
    imwrite(os.path.join(folder, "plate.tif"), plate)
    del plate
    cfg = PipelineConfig(extract=ExtractConfig(tile_min_side=side // 2))
    binds = _plate_candidates(torch, dev, mesh, unet_vars, cfg, seg.to(dev))
    del seg
    needed = ("winograd_conv3x3", "segment_sum", "clahe_cells")
    out, launches = {}, {}
    for route, where in (("tiled", dict(mesh=mesh)), ("whole", dict(device=dev))):
        screener = ProductionMutantScreening(STORE, cfg, unet_vars, **where)
        fell_back = None
        if route == "whole":
            primary, twin = screener._segment_for(side, side)
            fell_back = _Recording(twin)
            screener._plate_backends[(side, side)] = (primary, fell_back)

        def run():
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res, _ = screener.screen_mutant_samples({"plate": folder},
                                                        os.path.join(tmp_root, f"out_{route}"),
                                                        figures=False)
            return res["plate"], printed.getvalue()

        _counted(torch, run, needed, f"[12] (d) {route}, first run")
        for d in mesh.distinct:
            torch.cuda.reset_peak_memory_stats(d)
        calls0 = fell_back.calls if fell_back else 0
        (res, printed), launches[f"d_{route}"], seconds = _counted(
            torch, run, needed, f"[12] (d) {route}, timed", held=False)
        peak = max(torch.cuda.max_memory_allocated(d) for d in
                   (mesh.distinct if route == "tiled" else (dev,))) / 2 ** 30
        if route == "tiled":
            falls = (f"{printed.count('exact-twin re-run')} exact-twin re-runs, "
                     f"{printed.count('4x re-run')} 4x re-runs")
        else:
            falls = f"{fell_back.calls - calls0} of 1 batch re-ran through the exact twin"
        out[route] = dict(cells=res["total_cells"], seconds=seconds, peak_gib=peak,
                          candidates=binds[route])
        log(f"[12] (d) {side}^2 plate, {route} route: {res['total_cells']} cells, "
            f"{seconds:.3f} s wall, peak device memory {peak:.2f} GiB, {falls}; rates "
            + ", ".join(f"{k} {res[f'{k}_anomaly_rate']:.4f}"
                        for k in ("conservative", "moderate", "ensemble", "fft")))
        if "WARNING" in printed:
            raise AssertionError(f"[12] (d) {route}: {printed[printed.index('WARNING'):][:300]}")
        if res["total_cells"] < n_cells // 2:
            raise AssertionError(f"[12] (d) {route}: only {res['total_cells']} cells")
        del screener
        torch.cuda.empty_cache()
    log(f"[12] (d) cells: tiled {out['tiled']['cells']}, whole frame {out['whole']['cells']} "
        f"(difference {out['tiled']['cells'] - out['whole']['cells']}); wall s tiled "
        f"{out['tiled']['seconds']:.3f} / whole {out['whole']['seconds']:.3f}; peak GiB tiled "
        f"{out['tiled']['peak_gib']:.2f} / whole {out['whole']['peak_gib']:.2f} ({smi_line()})")
    return launches, out


def _tile_times(torch, dev, masks, unet_vars) -> dict:
    """Phase 2's device times at phase 12's haloed-tile shapes, with their
    bounds: CC on a (1, 896, 2048) tile (the first 896 rows of two of the
    16 frames' threshold masks side by side: a 2048^2 plate's tile of 4
    with its halo, at the plate's cell density) and Winograd's Conv_1 on a
    tile of the 4096^2 plate (1, 1408, 4096, 32 -> 32)."""
    from cell_image_analysis_tpu_torch.ops.cc import label_components
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
    from cell_image_analysis_tpu_torch.ops.winograd import pad_input, winograd_operands

    rows = TILE_PLATE[0] // MESH_SHARDS + 2 * MESH_HALO
    cc_tile = torch.cat([masks[0, :rows], masks[1, :rows]], dim=1)[None].contiguous()
    t_d = device_ms(lambda: label_components(cc_tile, 1), ("cc_tile_",))
    b_ms, _ = bound(cc_tile.numel() * (1 + 4))
    log(f"[2] label_components on a haloed tile's shape {tuple(cc_tile.shape)}: kernels device "
        f"{t_d:.4f} ms; bound {b_ms * 1e3:.2f} us, {100 * b_ms / t_d:.1f}% of it")
    times = {"cc_tile_labels": dict(tile_shape=list(cc_tile.shape), tile_ms=t_d,
                                    tile_bound_ms=b_ms)}
    side = BIG_PLATE[0]
    rows = side // MESH_SHARDS + 2 * MESH_HALO
    Wt = torch.tensor(unet_vars["params"]["Conv_1"]["kernel"], device=dev)
    bias = torch.tensor(unet_vars["params"]["Conv_1"]["bias"], device=dev)
    x = torch.relu(torch.randn((1, rows, side, 32), device=dev))
    xp, ops = pad_input(x), winograd_operands(Wt, bias)
    t_d = device_ms(lambda: winograd_conv3x3_cuda(xp, *ops), ("winograd_kernel",), n=5)
    b_ms, _ = winograd_bound(1, rows, side, 32, 32)
    log(f"[2] winograd Conv_1 on a haloed tile's shape (1, {rows}, {side}, 32 -> 32): kernel "
        f"device {t_d:.3f} ms; bound {b_ms:.3f} ms, {100 * b_ms / t_d:.1f}% of it")
    times["winograd_conv3x3"] = dict(tile_shape=[1, rows, side, 32, 32], tile_ms=t_d,
                                     tile_bound_ms=b_ms)
    return times


class _BatchNormStats:
    """Records the (mean, var) that every `_BatchNorm.normalize` call gets
    while active."""

    def __init__(self):
        from cell_image_analysis_tpu_torch.models import cae

        self.cls, self.real, self.seen = cae._BatchNorm, cae._BatchNorm.normalize, []

    def __enter__(self):
        real, seen = self.real, self.seen

        def record(bn, x, mean, var):
            seen.append((mean.detach().clone(), var.detach().clone()))
            return real(bn, x, mean, var)

        self.cls.normalize = record
        return self

    def __exit__(self, *exc):
        self.cls.normalize = self.real


def _mesh_e(torch, dev, mesh, cells, source: str) -> dict:
    """(e) fit_cae on the mesh against fit_cae on one device from one init,
    3 epochs of phase 10's cells at phase 10's batch (32).  fit_cae runs
    cuDNN's deterministic algorithms (a second single-device run must equal
    the first), yet the free float32 runs drift apart as Adam and the batch
    statistics amplify the sums' other order; so the gates are (1) float64
    free runs over the same batches on PyTorch's own convolutions, mesh
    against one shard (a fault moves them at the 1e-1 level; on cuDNN a
    ReLU sign flip that Adam amplifies moves them at 1e-3: printed, not
    gated),
    (2) every float32 step from the one-device
    run's weights: the loss and each leaf's gradient, and the first step's
    BatchNorm statistics, and (3) fit_cae itself at
    tests/test_sharded_training.py's workload and gates (80 cells, batch
    16)."""
    import copy

    from cell_image_analysis_tpu_torch.config import AugmentConfig, CAEConfig, TrainConfig
    from cell_image_analysis_tpu_torch.models.cae import init_cae
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
    from cell_image_analysis_tpu_torch.train import trainer

    X = torch.as_tensor(np.asarray(cells, np.float32), device=dev).reshape(-1, 64, 64, 1)
    aug = AugmentConfig()
    cfg = TrainConfig(epochs=MESH_TRAIN_EPOCHS)

    def gaps(a, b):
        """(largest relative history difference, largest weight difference)."""
        (sa, ha, _), (sb, hb, _) = a, b
        rel = max(abs(x - y) / abs(y) for k in ("loss", "val_loss") for x, y in zip(ha[k], hb[k]))
        return rel, max(float((sa[k].double() - sb[k].double()).abs().max()) for k in sb)

    def train(m, x=X, tcfg=cfg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, state, hist = trainer.fit_cae(x, CAEConfig(), tcfg, aug, verbose=False, mesh=m)
        torch.cuda.synchronize()
        return state, hist.history, time.perf_counter() - t

    # the batches fit_cae draws, for the hand-stepped runs
    X_train, _ = trainer.train_test_split(X, cfg.val_split, cfg.seed)
    bs, rng = cfg.batch_size, np.random.default_rng(cfg.seed)
    steps = len(X_train) // bs
    batches = [torch.as_tensor(row, device=dev) for _ in range(cfg.epochs)
               for row in rng.permutation(len(X_train))[:steps * bs].reshape(steps, bs)]
    one = virtual_mesh(dev, 1)

    def fresh(dtype):
        model = init_cae(torch.Generator().manual_seed(cfg.seed)).to(dev, dtype)
        model.train()
        return model, trainer.make_optimizer(CAEConfig(), model.parameters())

    def free_run(m, dtype):
        model, opt = fresh(dtype)
        reps, gen = trainer._Replicas(model, m), torch.Generator().manual_seed(1)
        losses = torch.stack([trainer._step(reps, opt, X_train[i].to(dtype), gen, aug)[0]
                              for i in batches])
        return losses.cpu().numpy(), model.state_dict()

    def grads(m, model, batch, gen_state):
        """(loss, gradients) of one step on `m` from `model`'s weights."""
        model = copy.deepcopy(model)
        opt = trainer.make_optimizer(CAEConfig(), model.parameters())
        opt.step = lambda: None
        gen = torch.Generator()
        gen.set_state(gen_state)
        loss, _ = trainer._step(trainer._Replicas(model, m), opt, batch, gen, aug)
        return loss, [p.grad for p in model.parameters()]

    deterministic = torch.backends.cudnn.deterministic   # for the hand-stepped runs
    torch.backends.cudnn.deterministic = True
    try:
        runs = {name: train(m) for name, m in
                (("one device", None), ("control", None), ("mesh", mesh))}
        small = {name: train(m, X[:MESH_TRAIN_CELLS], TrainConfig(
            epochs=MESH_TRAIN_EPOCHS, batch_size=MESH_TRAIN_BATCH)) for name, m in
            (("one device", None), ("mesh", mesh))}
        # float64 on cuDNN, printed beside the gate; then the mesh's logic on
        # PyTorch's own convolutions, gated (F64_LOSS_GATE's note)
        (c64_one, cs64_one), (c64_mesh, cs64_mesh) = (free_run(m, torch.float64)
                                                      for m in (one, mesh))
        enabled = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            (l64_one, s64_one), (l64_mesh, s64_mesh) = (free_run(m, torch.float64)
                                                        for m in (one, mesh))
        finally:
            torch.backends.cudnn.enabled = enabled
        # float32, each step from the one-device run's weights
        model, opt = fresh(torch.float32)
        reps, gen = trainer._Replicas(model, one), torch.Generator().manual_seed(1)
        loss_rel, grad_rel = [], []
        for k, i in enumerate(batches):
            batch, state = X_train[i], gen.get_state()
            with _BatchNormStats() as st1:
                l1, g1 = grads(one, model, batch, state)
            with _BatchNormStats() as st4:
                l4, g4 = grads(mesh, model, batch, state)
            if k == 0:
                n_bn = len(st1.seen)
                bn_rel = max(float((a - b).abs().max() / b.abs().max())
                             for i_bn, (m1, v1) in enumerate(st1.seen)
                             for s in range(MESH_SHARDS)
                             for a, b in zip(st4.seen[i_bn * MESH_SHARDS + s], (m1, v1)))
            loss_rel.append((l4 - l1).abs() / l1.abs())
            whole = (torch.cat([(a - b).flatten() for a, b in zip(g4, g1)]).norm()
                     / torch.cat([b.flatten() for b in g1]).norm())
            grad_rel.append(torch.stack([whole] + [(a - b).norm() / b.norm()
                                                   for a, b in zip(g4, g1)]))
            trainer._step(reps, opt, batch, gen, aug)
        loss_rel = torch.stack(loss_rel).cpu().numpy()
        grad_rel = torch.stack(grad_rel).cpu().numpy()
        whole_rel, grad_rel = grad_rel[:, 0], grad_rel[:, 1:]
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    (s1, h1, t1), (s0, h0, _), (s2, h2, t2) = (runs[k] for k in ("one device", "control", "mesh"))
    if h0 != h1 or any(not torch.equal(s0[k], s1[k]) for k in s1):
        raise AssertionError("[12] (e) two single-device runs differ under deterministic cuDNN")
    rel, w = gaps(runs["mesh"], runs["one device"])
    rel_small, w_small = gaps(small["mesh"], small["one device"])
    rel64 = np.abs(l64_mesh - l64_one) / np.abs(l64_one)
    l64 = float(rel64.max())
    gap64 = {k: float((s64_mesh[k] - s64_one[k]).abs().max()) for k in s64_one}
    w64, worst64 = max((v, k) for k, v in gap64.items())
    c64 = float((np.abs(c64_mesh - c64_one) / np.abs(c64_one)).max())
    cw64, cworst64 = max((float((cs64_mesh[k] - cs64_one[k]).abs().max()), k) for k in cs64_one)
    names = [n for n, _ in model.named_parameters()]
    worst_leaf = names[int(np.argmax(grad_rel.max(axis=0)))]
    worst_w = max(s1, key=lambda k: float((s2[k].double() - s1[k].double()).abs().max()))
    log(f"[12] (e) fit_cae on {len(cells)} cells ({source}), batch {bs}, {MESH_TRAIN_EPOCHS} "
        f"epochs, {len(batches)} steps, cuDNN deterministic: one "
        f"device {t1:.2f} s (a second run equal bit for bit), mesh {t2:.2f} s, the free float32 "
        f"runs {rel:.3e} apart in the histories and {w:.3e} in the weights (largest at "
        f"{worst_w}); tests/test_sharded_training.py's gates 2e-3 / 2e-2 there: "
        f"{'met' if rel <= 2e-3 and w <= 2e-2 else 'not met'} (not gated: see below)")
    log(f"[12] (e) loss one device {h1['loss']} / mesh {h2['loss']}; val_loss {h1['val_loss']} "
        f"/ {h2['val_loss']}")
    log(f"[12] (e) float64 free runs over the same {len(batches)} batches, PyTorch's own "
        f"convolutions, mesh against one shard: losses within {l64:.3e} (relative; gate {F64_LOSS_GATE:.0e}), at steps "
        + ", ".join(f"{k + 1}: {rel64[k]:.1e}" for k in sorted({0, 9, 49, 99, len(rel64) - 1})
                    if k < len(rel64))
        + f"; weights within {w64:.3e} (gate {F64_WEIGHT_GATE:.0e}, largest at {worst64}); "
        f"the same runs on cuDNN (not gated: F64_LOSS_GATE's note): losses within {c64:.3e}, "
        f"weights within {cw64:.3e} (largest at {cworst64})")
    log(f"[12] (e) float32, each of the {len(batches)} steps from the one-device run's weights: "
        f"loss within {float(loss_rel.max()):.3e} (gate {STEP_LOSS_GATE:.0e}), the gradient "
        f"within {float(whole_rel.max()):.3e} of its norm (gate {STEP_GRAD_GATE:.0e}), each "
        f"leaf's within {float(grad_rel.max()):.3e} of its norm (gate {STEP_LEAF_GATE:.0e}; "
        f"largest at {worst_leaf}, median over steps and leaves {float(np.median(grad_rel)):.3e});"
        f" first step's BatchNorm statistics, {n_bn} layers, each shard's within "
        f"{bn_rel:.3e} of the batch's (gate {BN_STATS_GATE:.0e})")
    log(f"[12] (e) fit_cae at tests/test_sharded_training.py's workload ({MESH_TRAIN_CELLS} "
        f"cells, batch {MESH_TRAIN_BATCH}): histories within {rel_small:.3e} (gate 2e-3), "
        f"weights within {w_small:.3e} (gate 2e-2)")
    failed = [what for what, ok in (
        ("float64 losses", l64 <= F64_LOSS_GATE), ("float64 weights", w64 <= F64_WEIGHT_GATE),
        ("step losses", float(loss_rel.max()) <= STEP_LOSS_GATE),
        ("step gradients", float(whole_rel.max()) <= STEP_GRAD_GATE),
        ("step leaves", float(grad_rel.max()) <= STEP_LEAF_GATE),
        ("BatchNorm statistics", bn_rel <= BN_STATS_GATE),
        ("small histories", rel_small <= 2e-3), ("small weights", w_small <= 2e-2)) if not ok]
    if failed:
        raise AssertionError(f"[12] (e) the mesh's training left the single-device run: {failed}")
    return dict(cells=len(cells), steps=len(batches), seconds_one=t1, seconds_mesh=t2,
                hist_rel=rel, weights_abs=w, f64=(l64, w64), f64_cudnn=(c64, cw64),
                step_loss=float(loss_rel.max()), step_grad=float(whole_rel.max()),
                step_leaf=float(grad_rel.max()),
                bn_stats=bn_rel, small=(rel_small, w_small))


def phase_mesh(torch, dev, unet_vars, seg_cfg, stage_a, segs, greens, params_model,
               tmp_root: str, train_cells=None) -> dict:
    """Phase 12 (see the module docstring); returns each kernel's launches
    on each route, the plate's and the training's numbers.
    `train_cells` are phase 10's; without them (e) takes the cells the 16
    frames give."""
    import gc

    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.ops.extract import extract_cells_frames

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh_for_smoke(torch)
    backend = StarDistBackend(unet_vars, seg_cfg, device=dev)
    launches = _mesh_a(torch, mesh, backend, stage_a, segs, greens, params_model)
    launches["b"] = _mesh_b(torch, dev, mesh, params_model)
    launches["c"] = _mesh_c(torch, dev, mesh, unet_vars, params_model)
    torch.cuda.empty_cache()
    d_launches, plate = _mesh_d(torch, dev, mesh, unet_vars, tmp_root)
    launches.update(d_launches)
    source = "phase 10's"
    if train_cells is None:
        train_cells = extract_cells_frames(segs, greens, backend,
                                           fallback_segment_fn=backend.exact_twin(), **stage_a)[0]
        source = "the 16 frames', phase 10 not run"
    training = _mesh_e(torch, dev, mesh, train_cells, source)
    per_kernel = {k: {route: n[k] for route, n in launches.items()} for k in _kernel_modules()}
    return dict(launches=per_kernel, plate=plate, training=training,
                mesh=[str(d) for d in mesh.devices])

# ------------------------------------------------------ phase 13: the bench --

def _bench_batch_held(torch, dev, backend: str, frames: np.ndarray, needed: tuple) -> tuple:
    """The bench's first batch (frames 0-15) through the bench's own
    pipeline, every kernel call held against its plain version, the counts
    set to 0 before and read after; returns ((scores, stats), launches)."""
    from cell_image_analysis_tpu_torch.utils import bench

    model, params, _ = bench._fit_params(device=dev)
    run, _, fallback = bench._batch_pipeline(model, params, backend, dev)
    first = frames[:bench.FRAME_BATCH]
    segs = torch.tensor(first[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(first[..., 1].astype(np.float32), device=dev)
    (_, result), launches, _ = _counted(torch, lambda: run(segs, greens), needed,
                                        f"[13] {backend} bench batch 0")
    if fallback.calls:
        raise AssertionError(f"[13] {backend}: the held batch fell back to the exact twin")
    return result, launches


def _start_subprocess(args: list) -> tuple:
    return (subprocess.Popen([sys.executable, *args], cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True), time.perf_counter())


def _check_subprocess(started: tuple, metric: str, tag: str) -> dict:
    """Waits for a bench entry point started by `_start_subprocess`: exit 0
    and one JSON line of `metric` on stdout."""
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"[13] {tag} exited {proc.returncode}:\n{stdout[-2000:]}\n"
                             f"{stderr[-2000:]}")
    out = json.loads(lines[0])
    if out["metric"] != metric or not out["value"] > 0:
        raise AssertionError(f"[13] {tag}: {lines[0]}")
    log(f"[13] {tag}: exit 0 in {time.perf_counter() - t0:.1f} s: {lines[0]} "
        f"({stderr.strip().splitlines()[-1]})")
    return out


def phase_bench(torch, dev, frames_path: str, phase3=None) -> dict:
    """Phase 13: the port's bench and parity harness on the card.  (a)
    `run_bench` for both backends on the 48 frames the worker made (3
    batches of 16 in flight, two warm-ups, best of 2), the counts set to 0
    before each and read after; no batch may fall back to the exact twin;
    the first batch again through the bench's pipeline with every kernel
    call held against its plain version, StarDist's equal to phase 3's
    result (`phase3`: (result, frames' SHA-1)): the same cells and areas,
    scores within TOL; (b) `run_train_bench` at 2,048 cells and 12 epochs;
    (c) `measure_parity` on the three workloads of JAX's
    tests/test_parity.py, each with `cell_count_match` and a max deviation
    below PARITY_GATE, the `fit_on_extracted` one with a rate in (0, 0.9);
    (d) `cli bench` and `bench_torch.py --mode train` in subprocesses at
    their defaults, the first started before (c) so that its frames are
    made meanwhile (their timings are printed, not gated).  Returns each
    kernel's launches of (a)."""
    import gc

    from cell_image_analysis_tpu_torch.utils import bench
    from cell_image_analysis_tpu_torch.utils.parity import compare_screens, measure_parity

    gc.collect()
    torch.cuda.empty_cache()
    frames = np.load(frames_path)
    smi = smi_line()
    log(f"[13] {bench.BASELINE_NOTE}")
    out = {"launches": {}, "batch_launches": {}}
    needed = {"stardist": ("winograd_conv3x3", "segment_sum", "clahe_cells"),
              "threshold": ("segment_sum", "clahe_cells")}
    for backend in ("stardist", "threshold"):
        report = {}
        torch.cuda.synchronize()
        _reset_launches()
        line = bench.run_bench(n_frames=BENCH_FRAMES, size=FRAME_SIZE, n_cells=FRAME_CELLS,
                               backend=backend, device=dev, frames=frames, report=report)
        launches = _read_launches()
        log(f"[13] {line} [{smi}]")
        log(f"[13] {backend}: best run {report['cells']} cells in {report['seconds']:.4f} s "
            f"({report['frames_per_sec']:.2f} frames/s), {BENCH_FRAMES} frames of "
            f"{FRAME_SIZE}^2 in {-(-BENCH_FRAMES // bench.FRAME_BATCH)} batches of "
            f"{bench.FRAME_BATCH} all started before the first wait; the three pending handles "
            f"held {report['pending_gib']:.3f} GiB, peak {report['peak_gib']:.3f} GiB; batches "
            f"that fell back to the exact twin: {report['fallback_batches']} of "
            f"{report['batches_run']}; launches (two warm-ups and two timed runs) {launches} "
            f"[{smi}]")
        if report["fallback_batches"]:
            raise AssertionError(f"[13] {backend}: batches fell back at the bench's capacities")
        missing = [k for k in needed[backend] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"[13] {backend} bench: kernels not launched: {missing}")
        out["launches"][backend] = launches
        out[backend] = json.loads(line)
        result, out["batch_launches"][backend] = _bench_batch_held(torch, dev, backend, frames,
                                                                   needed[backend])
        if backend == "stardist" and phase3 is not None:
            ref, sha = phase3
            if hashlib.sha1(frames[:bench.FRAME_BATCH].tobytes()).hexdigest() != sha:
                raise AssertionError("[13] the bench's first 16 frames are not phase 3's")
            _, params, _ = bench._fit_params(device=dev)
            rep = compare_screens(ref, result, {}, float(params.ensemble_mse_threshold), tol=TOL)
            log(f"[13] stardist bench batch 0 = phase 3's frames: the same {rep['n_cells']} "
                f"cells and areas, max score difference {rep['max_score_diff']:.3e} (gate {TOL})")
        elif backend == "stardist":
            log("[13] phase 3 not run: the bench's first batch is not compared with it")

    report = {}
    line = bench.run_train_bench(device=dev, report=report)
    log(f"[13] {line} [{smi}]")
    log(f"[13] train bench: {report['cells']} train cells ({report['steps']} steps x "
        f"{report['cells'] // (report['steps'] * report['epochs'])} x {report['epochs']} "
        f"epochs) in {report['seconds']:.3f} s [{smi}]")
    out["train"] = json.loads(line)

    # (d)'s `cli bench` makes its 8 frames on the host (~40 s) while (c)
    # and the train bench's subprocess run; its timed part comes after theirs
    cli = _start_subprocess(["-m", f"{PKG}.cli", "bench"])
    try:
        for name, kw in PARITY_WORKLOADS:
            t0 = time.perf_counter()
            res = measure_parity(device=dev, **kw)
            log(f"[13] parity, {name} ({kw}): {json.dumps(res)}; "
                f"{time.perf_counter() - t0:.1f} s")
            if not (res["cell_count_match"] and res["max_deviation"] < PARITY_GATE):
                raise AssertionError(f"[13] parity {name}: cell count match "
                                     f"{res['cell_count_match']}, max deviation "
                                     f"{res['max_deviation']} (gate {PARITY_GATE})")
            if kw.get("fit_on_extracted"):
                rates = [v for k, v in res["device"].items() if k.endswith("rate")]
                if not any(0.0 < r < 0.9 for r in rates):
                    raise AssertionError(f"[13] parity {name}: saturated rates {rates}")
        _check_subprocess(_start_subprocess(["bench_torch.py", "--mode", "train"]),
                          "cae_train_cells_per_sec_per_chip", "bench_torch.py --mode train")
        _check_subprocess(cli, "screening_cells_per_sec_per_chip_stardist", "cli bench")
    finally:
        if cli[0].poll() is None:
            cli[0].kill()
            cli[0].wait()
    return out


# ----------------------------------------- phase 14: processes, phase 15 --

def _script(name: str):
    """A script of the repository's `scripts/` as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dist_run(dryrun, out: str, extra: list) -> tuple:
    """`scripts/dryrun_dist_torch.py` in a subprocess, its gloo processes on
    cuda:0 with DIST_LOCAL_SHARDS shards each; returns (each worker's JSON,
    wall seconds)."""
    cmd = [sys.executable, dryrun.__file__, "--device", "cuda:0", "--backend", "gloo",
           "--local-shards", str(DIST_LOCAL_SHARDS),
           "--timeout", str(DIST_TIMEOUT), "--out", out, *extra]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DIST_TIMEOUT + 60)
    wall = time.perf_counter() - t
    log("\n".join(f"[14] {line}" for line in proc.stdout.strip().splitlines()[-16:]))
    if proc.returncode != 0:
        raise AssertionError(f"[14] {' '.join(cmd[1:])} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    results = []
    for r in range(dryrun.N_PROCS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, wall


def _dist_launches(results: list, key: str, needed: tuple) -> dict:
    """Each worker's launches in its timed run, by the kernels' row names;
    fails if a worker did not launch a kernel of `needed`."""
    names = {"winograd": "winograd_conv3x3", "segsum": "segment_sum",
             "clahe_kernel": "clahe_cells", "cc": "cc_tile_labels", "kthvalue": "kthvalue_radix"}
    per = [{names[k]: v for k, v in r[key]["launches"].items()} for r in results]
    for r, launches in enumerate(per):
        missing = [k for k in needed if launches[k] <= 0]
        if missing:
            raise AssertionError(f"[14] worker {r} did not launch {missing} ({key})")
    return {k: sum(p[k] for p in per) for k in per[0]}


def phase_dist(torch, dev, unet_vars, seg_cfg, stage_a, segs, greens, tmp_root: str,
               phase3=None) -> dict:
    """Phase 14 (see the module docstring); returns each kernel's launches
    in the workers' timed runs, summed over the workers, and the runs'
    numbers."""
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend
    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    dryrun = _script("dryrun_dist_torch")
    if phase3 is None:
        model, params = load_scoring_params(device=dev)
        phase3 = score_frames_fused(model, params, segs, greens,
                                    StarDistBackend(unet_vars, seg_cfg, device=dev),
                                    chunk=32, caps=(64, 96), **stage_a)
        log("[14] phase 3 not run: its single-process result was made here")
    frames = os.path.join(tmp_root, "dist_frames.npz")
    np.savez(frames, segs=segs.cpu().numpy(), greens=greens.cpu().numpy())
    smi = smi_line()
    out = {}
    # StarDist: phase 3's 16 frames, each process its 8 over its own shards
    sd_dir = os.path.join(tmp_root, "dist_stardist")
    results, wall = _dist_run(dryrun, sd_dir, ["--stardist", frames])
    got = [dryrun.read_result(os.path.join(sd_dir, f"rank{r}.npz")) for r in range(dryrun.N_PROCS)]
    for r in range(1, dryrun.N_PROCS):
        _assert_sharded_equal(got[0], got[r], f"[14] worker {r} against worker 0")
    _assert_sharded_equal(phase3, got[0], f"[14] StarDist, {dryrun.N_PROCS} processes x "
                                          f"{DIST_LOCAL_SHARDS} shards against phase 3")
    launches = _dist_launches(results, "stardist",
                              ("winograd_conv3x3", "segment_sum", "clahe_cells"))
    out["stardist"] = dict(wall=wall, seconds=[r["stardist"]["seconds"] for r in results],
                           peak_gib=[r["peak_gib"] for r in results], launches=launches,
                           cells=results[0]["stardist"]["cells"])
    log(f"[14] StarDist over {dryrun.N_PROCS} processes on cuda:0 (gloo): "
        f"{results[0]['stardist']['cells']} cells, the timed run "
        f"{', '.join(f'{s:.3f}' for s in out['stardist']['seconds'])} s a worker, the call "
        f"{wall:.1f} s (interpreters, build check, loads and the warm-up run included), peak "
        f"memory {', '.join(f'{g:.2f}' for g in out['stardist']['peak_gib'])} GiB a worker; "
        f"launches {launches} [{smi}]")
    # threshold at JAX's dryrun size (the CC kernel), the three checks of
    # scripts/dryrun_dcn.py
    th_dir = os.path.join(tmp_root, "dist_threshold")
    results, wall = _dist_run(dryrun, th_dir, [])
    launches_th = _dist_launches(results, "fused",
                                 ("segment_sum", "clahe_cells", "cc_tile_labels"))
    r0 = results[0]
    out["threshold"] = dict(wall=wall, seconds=[r["fused"]["seconds"] for r in results],
                            peak_gib=[r["peak_gib"] for r in results], launches=launches_th,
                            counts=r0["counts"], score_cells=r0["score_cells"]["counts"],
                            fused=r0["fused"]["counts"], cells=r0["fused"]["cells"])
    log(f"[14] threshold backend over {dryrun.N_PROCS} processes on cuda:0 (gloo), the checks "
        f"of scripts/dryrun_dcn.py: masked counts {r0['counts']}; score_cells counts "
        f"{r0['score_cells']['counts']} (cons/mod/ens/fft of {r0['score_cells']['cells']} "
        f"cells); score_frames_fused {r0['fused']['cells']} cells, counts "
        f"{r0['fused']['counts']}, each equal to the worker's single-process run; the timed run "
        f"{', '.join(f'{s:.3f}' for s in out['threshold']['seconds'])} s a worker, the call "
        f"{wall:.1f} s, peak memory "
        f"{', '.join(f'{g:.2f}' for g in out['threshold']['peak_gib'])} GiB a worker; launches "
        f"{launches_th} [{smi}]")
    out["launches"] = {k: {"stardist": launches[k], "threshold": launches_th[k]}
                       for k in launches}
    return out


def _step_gaps(torch, trainer, model, batch, gen_state, aug, devices) -> tuple:
    """One float32 step of `trainer._step` from `model`'s weights on each of
    `devices` (card, CPU) with the same generator state: (relative loss
    difference, the gradient's difference over its norm, each leaf's)."""
    import copy

    from cell_image_analysis_tpu_torch.config import CAEConfig
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh

    losses, grads = [], []
    for d in devices:
        m = copy.deepcopy(model).to(d)
        opt = trainer.make_optimizer(CAEConfig(), m.parameters())
        opt.step = lambda: None
        gen = torch.Generator()
        gen.set_state(gen_state)
        loss, _ = trainer._step(trainer._Replicas(m, virtual_mesh(d, 1)), opt, batch.to(d),
                                gen, aug)
        losses.append(float(loss))
        grads.append([p.grad.detach().cpu() for p in m.parameters()])
    (l1, l0), (g1, g0) = losses, grads
    whole = float(torch.cat([(a - b).flatten() for a, b in zip(g1, g0)]).norm()
                  / torch.cat([b.flatten() for b in g0]).norm())
    leaves = [float((a - b).norm() / b.norm()) for a, b in zip(g1, g0)]
    return abs(l1 - l0) / abs(l0), whole, leaves


def phase_round_trip(torch, dev, unet_vars, tmp_root: str) -> dict:
    """Phase 15 (see the module docstring)."""
    from cell_image_analysis_tpu_torch.config import (
        AugmentConfig,
        CAEConfig,
        ExtractConfig,
        PipelineConfig,
        SegConfig,
        TrainConfig,
    )
    from cell_image_analysis_tpu_torch.models.cae import init_cae
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu_torch.pipeline.training import ImprovedAnomalyDetectionTraining
    from cell_image_analysis_tpu_torch.train import augment, trainer
    from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

    t_phase = time.perf_counter()
    frames, size, n_cells, epochs = ROUND_TRIP
    root = os.path.join(tmp_root, "round_trip")
    folders = {"train": (frames, 0.0, 11), "wildtype": (2, 0.0, 12), "mutantA": (2, 0.7, 13)}
    for name, (n, mutant, seed) in folders.items():
        make_dataset(os.path.join(root, name), n_frames=n, size=size, n_cells=n_cells,
                     mutant_fraction=mutant, seed=seed)
    cfg = PipelineConfig(seg=SegConfig(max_candidates=256, raster_patch=96, raster_cap=128),
                         extract=ExtractConfig(cell_capacity=128),
                         train=TrainConfig(epochs=epochs, min_cells=30))
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t = time.perf_counter()
        out = os.path.join(root, f"model_{name}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            tr = ImprovedAnomalyDetectionTraining(out, cfg, unet_vars, device=d)
            cells, stats = tr.create_training_dataset(os.path.join(root, "train"))
            model, best, history = tr.train_autoencoder(cells, figures=False)
            mse, mae = tr.evaluate_reconstruction_quality(model, cells, figures=False)
            tr.create_anomaly_detector(model, best, cells, mse)
            tr.generate_final_report(stats, history, mse, mae)
            screener = ProductionMutantScreening(out, cfg, unet_vars, device=d)
            results, _ = screener.screen_mutant_samples(
                {s: os.path.join(root, s) for s in ("wildtype", "mutantA")},
                os.path.join(root, f"screen_{name}"), figures=False)
        runs[name] = dict(cells=cells, areas=np.array([s["area"] for s in stats]),
                          history=history.history, results=results,
                          seconds=time.perf_counter() - t)
    card, cpu = runs["card"], runs["cpu"]
    # (a) extraction: phase 10's rule
    if len(card["cells"]) != len(cpu["cells"]) or len(cpu["cells"]) < cfg.train.min_cells:
        raise AssertionError(f"[15] {len(card['cells'])} cells extracted on the card, "
                             f"{len(cpu['cells'])} on the CPU")
    same = card["areas"] == cpu["areas"]
    worst = float(np.abs(card["cells"][same] - cpu["cells"][same]).max())
    if int((~same).sum()) > 2 or worst > TOL:
        raise AssertionError(f"[15] extraction: {int((~same).sum())} cells of other area, the "
                             f"rest within {worst:.3e}")
    log(f"[15] extraction from {frames} frames of {size}^2: {len(cpu['cells'])} cells on both, "
        f"{int((~same).sum())} of other area, the rest within {worst:.3e} (gate {TOL})")

    # (b) float64 free runs over fit_cae's batches and draws, card against CPU
    X = torch.as_tensor(cpu["cells"][..., None])
    X_train, _ = trainer.train_test_split(X, cfg.train.val_split, cfg.train.seed)
    bs, rng = cfg.train.batch_size, np.random.default_rng(cfg.train.seed)
    steps = len(X_train) // bs
    batches = [torch.as_tensor(row) for _ in range(epochs)
               for row in rng.permutation(len(X_train))[:steps * bs].reshape(steps, bs)]
    aug = AugmentConfig()

    def free_run(d, dtype):
        gen = torch.Generator().manual_seed(cfg.train.seed)   # fit_cae's draws
        model = init_cae(gen).to(d, dtype)
        model.train()
        opt = trainer.make_optimizer(CAEConfig(), model.parameters())
        reps, xd = trainer._Replicas(model, virtual_mesh(d, 1)), X_train.to(d, dtype)
        losses = torch.stack([trainer._step(reps, opt, xd[i.to(d)], gen, aug)[0]
                              for i in batches])
        return losses.cpu().numpy(), {k: v.cpu() for k, v in model.state_dict().items()}

    (l64_card, s64_card), (l64_cpu, s64_cpu) = (free_run(d, torch.float64)
                                                for d in (dev, torch.device("cpu")))
    rel64 = np.abs(l64_card - l64_cpu) / np.abs(l64_cpu)
    gap64 = {k: float((s64_card[k] - s64_cpu[k]).abs().max()) for k in s64_cpu}
    w64, worst64 = max((v, k) for k, v in gap64.items())
    # (c) float32 single steps from the CPU run's weights, and the warp
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = init_cae(gen)
    model.train()
    opt = trainer.make_optimizer(CAEConfig(), model.parameters())
    reps = trainer._Replicas(model, virtual_mesh("cpu", 1))
    loss_rel, whole_rel, leaf_rel = [], [], []
    for k, i in enumerate(batches):
        batch, state = X_train[i], gen.get_state()
        if k == 0:
            probe = torch.Generator()
            probe.set_state(state)
            params = augment.sample_params(probe, bs, aug)
            if not torch.equal(augment.warp_batch(batch.to(dev), params).cpu(),
                               augment.warp_batch(batch, params)):
                raise AssertionError("[15] the card's warp of a batch is not the CPU's")
        lr_, wr, lv = _step_gaps(torch, trainer, model, batch, state, aug,
                                 (dev, torch.device("cpu")))
        loss_rel.append(lr_)
        whole_rel.append(wr)
        leaf_rel.append(lv)
        trainer._step(reps, opt, batch, gen, aug)
    leaf_rel = np.array(leaf_rel)
    names = [n for n, _ in model.named_parameters()]
    worst_leaf = names[int(np.argmax(leaf_rel.max(axis=0)))]
    log(f"[15] float64 free runs over fit_cae's {len(batches)} batches and draws (augmentation "
        f"on), card against CPU: losses within {float(rel64.max()):.3e} (relative; gate "
        f"{F64_LOSS_GATE:.0e}), weights within {w64:.3e} (gate {F64_WEIGHT_GATE:.0e}, largest "
        f"at {worst64}); a batch warped on the card equals the CPU's bit for bit")
    log(f"[15] float32, each of the {len(batches)} steps from the CPU run's weights: loss within "
        f"{max(loss_rel):.3e} (gate {STEP_LOSS_GATE:.0e}), the gradient within "
        f"{max(whole_rel):.3e} of its norm (gate {STEP_GRAD_GATE:.0e}), each leaf's within "
        f"{float(leaf_rel.max()):.3e} (gate {STEP_LEAF_GATE:.0e}; largest at {worst_leaf})")
    # (d) the float32 fit_cae runs of the round trip
    hc, hp = card["history"], cpu["history"]
    log(f"[15] fit_cae, {epochs} epochs on {len(cpu['cells'])} cells: card val_loss "
        f"{[round(v, 6) for v in hc['val_loss']]} lr {hc['lr']}; CPU val_loss "
        f"{[round(v, 6) for v in hp['val_loss']]} lr {hp['lr']}")
    # the stores' screening, printed side by side (not gated)
    for s in ("wildtype", "mutantA"):
        rc, rp = card["results"][s], cpu["results"][s]
        log(f"[15] {s}: {rc['total_cells']} / {rp['total_cells']} cells (card / CPU store); "
            "rates " + ", ".join(f"{k} {rc[f'{k}_anomaly_rate']:.4f} / "
                                 f"{rp[f'{k}_anomaly_rate']:.4f}"
                                 for k in ("conservative", "moderate", "ensemble", "fft")))
    seconds = time.perf_counter() - t_phase
    log(f"[15] round trip: card {card['seconds']:.1f} s, CPU {cpu['seconds']:.1f} s, the "
        f"phase {seconds:.1f} s [{smi_line()}]")
    failed = [what for what, ok in (
        ("float64 losses", float(rel64.max()) <= F64_LOSS_GATE),
        ("float64 weights", w64 <= F64_WEIGHT_GATE),
        ("step losses", max(loss_rel) <= STEP_LOSS_GATE),
        ("step gradients", max(whole_rel) <= STEP_GRAD_GATE),
        ("step leaves", float(leaf_rel.max()) <= STEP_LEAF_GATE),
        ("epochs run", len(hc["loss"]) == len(hp["loss"])),
        ("lr history", hc["lr"] == hp["lr"])) if not ok]
    if failed:
        raise AssertionError(f"[15] the card's training left the CPU's: {failed}; card history "
                             f"{hc}; CPU history {hp}")
    return dict(cells=len(cpu["cells"]), steps=len(batches), f64=(float(rel64.max()), w64),
                step_loss=max(loss_rel), step_grad=max(whole_rel),
                step_leaf=float(leaf_rel.max()), seconds=seconds,
                epochs=(len(hc["loss"]), len(hp["loss"])))


# ------------------------------------------------ phase 16: the plate rows --

def write_plate_frames(folder: str, size: int) -> tuple:
    """Worker process: the plate row's frames (`utils/bench._make_frames` at
    `PLATE_ROWS[size]`, one rng stream) and each frame's planted cells
    (centre row, centre column, short radius) into .npy files; returns
    their paths."""
    from cell_image_analysis_tpu_torch.utils.bench import PLATE_ROWS, _make_frames

    n_frames, n_cells, _ = PLATE_ROWS[size]
    planted = []
    frames = np.stack(_make_frames(n_frames, size, n_cells, planted=planted))
    paths = tuple(os.path.join(folder, f"plate{size}_{what}.npy") for what in ("frames", "planted"))
    np.save(paths[0], frames)
    np.save(paths[1], np.stack(planted))
    return paths


def _plate_batch(torch, dev, frames_path: str, size: int) -> dict:
    """Phase 2's input at the 4096^2 row's shapes: the row's first batch
    (`PLATE_ROWS`' frame batch) through the row's StarDist backend
    (`plate_settings`) and stage A, as `stage_a_buckets` gives them, with
    the label maps (segment sum's input) and the settings."""
    from cell_image_analysis_tpu_torch.utils import bench

    seg, kw = bench.plate_settings(size)
    fb = bench.PLATE_ROWS[size][2]
    frames = np.load(frames_path, mmap_mode="r")[:fb]
    segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
    greens = torch.tensor(frames[..., 1].astype(np.float32), device=dev)
    backend = bench.stardist_backend(device=dev, seg=seg)
    cand_kw = {k: kw[k] for k in ("label_capacity", "cell_capacity", "rcap")}
    out = stage_a_buckets(torch, backend, segs, greens, cand_kw)
    with torch.inference_mode():
        out.update(labels=backend(segs)[0], settings=(seg, kw), segs=segs)
    return out


def _plate_times(torch, dev, unet_vars, plate: dict) -> dict:
    """Phase 2's method at the 4096^2 row's shapes: Winograd's Conv_1 on
    (2, 4096, 4096, 32 -> 32) (random ReLU input, the committed weights)
    against its plain version (cuDNN fp32, also the library call), segment
    sum on the row's first batch's run table against `index_add_`, the
    fused CLAHE on that batch's size buckets, bit-equal; each kernel's
    device time, event-timed call, plain time and bound."""
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
    from cell_image_analysis_tpu_torch.ops.runs import run_moment_table
    from cell_image_analysis_tpu_torch.ops.winograd import (
        pad_input,
        winograd_conv3x3_plain,
        winograd_operands,
    )

    B, side = plate["labels"].shape[:2]
    res = {}
    Wt = torch.tensor(unet_vars["params"]["Conv_1"]["kernel"], device=dev)
    bias = torch.tensor(unet_vars["params"]["Conv_1"]["bias"], device=dev)
    x = torch.relu(torch.randn((B, side, side, 32), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev))
    xp, ops = pad_input(x), winograd_operands(Wt, bias)
    y = winograd_conv3x3_cuda(xp, *ops)
    ref = winograd_conv3x3_plain(x, Wt, bias)
    torch.cuda.synchronize()
    rel = float((y - ref).abs().max()) / float(ref.abs().max())
    del y, ref
    if not rel < 1e-5:
        raise AssertionError(f"[2] winograd Conv_1 at {(B, side, side, 32)}: relative error "
                             f"{rel:.3e} >= 1e-5")
    t_d = device_ms(lambda: winograd_conv3x3_cuda(xp, *ops), ("winograd_kernel",), n=5)
    t_k = time_ms(lambda: winograd_conv3x3_cuda(xp, *ops), n=3)
    t_p = time_ms(lambda: winograd_conv3x3_plain(x, Wt, bias), n=3)
    b_ms, b_by = winograd_bound(B, side, side, 32, 32)
    log(f"[2] winograd Conv_1 at the 4096^2 row's shape ({B}, {side}, {side}, 32 -> 32), "
        f"{x.numel():,} input elements: rel err {rel:.3e}; kernel device {t_d:.3f} ms, "
        f"wrapper call {t_k:.3f} ms; bound {b_ms:.3f} ms ({b_by}), {100 * b_ms / t_d:.1f}% of "
        f"it; plain (cuDNN fp32, the library call) {t_p:.3f} ms")
    res["winograd_conv3x3"] = dict(plate_shape=[B, side, side, 32, 32], plate_ms=t_d,
                                   plate_event_ms=t_k, plate_bound_ms=b_ms, plate_plain_ms=t_p,
                                   plate_library_ms=t_p, plate_max_rel_err=rel)
    del x, xp

    _, kw = plate["settings"]
    table = run_moment_table(plate["labels"], capacity=kw["label_capacity"], rcap=kw["rcap"])
    res["segment_sum"] = {f"plate_{k}": v for k, v in _segsum_check(
        torch, dev, table, "the 4096^2 row's first batch").items() if k != "bound_by"}
    res["kthvalue_radix"] = {f"plate_{k}": v for k, v in _kthvalue_check(
        torch, plate["segs"], (3.0, 99.8), "the 4096^2 row's first batch").items()
        if k != "bound_by"}
    row = _clahe_buckets(torch, plate, "4096^2 row's first batch")
    res["clahe_cells"] = dict(plate_cells=sum(int(ids.numel()) for ids, _, _ in plate["buckets"]),
                              plate_ms=row["ms"], plate_event_ms=row["event_ms"],
                              plate_bound_ms=row["bound_ms"], plate_plain_ms=row["plain_ms"],
                              plate_library_ms=None)
    return res


def _recall(torch, dev, segs, planted, probe) -> dict:
    """Per frame of a row, through the row's StarDist backend in its frame
    batches: the labels, the segmentation's overflow flags, the grid pixels
    and peaks above the probability threshold and the peaks below the K-th
    largest probability (cut by top-K without a flag,
    `scripts/probe_plate_cells.py`'s count), and the instances against the
    planted cells by that script's method (an instance of at least 200
    pixels finds the planted cell whose centre lies within the cell's short
    radius of its centroid)."""
    import torch.nn.functional as F

    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
    from cell_image_analysis_tpu_torch.ops.runs import regionprops_from_labels
    from cell_image_analysis_tpu_torch.utils import bench

    size = segs.shape[-1]
    seg, kw = bench.plate_settings(size)
    fb = bench.PLATE_ROWS[size][2]
    backend = bench.stardist_backend(device=dev, seg=seg)
    cfg = backend.cfg
    out = dict(labels=[], overflow=[], above=[], peaks=[], peaks_cut=[], found=0, missed=0,
               twice=0, without=0, instances=0)
    with torch.inference_mode():
        for i in range(0, segs.shape[0], fb):
            prob, _ = backend.model(normalize_percentile(
                segs[i:i + fb], pmin=cfg.norm_pmin, pmax=cfg.norm_pmax)[..., None])
            above = prob > cfg.prob_thresh
            peaks = (prob >= F.max_pool2d(prob[:, None], 3, 1, 1)[:, 0]) & above
            kth = torch.topk(prob.reshape(prob.shape[0], -1), cfg.max_candidates).values[:, -1]
            out["above"] += above.sum(dim=(1, 2)).tolist()
            out["peaks"] += peaks.sum(dim=(1, 2)).tolist()
            out["peaks_cut"] += (peaks & (prob < kth[:, None, None])).sum(dim=(1, 2)).tolist()
            del prob, above, peaks
            labels, ovf = backend(segs[i:i + fb])
            _, run_ovf = regionprops_from_labels(labels, capacity=kw["label_capacity"],
                                                 rcap=kw["rcap"])
            out["labels"] += labels.amax(dim=(1, 2)).tolist()
            out["overflow"] += (ovf | run_ovf).tolist()
            for b, lab in enumerate(labels.cpu().numpy()):
                m = probe.match(probe.centroids(lab), planted[i + b])
                out["instances"] += m["instances"]
                out["found"] += m["planted_found"]
                out["missed"] += m["planted_missed"]
                out["twice"] += m["planted_found_twice"]
                out["without"] += m["instances_without_a_cell"]
    return out


def phase_plates(torch, dev, plate_paths: dict) -> dict:
    """Phase 16: JAX's plate-scale rows (scripts/bench_2048.py,
    scripts/bench_4096.py) through `run_device_bench` at
    `scripts/bench_*_torch.py`'s defaults (`PLATE_ROWS`, `plate_settings`),
    the counts set to 0 before each row and read after; the timed run's
    geometry-passing labels of each frame against the cell capacity, and
    the row's instances against the planted cells; then the row's first batch through the
    bench's pipeline with every kernel call held against its plain version.
    Fails where a frame reaches its cell capacity, a kernel of the path did
    not launch or a held call differs.  Returns each row's numbers."""
    import gc

    from cell_image_analysis_tpu_torch.utils import bench

    gc.collect()
    torch.cuda.empty_cache()
    smi = smi_line()
    probe = _script("probe_plate_cells")
    needed = ("winograd_conv3x3", "segment_sum", "clahe_cells")
    out = {}
    for size, (frames_path, planted_path) in sorted(plate_paths.items()):
        tag = f"[16] {size}^2"
        n_frames, n_cells, fb = bench.PLATE_ROWS[size]
        seg_s, kw_s = bench.plate_settings(size)
        frames = np.load(frames_path)
        planted = np.load(planted_path)
        torch.cuda.synchronize()
        _reset_launches()
        res = bench.run_device_bench(n_frames=n_frames, size=size, n_cells=n_cells,
                                     backend="stardist", device=dev, frames=frames,
                                     frame_batch=fb)
        torch.cuda.synchronize()
        launches = _read_launches()
        line = bench.plate_line(size, res)
        runs = res["batches_run"]
        log(f"{tag} {line} [{smi}]")
        log(f"{tag}: {n_frames} frames of {n_cells} planted cells in batches of {fb} (all "
            f"started before the first wait), K {seg_s['max_candidates']}, raster cap "
            f"{seg_s['raster_cap']}, NMS pairs {seg_s['nms_max_pairs']}, cell capacity "
            f"{kw_s['cell_capacity']}, rcap {kw_s['rcap']}: best run {res['cells']} cells in "
            f"{res['seconds']:.4f} s = {res['cells_per_sec']:.2f} cells/s, "
            f"{res['frames_per_sec']:.3f} frames/s, "
            f"{res['frames_per_sec'] * size * size / 1e6:.1f} Mpx/s; pending handles "
            f"{res['pending_gib']:.3f} GiB, peak {res['peak_gib']:.3f} GiB; batches that fell "
            f"back to the exact twin: {res['fallback_batches']} of {runs} [{smi}]")
        log(f"{tag}: launches over the {runs} batch runs (two warm-ups, two timed runs) "
            f"{launches}, a batch " + ", ".join(f"{k} {v / runs:g}" for k, v in launches.items()))
        missing = [k for k in needed if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{tag}: kernels of the path were not launched: {missing}")

        segs = torch.tensor(frames[..., 2].astype(np.float32), device=dev)
        t0 = time.perf_counter()
        geo = _recall(torch, dev, segs, planted, probe)
        del segs
        top = max(res["geometry"])
        log(f"{tag}: labels a frame {geo['labels']} (label capacity {kw_s['label_capacity']}); "
            f"geometry-passing labels a frame in the timed run {res['geometry']}, largest {top} "
            f"against the cell capacity {kw_s['cell_capacity']} (JAX's row: 1024 at 4096^2); "
            f"segmentation or run overflow a frame {geo['overflow']}")
        log(f"{tag}: grid pixels above the probability threshold a frame {geo['above']}, "
            f"peaks {geo['peaks']}, peaks below the K-th ({seg_s['max_candidates']}) "
            f"probability, cut by top-K without a flag, {geo['peaks_cut']}")
        log(f"{tag}: planted cells {n_frames * n_cells}: found {geo['found']}, missed "
            f"{geo['missed']} ({100 * geo['missed'] / (n_frames * n_cells):.2f}%), found twice "
            f"{geo['twice']}; instances of >= {probe.MIN_AREA} px {geo['instances']}, "
            f"{geo['without']} without a planted cell ({time.perf_counter() - t0:.1f} s)")
        if top >= kw_s["cell_capacity"]:
            raise AssertionError(f"{tag}: a frame reached its cell capacity ({top} "
                                 f"geometry-passing labels, capacity {kw_s['cell_capacity']})")

        model, params, _ = bench._fit_params(device=dev)
        run, _, fallback = bench._batch_pipeline(model, params, "stardist", dev, size=size)
        segs = torch.tensor(frames[:fb, ..., 2].astype(np.float32), device=dev)
        greens = torch.tensor(frames[:fb, ..., 1].astype(np.float32), device=dev)
        (_, (scores, stats)), batch_launches, secs = _counted(
            torch, lambda: run(segs, greens), needed, f"{tag} batch 0 held")
        n = _check_result(scores, stats, fb)
        log(f"{tag} batch 0 held: {n} cells, fell back to the exact twin "
            f"{fallback.calls} time(s)")
        del segs, greens, model, params, run, frames
        gc.collect()
        torch.cuda.empty_cache()
        out[size] = dict(line=json.loads(line), launches=launches,
                         batch_launches=batch_launches, peak_gib=res["peak_gib"],
                         pending_gib=res["pending_gib"], fallback=res["fallback_batches"],
                         batches_run=runs, geometry_max=top, found=geo["found"],
                         missed=geo["missed"], peaks_cut=sum(geo["peaks_cut"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(str(p) for p in sorted(ALL_PHASES)),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params, load_unet_variables

    dev = torch.device("cuda", 0)
    seg_cfg = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
    stage_a = dict(label_capacity=128, cell_capacity=128, rcap=32)
    unet_vars = load_unet_variables()

    if 0 in phases:
        phase_env(torch)
    figures = importlib.util.find_spec("matplotlib") is not None
    log("[0] report packages: " + ", ".join(
        f"{m} {'importable' if importlib.util.find_spec(m) else 'not installed'}"
        for m in ("pandas", "matplotlib", "seaborn")))
    tmp_root = tempfile.mkdtemp(prefix="chip_smoke_")
    pool = None
    clock = {"start": time.perf_counter()}

    def mark(phase: str) -> None:
        """Seconds since the previous mark, under the phase's name."""
        now = time.perf_counter()
        clock[phase] = now - clock.pop("at", clock["start"])
        clock["at"] = now

    try:
        futures, bench_future, plate_futures = [], None, {}
        if phases & {7, 8, 9, 10, 13, 16}:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(max_workers=max(1, min(6, (os.cpu_count() or 2) - 2)),
                                       mp_context=multiprocessing.get_context("spawn"))
        if 16 in phases:
            # the 4096^2 row's frames first: phase 2 times the kernels on its first batch
            plate_futures[4096] = pool.submit(write_plate_frames, tmp_root, 4096)
        if 13 in phases:
            # the bench's 48 frames, one rng stream in one worker, first
            bench_frames = os.path.join(tmp_root, "bench_frames.npy")
            bench_future = pool.submit(write_bench_frames, bench_frames)
        if phases & {7, 8, 9, 10}:
            # the sample folders are written while phases 1-3 run
            futures, folders = start_sample_folders(pool, tmp_root)
        if 16 in phases:
            plate_futures[2048] = pool.submit(write_plate_frames, tmp_root, 2048)
        if 1 in phases:
            phase_build()
            mark("1")
        segs = greens = main_a = frames_sha = None
        if phases & {2, 3, 5, 6, 12, 14, 17, 18}:
            segs, greens, frames_sha = make_frames(torch, dev)
        if phases & {2, 3}:
            from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend

            stardist = StarDistBackend(unet_vars, seg_cfg, device=dev)
            main_a = stage_a_buckets(torch, stardist, segs, greens, stage_a)
            main_a.update(labels=stardist(segs)[0], segs=segs)   # segment sum's input
        kernels = {}
        if 2 in phases:
            from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend

            thresh_a = stage_a_buckets(torch, ThresholdBackend(), segs, greens, dict(
                {k: v for k, v in THRESH_KW.items() if k not in ("chunk", "caps")}, rcap=32))
            plate_a = None
            if 16 in phases:
                t0 = time.perf_counter()
                plate_a = _plate_batch(torch, dev, plate_futures[4096].result()[0], 4096)
                log(f"[2] the 4096^2 row's first batch through stage A, its frames made by a "
                    f"worker process: {time.perf_counter() - t0:.1f} s")
            kernels = phase_kernels(torch, dev, unet_vars, main_a, thresh_a, plate_a)
            del thresh_a, plate_a
            mark("2")
        launches, main_result, backend = {}, None, None
        if 3 in phases:
            n_buckets = sum(1 for ids, _, _ in main_a["buckets"] if ids.numel())
            launches, main_result, backend = phase_main_path(torch, dev, unet_vars, seg_cfg,
                                                             stage_a, segs, greens, n_buckets)
            mark("3")
        if 4 in phases:
            phase_gpu_vs_cpu(torch, dev, unet_vars, seg_cfg, stage_a)
            mark("4")
        params_model = load_scoring_params(device=dev)
        if 5 in phases:
            launches_a, launches_b = phase_threshold(torch, dev, segs, greens, params_model)
            launches["cc_tile_labels"] = launches_a["cc_tile_labels"]
            if 2 in phases:
                kernels["clahe_cells"]["threshold_launches"] = launches_a["clahe_cells"]
            mark("5")
        if 6 in phases and 3 in phases:
            phase_twin(torch, dev, seg_cfg, stage_a, segs, greens, backend, params_model,
                       main_result)
            mark("6")
        cellpose = None
        if 17 in phases:
            torch.cuda.empty_cache()
            cellpose = phase_cellpose(torch, dev, stage_a, segs, greens, params_model)
            launches["follow_flows"] = cellpose["launches"]["follow_flows"]
            torch.cuda.empty_cache()
            mark("17")
        if 18 in phases:
            cellpose_sam = phase_cellpose_sam(torch, dev, stage_a, segs, greens, params_model)
            for name in ("vit_attention", "vit_linear"):
                launches[name] = cellpose_sam["launches"][name]
                if 2 in phases:
                    kernels[name].update({f"main_path_{k}": cellpose_sam[k]
                                          for k in ("cells", "seconds", "peak_gib")})
            torch.cuda.empty_cache()
            mark("18")
        phase3 = (main_result, frames_sha) if main_result is not None else None
        del main_a, main_result
        if not phases & {12, 14}:
            del segs, greens
        torch.cuda.empty_cache()
        screening_launches = {}
        if futures:
            t0 = time.perf_counter()
            n_written = sum(f.result() for f in futures)
            log(f"[7] {n_written} frames in {sorted(folders)} were written by worker "
                f"processes; waited {time.perf_counter() - t0:.1f} s more for them")
        if 7 in phases:
            screening_launches = phase_screening(torch, dev, unet_vars, folders, tmp_root,
                                                 figures)
            mark("7")
        if 8 in phases:
            phase_threshold_screener(torch, dev, unet_vars, folders, tmp_root, figures)
            mark("8")
        if 9 in phases:
            phase_cli(folders, tmp_root, figures)
            mark("9")
        training_launches, train_cells = {}, None
        if 10 in phases:
            training_launches, train_cells = phase_training(torch, dev, unet_vars, folders,
                                                            tmp_root, figures)
            mark("10")
        unet_training = {}
        if 11 in phases:
            unet_training = phase_unet_training(torch, dev, tmp_root)
            mark("11")
        mesh = {}
        if 12 in phases:
            mesh = phase_mesh(torch, dev, unet_vars, seg_cfg, stage_a, segs, greens,
                              params_model, tmp_root, train_cells)
            mark("12")
        dist = {}
        if 14 in phases:
            dist = phase_dist(torch, dev, unet_vars, seg_cfg, stage_a, segs, greens, tmp_root,
                              phase3[0] if phase3 is not None else None)
            mark("14")
        bench = {}
        if 13 in phases:
            segs = greens = params_model = None   # the card's memory for the bench
            t0 = time.perf_counter()
            bench_future.result()
            log(f"[13] the bench's {BENCH_FRAMES} frames were made by a worker process; "
                f"waited {time.perf_counter() - t0:.1f} s more for them")
            bench = phase_bench(torch, dev, bench_frames, phase3)
            mark("13")
        if 15 in phases:
            phase_round_trip(torch, dev, unet_vars, tmp_root)
            mark("15")
        plates = {}
        if 16 in phases:
            segs = greens = params_model = None   # the card's memory for the plates
            t0 = time.perf_counter()
            paths = {size: f.result() for size, f in plate_futures.items()}
            log(f"[16] the rows' frames were made by worker processes; waited "
                f"{time.perf_counter() - t0:.1f} s more for them")
            plates = phase_plates(torch, dev, paths)
            mark("16")
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp_root, ignore_errors=True)
    clock.pop("at", None)
    total = time.perf_counter() - clock.pop("start")
    log(f"wall seconds by phase (the time since the previous phase ended, so phase 2 includes "
        f"making the 16 frames): {', '.join(f'{k} {v:.1f}' for k, v in clock.items())}; "
        f"total {total:.1f}")
    if phases != ALL_PHASES:
        log(f"partial run (phases {sorted(phases)}): no result line")
        return 1

    meta = {
        "winograd_conv3x3": ("csrc/winograd_conv3x3.cu",
                             "cell_image_analysis_tpu/ops/pallas/winograd.py:184"),
        "segment_sum": ("csrc/segment_sum.cu",
                        "cell_image_analysis_tpu/ops/pallas/segsum.py:49"),
        "clahe_cells": ("csrc/clahe_cells.cu",
                        "cell_image_analysis_tpu/ops/pallas/clahe_kernel.py:184"),
        "cc_tile_labels": ("csrc/cc_tile_labels.cu",
                           "cell_image_analysis_tpu/ops/pallas/cc_kernel.py:80"),
        "kthvalue_radix": ("csrc/kthvalue_radix.cu",
                           "no Pallas kernel: torch.kthvalue, for the XLA bisection of "
                           "cell_image_analysis_tpu/ops/percentile.py"),
        "follow_flows": ("csrc/follow_flows.cu",
                         "no Pallas kernel: the JAX package has no Cellpose; the 200 "
                         "grid_sample steps of Cellpose's dynamics.steps2D_interp"),
        "vit_attention": ("csrc/vit_attention.cu",
                          "no Pallas kernel: the JAX package has no Cellpose-SAM; SAM's "
                          "Attention with add_decomposed_rel_pos, its scores materialised"),
        "vit_linear": ("csrc/vit_linear.cu",
                       "no Pallas kernel: the JAX package has no ViT; the blocks' qkv, proj, "
                       "lin1 and lin2 as cuBLAS float32 SGEMM (F.linear)"),
    }
    # `launches`: wrapper calls in one batch of 16 frames, phase 3 (CC:
    # phase 5 (a), the threshold backend; the flow following: phase 17,
    # Cellpose; the ViT attention and linears: phase 18, Cellpose-SAM, whose rows'
    # `main_path_*` keys are that run's cells, wall seconds and peak GiB); `launches_per_batch`: the kernel launches on the card
    # they make (a CC call is the module's KERNELS_PER_CALL);
    # `screening_launches`: wrapper calls while phase 7 screened its
    # folders; `training_launches`: wrapper calls while phase 10 trained
    # (its timed run); `unet_training_launches`: wrapper calls
    # while phase 11's fit_unet trained the U-Net (forward and data
    # gradient; the Winograd row also gets the step's numbers);
    # `mesh_launches`: wrapper calls on each route of phase 12 (a_*: the 16
    # frames sharded, b/c: the 2048^2 tilers, d_*: the 4096^2 plate tiled and
    # whole), each counted from 0; `dist_launches`: wrapper calls in the
    # timed runs of phase 14's workers, summed over them (StarDist, and the
    # threshold backend); `bench_launches`: wrapper calls while
    # phase 13's run_bench ran each backend (two warm-ups of batch 0, two
    # timed runs of 3 batches), `bench_batch_launches`: in one held bench
    # batch of 16 frames, each counted from 0; `plate_launches`: wrapper calls while
    # phase 16's run_device_bench ran each plate row (two warm-ups of batch 0, two
    # timed runs of every batch), `plate_batch_launches`: in its held first batch;
    # `plate_*`: phase 2 at the 4096^2 row's shapes (Winograd Conv_1 on (2, 4096,
    # 4096, 32 -> 32), segment sum, CLAHE and the select on the row's first batch);
    # `tile_*`: CC and Winograd at the shape of
    # one of phase 12's haloed tiles, phase 2 (device ms, bound ms, shape); `ms` is the
    # kernel's device time (torch.profiler), `event_ms` one event-timed
    # wrapper call; CLAHE's `threshold_*`: the threshold path, phase 5 (a);
    # the select's `threshold_*`: its 6 ranks on the 16 frames, phase 2
    modules = _kernel_modules()
    rows = [dict(name=name, route="cuda", source=f"{PKG}/{src}", replaces=rep,
                 launches=launches[name],
                 launches_per_batch=launches[name] * getattr(modules[name], "KERNELS_PER_CALL", 1),
                 screening_launches=screening_launches[name],
                 training_launches=training_launches[name],
                 unet_training_launches=unet_training[name],
                 mesh_launches=mesh["launches"][name],
                 dist_launches=dist["launches"].get(name, 0),
                 bench_launches={b: n[name] for b, n in bench["launches"].items()},
                 bench_batch_launches={b: n[name] for b, n in bench["batch_launches"].items()},
                 plate_launches={str(size): p["launches"][name] for size, p in plates.items()},
                 plate_batch_launches={str(size): p["batch_launches"][name]
                                       for size, p in plates.items()},
                 **kernels[name])
            for name, (src, rep) in meta.items()]
    rows[0].update({k: v for k, v in unet_training.items() if k.startswith("unet_")})
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
