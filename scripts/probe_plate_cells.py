#!/usr/bin/env python3
"""Where a 4096^2 plate's cells go between the whole-frame and the tiled route.

    python3 scripts/probe_plate_cells.py [--out build/probe_plate_cells.json]

On one GPU: the plate of smoke phase 12 (d) (`make_plate`, seed 32, 1,280
cells, 4096^2) as a TIFF through `ProductionMutantScreening` three ways:

- `whole`: one device, `PipelineConfig()` (top-K 1,024 x 16 = 16,384);
- `tiled`: a virtual mesh of 4 shards on cuda:0, `tile_min_side` 2048 (4
  haloed tiles of 1024 + 2 x 192 rows, top-K 6,144 a tile);
- `reference`: a virtual mesh of 16 shards, `max_candidates` 8,192 and an
  NMS pair budget of 262,144 (scaled with each tile's area: 16 tiles of
  256 + 2 x 192 rows, top-K 24,576 a tile): a run where no top-K binds.
  (The whole frame cannot run unbound: its 123k candidates would need a
  K x K pair table.)

For each route and each of its frames or tiles, from the U-Net's
probability map: grid pixels above the threshold, peaks above it (the
count the candidate guard reads, `models/stardist.py`), the top-K, and
the peaks whose probability lies below the K-th largest (cells that can
get no candidate: lost without a flag).  Then each route's cells, wall
seconds and the screener's fallback lines.  Last, each route's instances
against the planted cells (their centres replayed from the plate's draws):
`predict_instances` at the route's top-K with every NMS pair, on the whole
frame or on each haloed tile (a tile keeps the instances whose centroid
row it owns, as the tiler does); an instance of at least `MIN_AREA` pixels
finds the planted cell whose centre lies within the cell's short radius of
its centroid.  Counted: planted cells found, missed, found more than once,
and instances that find none.  Prints the `nvidia-smi` name and power
limit beside the numbers.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STORE = os.path.join(REPO, "assets", "screening_store_synthetic")
PLATE = (4096, 1280, 32)    # side, cells, seed: smoke phase 12 (d)
MIN_AREA = 200              # QCConfig.min_area


def planted_cells(side: int, n_cells: int, seed: int) -> np.ndarray:
    """(n, 3) centre row, centre column and short radius of the cells
    `make_plate(default_rng(seed), side, n_cells)` draws (no mutants)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_cells):
        rng.uniform()                              # mutant?
        cy, cx = rng.uniform(30, side - 30, 2)
        r = rng.uniform(9, 16)
        rng.uniform(1.0, 1.8), rng.uniform(0, np.pi), rng.uniform(900, 1500)
        out.append((cy, cx, r))
    return np.array(out)


def centroids(labels: np.ndarray, row0: int = 0) -> np.ndarray:
    """(n, 3) centroid row (+ row0), column and area of each label >= 1."""
    lab = labels.ravel().astype(np.int64)
    n = int(lab.max()) + 1
    rows, cols = np.divmod(np.arange(lab.size), labels.shape[1])
    area = np.bincount(lab, minlength=n)[1:]
    cy = np.bincount(lab, weights=rows, minlength=n)[1:]
    cx = np.bincount(lab, weights=cols, minlength=n)[1:]
    keep = area > 0
    return np.stack([cy[keep] / area[keep] + row0, cx[keep] / area[keep], area[keep]], axis=1)


def match(found: np.ndarray, truth: np.ndarray) -> dict:
    """Instances (>= MIN_AREA pixels) against the planted cells."""
    found = found[found[:, 2] >= MIN_AREA]
    d = np.hypot(found[:, None, 0] - truth[None, :, 0], found[:, None, 1] - truth[None, :, 1])
    hit = d <= truth[None, :, 2]
    per_cell = hit.sum(axis=0)
    return dict(instances=len(found), planted_found=int((per_cell > 0).sum()),
                planted_missed=int((per_cell == 0).sum()),
                planted_found_twice=int((per_cell > 1).sum()),
                instances_without_a_cell=int((hit.sum(axis=1) == 0).sum()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "probe_plate_cells.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_plate_cells: no CUDA device", file=sys.stderr)
        return 1
    from cell_image_analysis_tpu_torch.config import ExtractConfig, PipelineConfig, SegConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
    from cell_image_analysis_tpu_torch.io.tiff import imwrite
    from cell_image_analysis_tpu_torch.models.segmentation import select_backend
    from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
    from cell_image_analysis_tpu_torch.parallel.tiling import halo_tiles
    from cell_image_analysis_tpu_torch.pipeline.screening import ProductionMutantScreening
    from cell_image_analysis_tpu_torch.utils.synthetic import make_plate

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    side, n_cells, seed = PLATE
    t0 = time.perf_counter()
    plate = make_plate(np.random.default_rng(seed), size=side, n_cells=n_cells)
    print(f"made the {side}^2 plate of {n_cells} cells in {time.perf_counter() - t0:.1f} s",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="probe_plate_")
    folder = os.path.join(tmp, "plate")
    os.makedirs(folder)
    imwrite(os.path.join(folder, "plate.tif"), plate)
    seg = torch.tensor(plate[..., 2].astype(np.float32), device=dev)
    del plate
    unet_vars = load_unet_variables()
    tiled_cfg = PipelineConfig(extract=ExtractConfig(tile_min_side=side // 2))
    routes = {
        "whole": (PipelineConfig(), None),
        "tiled": (tiled_cfg, 4),
        "reference": (tiled_cfg.replace(seg=SegConfig(max_candidates=8192,
                                                      nms_max_pairs=262144)), 16),
    }

    def scale(h, w):
        return max(1, -(-(h * w) // (1024 * 1024)))

    def candidates(cfg, shards) -> list:
        """Per frame or tile: pixels above the threshold, peaks above it, K,
        peaks below the K-th largest probability."""
        backend = select_backend(cfg.seg, cfg.extract.cell_capacity, unet_vars, dev)[0]
        norm = normalize_percentile(seg, pmin=cfg.seg.norm_pmin, pmax=cfg.seg.norm_pmax)
        if shards is None:
            parts, k = [norm], cfg.seg.max_candidates * scale(side, side)
        else:
            rows = side // shards
            align = 2 ** cfg.seg.unet_depth
            halo = min(cfg.extract.crop_capacity, rows) // align * align
            parts = halo_tiles(norm, virtual_mesh(dev, shards), halo)
            k = cfg.seg.max_candidates * scale(rows + 2 * halo, side)
        out = []
        with torch.inference_mode():
            for part in parts:
                prob = backend.model(part[None, ..., None].to(dev))[0][0]
                above = prob > cfg.seg.prob_thresh
                neigh = torch.nn.functional.max_pool2d(prob[None, None], 3, 1, 1)[0, 0]
                peaks = (prob >= neigh) & above
                kth = torch.topk(prob.reshape(-1), min(k, prob.numel())).values[-1]
                cut = int((peaks & (prob < kth)).sum()) if int(above.sum()) > k else 0
                out.append(dict(above=int(above.sum()), peaks=int(peaks.sum()), k=k,
                                peaks_cut=cut))
        return out

    result = dict(smi=smi, plate=dict(side=side, cells=n_cells, seed=seed), routes={})
    for name, (cfg, shards) in routes.items():
        cand = candidates(cfg, shards)
        where = dict(device=dev) if shards is None else dict(mesh=virtual_mesh(dev, shards))
        screener = ProductionMutantScreening(STORE, cfg, unet_vars, **where)
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res, _ = screener.screen_mutant_samples({"plate": folder},
                                                    os.path.join(tmp, f"out_{name}"),
                                                    figures=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lines = [ln.strip() for ln in printed.getvalue().splitlines()
                 if "re-run" in ln or "WARNING" in ln or "overflow" in ln]
        result["routes"][name] = dict(cells=res["plate"]["total_cells"], seconds=seconds,
                                      candidates=cand, screener_lines=lines,
                                      peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        print(f"{name}: {res['plate']['total_cells']} cells in {seconds:.2f} s (first run, "
              f"compiles included); per frame or tile {cand}; screener: {lines} [{smi}]",
              flush=True)
        del screener
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ref = result["routes"]["reference"]["cells"]
    for name in ("whole", "tiled"):
        print(f"{name} against the reference: {result['routes'][name]['cells'] - ref:+d} cells")

    # each route's instances against the planted cells
    import dataclasses

    from cell_image_analysis_tpu_torch.models.stardist import predict_instances

    truth = planted_cells(side, n_cells, seed)
    for name, (cfg, shards) in routes.items():
        backend = select_backend(cfg.seg, cfg.extract.cell_capacity, unet_vars, dev)[0]
        norm = normalize_percentile(seg, pmin=cfg.seg.norm_pmin, pmax=cfg.seg.norm_pmax)
        if shards is None:
            spans, own = [(0, side)], [(0, side)]
        else:
            rows = side // shards
            align = 2 ** cfg.seg.unet_depth
            halo = min(cfg.extract.crop_capacity, rows) // align * align
            spans = [(max(i * rows - halo, 0), min((i + 1) * rows + halo, side))
                     for i in range(shards)]
            own = [(i * rows, (i + 1) * rows) for i in range(shards)]
        k = result["routes"][name]["candidates"][0]["k"]
        seg_cfg = dataclasses.replace(cfg.seg, max_candidates=k, raster_cap=k,
                                      nms_max_pairs=None)
        found = []
        with torch.inference_mode():
            for (r0, r1), (o0, o1) in zip(spans, own):
                labels, _ = predict_instances(norm[None, r0:r1], backend.model, seg_cfg,
                                              normalize=False)
                c = centroids(labels[0].cpu().numpy(), r0)
                found.append(c[(c[:, 0] >= o0) & (c[:, 0] < o1)])
                del labels
                torch.cuda.empty_cache()
        m = result["routes"][name]["planted"] = match(np.concatenate(found), truth)
        print(f"{name}: instances against the {n_cells} planted cells: {m}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
