"""The plate tiler: a frame's rows split over the mesh, with halos.

Counterpart of `cell_image_analysis_tpu/parallel/tiling.py`.  Plates of
2048^2-4096^2 are this workload's long context: the frame's rows are split
over the mesh's shards, shard i gets the frame's rows `[i*rows - halo,
(i+1)*rows + halo)` that exist (a slice of the frame copied to its device
with `.to(device, non_blocking=True)`: JAX's `_halo_exchange`), segments
and extracts cells on that haloed tile, and keeps exactly the cells whose
centroid row falls in its own rows (the ownership rule that counts an
instance two tiles see once).

At the frame's top and bottom edges the port's tile ends with the frame,
where JAX's is padded with zero rows.  For connected components the two
are the same; the U-Net, though, reads zero rows as input rows, unlike the
zero padding of each of its convolutions at a frame edge, so in JAX a cell
within the U-Net's reach of the frame's top or bottom edge can come out of
a tile with another shape than out of the whole frame (a known divergence,
ROADMAP.md; on a 512^2 plate the first tile's features differed from the
whole frame's by up to 411 of 445).  The port's edge tiles are what the
whole frame is there, so the tiled StarDist cells equal the fused ones.

The frame-wide steps stay frame-wide, on the home device: percentile
normalization (and the threshold backend's threshold and opening) run on
the whole frame before it is cut, and QC gates run in global frame
coordinates.  Each shard's work is launched before any result is read:
`n_cells` and the overflow flags are summed and ORed over the tiles and
read with one wait at the end, so on distinct cards the shards overlap
(the StarDist NMS still waits on its own device inside a shard, as on one
device).  The per-cell tensors of all tiles are gathered in shard order on
the home device, `cell_capacity` slots a tile.

- `tiled_extract_cells`: the threshold backend; connected components on
  each haloed tile (`ops.cc.label_components`, the CC kernel on the card);
- `tiled_extract_cells_stardist`: the StarDist backend;
  `models.stardist.predict_instances` on each haloed tile with a U-Net
  replica on the shard's device;
- both end in the shared tail `_cells_from_tile_labels`: pixel regionprops
  (the segment-sum kernel), global-coordinate QC, ownership and the
  untruncated test, the first `cell_capacity` passing labels, crops and
  their mean/std, CLAHE over every slot at the crop capacity (the CLAHE
  kernel, one launch a tile), and the resize.

Contract (tests/test_torch_tiling.py; on the card, chip_smoke.py phase
12): the tiled cells equal the single-device path's given halo >= the
largest cell bbox (StarDist: see `tiled_extract_cells_stardist`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cell_image_analysis_tpu_torch.config import SegConfig
from cell_image_analysis_tpu_torch.models.segmentation import binary_opening
from cell_image_analysis_tpu_torch.models.stardist import predict_instances
from cell_image_analysis_tpu_torch.ops import gather_rows, nonzero_static
from cell_image_analysis_tpu_torch.ops.cc import label_components
from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells
from cell_image_analysis_tpu_torch.ops.extract import gather_crops
from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile, percentile
from cell_image_analysis_tpu_torch.ops.regionprops import regionprops
from cell_image_analysis_tpu_torch.ops.resize import resize_cells
from cell_image_analysis_tpu_torch.parallel.mesh import AXIS, Mesh
from cell_image_analysis_tpu_torch.parallel.sharding import replicate

_CELL_FIELDS = ("cells", "valid", "area", "eccentricity", "mean_intensity", "std_intensity")


class TiledCells(NamedTuple):
    """Per-cell tensors (n_shards * cell_capacity, ...) on the home device,
    tile after tile; `valid` marks the slots that hold a cell."""

    cells: torch.Tensor            # (n * cap, out, out) float32
    valid: torch.Tensor            # (n * cap,) bool
    area: torch.Tensor             # int32
    eccentricity: torch.Tensor
    mean_intensity: torch.Tensor
    std_intensity: torch.Tensor
    n_cells: int                   # valid cells over all tiles
    # StarDist: a tile's rasterizer, NMS pair budget or candidate cap
    # overflowed (callers re-run with the exact twin's settings); None on
    # the threshold backend
    raster_overflow: Optional[bool] = None
    # a tile had more QC-passing cells than cell_capacity, so its selection
    # truncated (callers re-run with a larger cell_capacity)
    cell_overflow: Optional[bool] = None


def _tile_rows(mesh: Mesh, H: int, halo: int) -> int:
    n = mesh.shape[AXIS]
    rows = H // n
    assert rows * n == H, "H must divide evenly across the mesh"
    assert rows >= halo, "halo must not exceed rows per tile"
    return rows


def tile_spans(mesh: Mesh, H: int, halo: int) -> list:
    """Shard i's tile (first row, end row) in the frame: its own rows
    [i*rows, (i+1)*rows) and up to `halo` rows of each neighbour, cut at the
    frame's edges."""
    rows = _tile_rows(mesh, H, halo)
    return [(max(i * rows - halo, 0), min((i + 1) * rows + halo, H))
            for i in range(mesh.shape[AXIS])]


def halo_tiles(frame: torch.Tensor, mesh: Mesh, halo: int) -> list:
    """(H, W) -> shard i's haloed tile (`tile_spans`) on its device."""
    return [frame[r0:r1].to(dev, non_blocking=True)
            for (r0, r1), dev in zip(tile_spans(mesh, frame.shape[0], halo), mesh.devices)]


def _cells_from_tile_labels(labels: torch.Tensor, g: torch.Tensor, *, row0: int, own0: int,
                            rows: int, H: int, W: int, cell_capacity: int, crop_capacity: int,
                            label_capacity: int, out_size: int, border_margin: int,
                            min_area: int, max_area: int, max_eccentricity: float,
                            min_mean_intensity: float, min_std_intensity: float) -> dict:
    """The shared per-tile tail: a haloed tile's label map and green channel
    (frame rows from `row0`; its own rows start at local row `own0`) ->
    QC'd, owned, CLAHE'd and resized cells, with the tile's valid count and
    capacity flag as device tensors (and a segmentation flag, False, that
    the StarDist tiler sets)."""
    tile_rows = labels.shape[0]
    p = regionprops(labels[None], capacity=label_capacity)

    # QC in global frame coordinates (the border against the true edges)
    g_minr = p.min_r + row0
    g_maxr = p.max_r + row0
    border_ok = ((g_minr >= border_margin) & (p.min_c >= border_margin)
                 & (g_maxr <= H - border_margin) & (p.max_c <= W - border_margin))
    area_ok = (p.area >= min_area) & (p.area <= max_area)
    ecc_ok = p.eccentricity <= max_eccentricity
    # ownership: the centroid's row lies in this tile's own rows
    own = (p.centroid_r >= own0) & (p.centroid_r < own0 + rows)
    # components that touch a tile edge inside the frame may be cut off;
    # with halo >= crop_capacity any component that large fails the
    # bbox-fits gate on one device too (at a frame edge nothing is cut)
    untruncated = (((p.min_r > 0) | (row0 == 0))
                   & ((p.max_r < tile_rows) | (row0 + tile_rows == H)))
    geo = p.valid & border_ok & area_ok & ecc_ok & own & untruncated

    sel = nonzero_static(geo, cell_capacity, label_capacity)           # (1, cap)
    ok = sel < label_capacity
    sc = torch.clamp(sel, max=label_capacity - 1)
    minr, minc = gather_rows(p.min_r, sc), gather_rows(p.min_c, sc)
    hr = gather_rows(p.max_r, sc) - minr
    wc = gather_rows(p.max_c, sc) - minc
    ok = ok & (hr <= crop_capacity) & (wc <= crop_capacity)
    ch = torch.clamp(hr, 1, crop_capacity)
    cw = torch.clamp(wc, 1, crop_capacity)
    crops, mean, std = gather_crops(g.float()[None], minr, minc, ch, cw, crop_capacity)
    valid = (ok & (mean >= min_mean_intensity) & (std >= min_std_intensity))[0]

    ch, cw = ch[0].int(), cw[0].int()
    eq = clahe_cells(crops[0], ch, cw)
    cells = resize_cells(eq, ch, cw, out_size=out_size)
    zf = torch.zeros_like(mean[0])
    return dict(
        cells=torch.where(valid[:, None, None], cells, torch.zeros_like(cells)),
        valid=valid,
        area=torch.where(valid, gather_rows(p.area, sc)[0], 0).int(),
        eccentricity=torch.where(valid, gather_rows(p.eccentricity, sc)[0], zf),
        mean_intensity=torch.where(valid, mean[0], zf),
        std_intensity=torch.where(valid, std[0], zf),
        n_valid=valid.sum(),
        cell_overflow=geo.sum() > cell_capacity,
        seg_overflow=torch.zeros((), dtype=torch.bool, device=labels.device),
    )


def _gather(mesh: Mesh, tiles: list, stardist: bool) -> TiledCells:
    """The tiles' cells in shard order on the home device; the valid count,
    the capacity flag and the segmentation flag (StarDist) over all tiles,
    read with one wait."""
    home = mesh.home
    fields = {k: torch.cat([t[k].to(home, non_blocking=True) for t in tiles])
              for k in _CELL_FIELDS}
    counts = torch.stack([torch.stack([t[k].long() for k in ("n_valid", "cell_overflow",
                                                              "seg_overflow")]).to(home)
                          for t in tiles]).sum(dim=0)
    n_cells, n_cell_ovf, n_seg_ovf = counts.tolist()                   # the one wait
    return TiledCells(**fields, n_cells=n_cells,
                      raster_overflow=bool(n_seg_ovf) if stardist else None,
                      cell_overflow=bool(n_cell_ovf))


def _home_frames(mesh: Mesh, seg_channel, green) -> tuple:
    home = mesh.home
    return (torch.as_tensor(seg_channel, device=home).float(),
            torch.as_tensor(green, device=home).float())


@torch.inference_mode()
def tiled_extract_cells(seg_channel, green, mesh: Mesh, halo: int = 96,
                        cell_capacity: int = 128, crop_capacity: int = 192,
                        label_capacity: int = 512, out_size: int = 64,
                        threshold_percentile: float = 90.0, border_margin: int = 10,
                        min_area: int = 200, max_area: int = 8000,
                        max_eccentricity: float = 0.95, min_mean_intensity: float = 0.5,
                        min_std_intensity: float = 0.1, connectivity: int = 1,
                        opening: bool = True, norm_pmin: float = 3.0,
                        norm_pmax: float = 99.8) -> TiledCells:
    """Threshold-backend segmentation and extraction over row tiles.

    seg_channel, green: (H, W) tensors or arrays, H divisible by the mesh
    size and rows per tile >= halo.  Normalization, threshold and opening
    run on the whole frame on the home device; connected components and
    the tail on each tile, on its shard's device."""
    seg, green = _home_frames(mesh, seg_channel, green)
    H, W = seg.shape
    rows = _tile_rows(mesh, H, halo)
    norm = normalize_percentile(seg, pmin=norm_pmin, pmax=norm_pmax)
    mask = norm > percentile(norm, threshold_percentile)
    if opening:
        mask = binary_opening(mask[None])[0]
    tail = dict(rows=rows, H=H, W=W, cell_capacity=cell_capacity,
                crop_capacity=crop_capacity, label_capacity=label_capacity, out_size=out_size,
                border_margin=border_margin, min_area=min_area, max_area=max_area,
                max_eccentricity=max_eccentricity, min_mean_intensity=min_mean_intensity,
                min_std_intensity=min_std_intensity)
    tiles = []
    for i, (m, g, (r0, _)) in enumerate(zip(halo_tiles(mask, mesh, halo),
                                            halo_tiles(green, mesh, halo),
                                            tile_spans(mesh, H, halo))):
        labels, _ = label_components(m[None], connectivity=connectivity)
        tiles.append(_cells_from_tile_labels(labels[0], g, row0=r0, own0=i * rows - r0, **tail))
    return _gather(mesh, tiles, stardist=False)


@torch.inference_mode()
def tiled_extract_cells_stardist(seg_channel, green, mesh: Mesh, unet,
                                 seg_cfg: Optional[SegConfig] = None, halo: int = 160,
                                 cell_capacity: int = 128, crop_capacity: int = 192,
                                 out_size: int = 64, border_margin: int = 10,
                                 min_area: int = 200, max_area: int = 8000,
                                 max_eccentricity: float = 0.95,
                                 min_mean_intensity: float = 0.5,
                                 min_std_intensity: float = 0.1) -> TiledCells:
    """StarDist-backend segmentation and extraction over row tiles:
    `predict_instances` (U-Net -> candidates -> star NMS -> rasterize) on
    each haloed tile with the replica of `unet` (a `StarDistUNet`, or a
    `Replicated` of them) on the shard's device, then the threshold
    tiler's tail.  `raster_overflow` ORs each tile's rasterizer, NMS and
    candidate flags.

    Equivalence contract with the fused single-device path: exact given
    - halo >= U-Net receptive field / 2 + 2 * max polygon radius (halo
      pixels near the tile's edge inside the frame may carry slightly
      different probs, but such candidates cannot overlap, so cannot
      suppress or overwrite, any owned instance; at the frame's edges the
      tile ends with the frame, so its U-Net sees what the whole frame's
      does),
    - halo and rows per tile multiples of 2**depth (pooling-grid phase
      alignment: the tile's prob and dist values then equal the whole
      frame's), and
    - per-tile candidate counts below seg_cfg.max_candidates (the fused
      top-K and each tile's top-K then select the same candidates).
    Percentile normalization stays global: it runs on the whole frame
    before the tiles are cut.  The port's top-K takes no candidate from the
    reflect padding of frames whose sides are not multiples of 2**depth (a
    known divergence from JAX); aligned tiles have no such padding, so
    there it changes nothing."""
    seg_cfg = SegConfig() if seg_cfg is None else seg_cfg
    seg, green = _home_frames(mesh, seg_channel, green)
    H, W = seg.shape
    rows = _tile_rows(mesh, H, halo)
    align = 2 ** seg_cfg.unet_depth
    assert rows % align == 0 and halo % align == 0 and W % align == 0, (
        "rows/halo/W must align to the U-Net pooling grid for tiled == fused")
    label_capacity = seg_cfg.raster_cap or seg_cfg.max_candidates
    norm = normalize_percentile(seg, pmin=seg_cfg.norm_pmin, pmax=seg_cfg.norm_pmax)
    unets = replicate(mesh, unet)
    tail = dict(rows=rows, H=H, W=W, cell_capacity=cell_capacity,
                crop_capacity=crop_capacity, label_capacity=label_capacity, out_size=out_size,
                border_margin=border_margin, min_area=min_area, max_area=max_area,
                max_eccentricity=max_eccentricity, min_mean_intensity=min_mean_intensity,
                min_std_intensity=min_std_intensity)
    tiles = []
    for i, (t, g, (r0, _)) in enumerate(zip(halo_tiles(norm, mesh, halo),
                                            halo_tiles(green, mesh, halo),
                                            tile_spans(mesh, H, halo))):
        labels, d = predict_instances(t[None], unets[i], seg_cfg, normalize=False)
        tile = _cells_from_tile_labels(labels[0], g, row0=r0, own0=i * rows - r0, **tail)
        tile["seg_overflow"] = (d.raster_overflow | d.nms_overflow | d.cand_overflow)[0]
        tiles.append(tile)
    return _gather(mesh, tiles, stardist=True)
