"""Star-polygon rasterization to instance label maps.

Counterpart of `cell_image_analysis_tpu/ops/rasterize.py`: the kept
polygons are compacted to the top-`raster_cap` by probability, labelled
1..n in descending probability, and a pixel takes the largest packed
priority key `prob_q << 16 | (0xFFFF - label)` among the polygons that
contain it.  Two renderers:

- `rasterize_polygons_tiled`: each 64x64 frame tile draws its top-`m_cap`
  overlapping polygons; a tile with more than `m_cap` polygons sets the
  per-frame overflow flag.  Polygons are not clipped.
- `rasterize_polygons`: every polygon draws a `patch` x `patch` window
  around its center into one scatter-max over the frame; no per-tile cap,
  but a polygon wider than the patch is clipped to it.  The exact overflow
  twin's renderer, and the one for frames whose side is not a multiple of
  the tile.

Batched over a leading frame axis.
"""

from __future__ import annotations

import math

import torch

from cell_image_analysis_tpu_torch.ops import gather_rows
from cell_image_analysis_tpu_torch.ops.nms import radius_at


def _compact_and_key(centers, dists, probs, keep, raster_cap):
    """Top-`raster_cap` compaction, descending-prob label ids and the packed
    priority keys."""
    if raster_cap is not None and raster_cap < probs.shape[1]:
        score = torch.where(keep, probs, torch.full_like(probs, -math.inf))
        order = torch.sort(score, dim=1, descending=True, stable=True)
        top_s, top_i = order.values[:, :raster_cap], order.indices[:, :raster_cap]
        centers, dists, probs = (gather_rows(a, top_i) for a in (centers, dists, probs))
        keep = torch.isfinite(top_s)
    B, K = probs.shape
    p = torch.where(keep, probs, torch.full_like(probs, -math.inf))
    order_desc = torch.argsort(-p, dim=1, stable=True)
    ranks = torch.empty_like(order_desc).scatter_(
        1, order_desc, torch.arange(K, device=p.device).expand(B, K).contiguous())
    label_ids = torch.where(keep, ranks.int() + 1, 0)
    prob_q = torch.clamp(probs * 32767.0, 0, 32767).int()
    keys = (prob_q << 16) | (0xFFFF - label_ids)
    return centers, dists, keys, keep


def rasterize_polygons_tiled(centers, dists, probs, keep, height: int, width: int,
                             tile: int = 64, m_cap: int = 8, raster_cap: int | None = None):
    """centers (B, K, 2), dists (B, K, R), probs (B, K), keep (B, K) ->
    (labels (B, height, width) int32, overflow (B,) bool)."""
    if height % tile or width % tile:
        raise ValueError("rasterize_polygons_tiled: frame not tile-aligned")
    centers, dists, keys, keep = _compact_and_key(centers, dists, probs, keep, raster_cap)
    B, K = keys.shape
    dev = keys.device
    Ty, Tx = height // tile, width // tile
    T = Ty * Tx
    rmax = torch.amax(dists, dim=-1)
    r0 = centers[..., 0] - rmax
    r1 = centers[..., 0] + rmax
    c0 = centers[..., 1] - rmax
    c1 = centers[..., 1] + rmax
    ty = torch.arange(Ty, dtype=torch.float32, device=dev) * tile
    tx = torch.arange(Tx, dtype=torch.float32, device=dev) * tile
    rowhit = (r1[..., None] >= ty) & (r0[..., None] < (ty + tile))        # (B, K, Ty)
    colhit = (c1[..., None] >= tx) & (c0[..., None] < (tx + tile))        # (B, K, Tx)
    hit = (rowhit[..., :, None] & colhit[..., None, :] & keep[..., None, None]).reshape(B, K, T)

    slot_score = torch.where(hit, keys[..., None], 0)                     # (B, K, T)
    full_cap = m_cap >= K
    m_cap = min(m_cap, K)
    if full_cap:
        overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    else:
        overflow = torch.any(hit.sum(dim=1) > m_cap, dim=1)
    order = torch.sort(slot_score.transpose(1, 2), dim=2, descending=True, stable=True)
    top_key, top_idx = order.values[..., :m_cap], order.indices[..., :m_cap]  # (B, T, m)
    cen_t = gather_rows(centers, top_idx)                                 # (B, T, m, 2)
    dist_t = gather_rows(dists, top_idx)                                  # (B, T, m, R)
    key_t = torch.where(top_key > 0, top_key, 0)

    rowbase = ty.repeat_interleave(Tx)                                    # (T,)
    colbase = tx.repeat(Ty)
    dy = torch.arange(tile, dtype=torch.float32, device=dev)[:, None]
    dx = torch.arange(tile, dtype=torch.float32, device=dev)[None, :]
    acc = torch.zeros((B, T, tile, tile), dtype=torch.int32, device=dev)
    for m in range(m_cap):
        c = cen_t[:, :, m]                                                # (B, T, 2)
        py = (rowbase[:, None, None] + dy) - c[..., 0, None, None]
        px = (colbase[:, None, None] + dx) - c[..., 1, None, None]
        rho = torch.sqrt(py * py + px * px)
        theta = torch.atan2(py, px)
        rb = radius_at(dist_t[:, :, m, None, None, :], theta)             # (B, T, tile, tile)
        val = torch.where(rho <= rb, key_t[:, :, m, None, None], 0)
        acc = torch.maximum(acc, val)
    labels = torch.where(acc > 0, 0xFFFF - (acc & 0xFFFF), 0).int()
    labels = labels.reshape(B, Ty, Tx, tile, tile).permute(0, 1, 3, 2, 4)
    return labels.reshape(B, height, width), overflow


def rasterize_polygons(centers, dists, probs, keep, height: int, width: int,
                       patch: int = 160, raster_cap: int | None = None):
    """centers (B, K, 2), dists (B, K, R), probs (B, K), keep (B, K) ->
    labels (B, height, width) int32, by one scatter-max of every polygon's
    patch pixels into a flat canvas with a scrap slot."""
    centers, dists, keys, keep = _compact_and_key(centers, dists, probs, keep, raster_cap)
    B, K = keys.shape
    dev = keys.device
    half = patch // 2
    r0 = torch.round(centers[..., 0]).int() - half                       # (B, K)
    c0 = torch.round(centers[..., 1]).int() - half
    ar = torch.arange(patch, device=dev)
    dy = ar.float()[:, None]
    dx = ar.float()[None, :]
    py = dy + r0.float()[..., None, None] - centers[..., 0, None, None]   # (B, K, p, p)
    px = dx + c0.float()[..., None, None] - centers[..., 1, None, None]
    rho = torch.sqrt(py * py + px * px)
    theta = torch.atan2(py, px)
    rb = radius_at(dists[..., None, None, :], theta)
    gy = r0[..., None, None] + ar[:, None]
    gx = c0[..., None, None] + ar[None, :]
    ok = ((rho <= rb) & keep[..., None, None]
          & (gy >= 0) & (gy < height) & (gx >= 0) & (gx < width))
    flat = torch.where(ok, gy * width + gx, height * width).reshape(B, -1).long()
    vals = torch.where(ok, keys[..., None, None], 0).reshape(B, -1)
    canvas = torch.zeros((B, height * width + 1), dtype=torch.int32, device=dev)
    canvas.scatter_reduce_(1, flat, vals.int(), reduce="amax")
    canvas = canvas[:, :height * width]
    labels = torch.where(canvas > 0, 0xFFFF - (canvas & 0xFFFF), 0).int()
    return labels.reshape(B, height, width)
