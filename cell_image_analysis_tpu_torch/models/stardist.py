"""StarDist `predict_instances`: U-Net -> candidates -> NMS -> labels.

Counterpart of `cell_image_analysis_tpu/models/stardist.py` on the path
the screening bench runs: percentile normalization, reflect padding to a
multiple of 2**depth, the U-Net with the late dist head, top-K candidates
among the grid pixels inside the frame (lower index first on ties, as
`lax.top_k`), the in-frame local-maximum
count behind `cand_overflow`, sparse-pair star NMS, and the tiled
rasterizer — or the scatter rasterizer for `raster_mode="scatter"` and
for frames whose side is not a multiple of `raster_tile`, as JAX routes
it.  Batched over frames: (B, H, W) raw channels in.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.config import SegConfig
from cell_image_analysis_tpu_torch.ops import gather_rows
from cell_image_analysis_tpu_torch.ops.nms import star_nms
from cell_image_analysis_tpu_torch.ops.percentile import normalize_percentile
from cell_image_analysis_tpu_torch.ops.rasterize import (
    rasterize_polygons,
    rasterize_polygons_tiled,
)


class InstanceDetails(NamedTuple):
    points: torch.Tensor           # (B, K, 2) candidate centers (full-res coords)
    dists: torch.Tensor            # (B, K, R)
    probs: torch.Tensor            # (B, K)
    keep: torch.Tensor             # (B, K) bool
    raster_overflow: torch.Tensor  # (B,) a tile held more than m_cap polygons
    nms_overflow: torch.Tensor     # (B,) more candidate pairs than nms_max_pairs
    cand_overflow: torch.Tensor    # (B,) more in-frame peaks than max_candidates


def _pad_to_multiple(x: torch.Tensor, m: int) -> torch.Tensor:
    ph, pw = (-x.shape[-2]) % m, (-x.shape[-1]) % m
    if ph or pw:
        x = F.pad(x[:, None], (0, pw, 0, ph), mode="reflect")[:, 0]
    return x


def predict_instances(seg_channels: torch.Tensor, model, cfg: SegConfig = SegConfig()):
    """seg_channels (B, H, W) raw -> (labels (B, H, W) int32, InstanceDetails).

    `model` is a `models.unet.StarDistUNet` on the channels' device."""
    B, h, w = seg_channels.shape
    x = normalize_percentile(seg_channels, pmin=cfg.norm_pmin, pmax=cfg.norm_pmax)
    x = _pad_to_multiple(x, 2 ** cfg.unet_depth)
    gy, gx = cfg.grid
    K = cfg.max_candidates

    prob, feat = model(x[..., None])                 # (B, h', w'), (B, h', w', F)
    hp, wp = prob.shape[1:]
    # grid pixels of the reflect padding lie outside the frame: they take no
    # candidate slot (the JAX package sorts them in; on frames whose sides
    # are multiples of 2**depth there are none)
    in_img = ((torch.arange(hp, device=prob.device)[:, None] * gy < h)
              & (torch.arange(wp, device=prob.device)[None, :] * gx < w))
    flat = torch.where(in_img, prob, -math.inf).reshape(B, -1)
    order = torch.sort(flat, dim=1, descending=True, stable=True)
    top_p, top_i = order.values[:, :K], order.indices[:, :K]
    feat_rows = gather_rows(feat.reshape(B, hp * wp, -1), top_i)
    cand_dists = model.dist_head_rows(feat_rows)
    valid = top_p > cfg.prob_thresh

    neigh = F.max_pool2d(prob[:, None], 3, stride=1, padding=1)[:, 0]
    n_peaks = ((prob >= neigh) & (prob > cfg.prob_thresh) & in_img).reshape(B, -1).sum(dim=1)
    cand_ovf = n_peaks > K
    rows = (top_i // wp).float() * gy
    cols = (top_i % wp).float() * gx
    centers = torch.stack([rows, cols], dim=-1)
    cand_dists = torch.clamp(cand_dists, min=1e-3)

    keep, nms_ovf = star_nms(centers, cand_dists, top_p, valid,
                             nms_thresh=cfg.nms_thresh, metric=cfg.nms_metric,
                             max_pairs=cfg.nms_max_pairs)
    tile = cfg.raster_tile
    if cfg.raster_mode == "tiled" and h % tile == 0 and w % tile == 0:
        labels, r_ovf = rasterize_polygons_tiled(
            centers, cand_dists, top_p, keep, h, w, tile=tile,
            m_cap=cfg.raster_m_cap, raster_cap=(cfg.raster_cap or None))
    else:
        labels = rasterize_polygons(centers, cand_dists, top_p, keep, h, w,
                                    patch=cfg.raster_patch, raster_cap=(cfg.raster_cap or None))
        r_ovf = torch.zeros(B, dtype=torch.bool, device=labels.device)
    return labels, InstanceDetails(points=centers, dists=cand_dists, probs=top_p, keep=keep,
                                   raster_overflow=r_ovf, nms_overflow=nms_ovf,
                                   cand_overflow=cand_ovf)
