"""CLAHE of capacity-padded cell crops (skimage equalize_adapthist semantics).

Counterpart of `cell_image_analysis_tpu/ops/clahe.py` on its `impl="pallas"`
path (`_clahe_cells_pallas`).  The plain version, `clahe_cells_plain`, is
that path in tensor code: `clahe_prepare` computes, per cell, the exact
14-bit quantization, the reflect-folded virtual grid (bin and tile id of
every virtual pixel), and the four corner tiles and integer weight
numerators of every output pixel; `clahe_core_plain` builds the tile
histograms, clips and redistributes them, forms the integer CDF maps and
blends `S // (kh*kw)`; the min-max rescale follows.

`clahe_cells` and `clahe_bucket` run the plain version for CPU tensors
and launch the fused kernel `csrc/clahe_cells.cu` (all of the above in one
launch a size bucket, reading the crops in place) for CUDA tensors.  The
core arithmetic is on integers and the few float steps are IEEE, so both
agree bit for bit.  `size_buckets` sorts cells into the size buckets that
the callers run one `clahe_bucket` each for.
"""

from __future__ import annotations

import torch

NR_OF_GRAY = 2 ** 14
NBINS = 256
NS_CAP = 16      # >= ceil(side / max(1, side // 8)) for every side >= 1
NS_CAP_16PX = 12  # enough when every side >= 16 (or <= 12)


def _reflect(idx: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """numpy.pad mode='reflect' fold for 0 <= idx < 2n - 1; idx (N,), n (C, 1)."""
    over = idx - (n - 1)
    idx = torch.where(over > 0, n - 1 - over, idx)
    return torch.minimum(torch.clamp(idx, min=0), torch.clamp(n - 1, min=0))


def _quantize14(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max stretch of each crop (C, cap, cap) to 14-bit gray levels, exact
    for integer-valued crops (ops/clahe._quantize14 of the JAX package)."""
    big = torch.finfo(torch.float32).max
    lo = torch.where(valid, v, big).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(valid, v, -big).amax(dim=(1, 2), keepdim=True)
    # a true division: `int / tensor` would round through a reciprocal
    scale = torch.where(hi > lo, torch.full_like(hi, NR_OF_GRAY - 1) / (hi - lo),
                        torch.zeros_like(hi))
    img14_f = torch.round((v - lo) * scale)
    img14_f = torch.clamp(img14_f, -2.0 ** 31, 2.0 ** 31 - 128).int()

    k = torch.clamp(v - lo, 0.0, 65535.0).int()
    D = torch.clamp(torch.clamp(hi - lo, 0.0, 65535.0).int(), min=1)
    t = 2 * k * (NR_OF_GRAY - 1) + D
    q = t // (2 * D)
    tie = (t % (2 * D)) == 0
    img14_i = q - (tie & ((q % 2) == 1)).int()

    is_int = (v == torch.round(v)) & (v >= 0) & (v < 16777216.0)
    exact_ok = (torch.where(valid, is_int, True).all(dim=(1, 2), keepdim=True)
                & (hi - lo <= 65535.0) & (hi > lo))
    img14 = torch.where(exact_ok, img14_i, img14_f)
    return torch.where(hi > lo, img14, 0)


def clahe_core_plain(vbins, vtiles, pbins, ptiles, pw, clim, area, n_tiles: int):
    """Per-cell CLAHE core on prepared int32 inputs: vbins/vtiles (C, Pv)
    (tile -1 = outside every tile), pbins (C, P), ptiles/pw (C, P, 4), clim
    and area (C,).  Returns (C, P) float32 floor-blended grays."""
    C, Pv = vbins.shape
    dev = vbins.device
    ok = vtiles >= 0
    cell = torch.arange(C, device=dev)[:, None].expand(C, Pv)
    idx = (cell * n_tiles + vtiles.long()) * NBINS + vbins.long()
    hist = torch.bincount(idx[ok], minlength=C * n_tiles * NBINS)
    hist = hist.reshape(C, n_tiles, NBINS)

    # Zuiderveld clip + redistribute, all tiles in lockstep (a tile whose
    # loop has ended adds nothing in later rounds)
    cl = clim.long()[:, None, None]
    n_excess = torch.clamp(hist - cl, min=0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, cl)
    bin_incr = n_excess // NBINS
    upper = cl - bin_incr
    low = hist < upper
    n_excess = n_excess - low.sum(dim=-1, keepdim=True) * bin_incr
    hist = torch.where(low, hist + bin_incr, hist)
    mid = (hist >= upper) & (hist < cl)
    n_excess = n_excess + torch.where(mid, hist - cl, 0).sum(dim=-1, keepdim=True)
    hist = torch.where(mid, cl, hist)
    bin_ids = torch.arange(NBINS, device=dev)
    added = torch.ones_like(n_excess)
    while True:
        active = (n_excess > 0) & (added > 0)
        if not bool(active.any()):
            break
        step = torch.clamp(NBINS // torch.clamp(n_excess, min=1), min=1)
        eligible = (hist < cl) & (bin_ids % step == 0) & active
        rank = torch.cumsum(eligible.long(), dim=-1)
        add = eligible & (rank <= n_excess)
        hist = hist + add.long()
        added = torch.where(active, add.sum(dim=-1, keepdim=True), added)
        n_excess = n_excess - add.sum(dim=-1, keepdim=True)

    cdf = torch.cumsum(hist, dim=-1)
    maps = torch.clamp(cdf * (NR_OF_GRAY - 1) // area.long()[:, None, None],
                       max=NR_OF_GRAY - 1).reshape(C, -1)
    flat = ptiles.long() * NBINS + pbins.long()[..., None]                 # (C, P, 4)
    vals = torch.gather(maps, 1, flat.reshape(C, -1)).reshape(flat.shape)
    S = (vals * pw.long()).sum(dim=-1)
    return (S // area.long()[:, None]).float()


def clahe_prepare(crops, heights, widths, clip_limit: float = 0.02, grid: int = 8,
                  ns_cap: int = NS_CAP):
    """The per-cell inputs of `clahe_core_plain` and the (C, cap, cap) valid mask."""
    C, cap, _ = crops.shape
    dev = crops.device
    if max(1, cap // grid) ** 2 * (NR_OF_GRAY - 1) >= 2 ** 24:
        raise ValueError(f"clahe: crop capacity {cap} too large for the exact blend")
    vcap = cap + max(1, cap // grid)
    h = heights.int().reshape(C, 1)
    w = widths.int().reshape(C, 1)
    ys = torch.arange(cap, device=dev, dtype=torch.int32)
    valid = (ys[None, :, None] < h[:, :, None]) & (ys[None, None, :] < w[:, :, None])

    img14 = _quantize14(crops.float(), valid)
    binned = torch.clamp(img14 // (1 + NR_OF_GRAY // NBINS), 0, NBINS - 1)
    kh = torch.clamp(h // grid, min=1)
    kw = torch.clamp(w // grid, min=1)
    ns_h = (h + kh - 1) // kh
    ns_w = (w + kw - 1) // kw

    yv = torch.arange(vcap, device=dev, dtype=torch.int32)
    ty = (yv // kh)[:, :, None]                                          # (C, vcap, 1)
    tx = (yv // kw)[:, None, :]
    vvalid = (yv < ns_h * kh)[:, :, None] & (yv < ns_w * kw)[:, None, :]
    vtiles = torch.where(vvalid, ty * ns_cap + tx, -1)
    src = (_reflect(yv, h).long()[:, :, None] * cap + _reflect(yv, w).long()[:, None, :])
    vbins = torch.gather(binned.reshape(C, -1), 1, src.reshape(C, -1))

    yp = ys + kh // 2                                                    # (C, cap)
    xp = ys + kw // 2
    pty, ptx = yp // kh, xp // kw
    ay, ax = yp % kh, xp % kw
    tiles4, w4 = [], []
    for ey in (0, 1):
        my = torch.minimum(torch.clamp(pty - 1 + ey, min=0), ns_h - 1)
        ny = ay if ey else kh - ay
        for ex in (0, 1):
            mx = torch.minimum(torch.clamp(ptx - 1 + ex, min=0), ns_w - 1)
            nx = ax if ex else kw - ax
            tiles4.append((my[:, :, None] * ns_cap + mx[:, None, :]).reshape(C, -1))
            w4.append((ny[:, :, None] * nx[:, None, :]).reshape(C, -1))
    ptiles = torch.stack(tiles4, dim=-1).int()
    pw = torch.stack(w4, dim=-1).int()
    khw = (kh * kw).reshape(C)
    clim = torch.clamp((torch.tensor(clip_limit, dtype=torch.float32, device=dev)
                        * khw.float()).int(), min=1)
    return (vbins.reshape(C, -1).int().contiguous(), vtiles.reshape(C, -1).int().contiguous(),
            binned.reshape(C, -1).int().contiguous(), ptiles.contiguous(), pw.contiguous(),
            clim.int(), khw.int(), valid)


def clahe_cells_plain(crops: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor,
                      clip_limit: float = 0.02, grid: int = 8, ns_cap: int = NS_CAP) -> torch.Tensor:
    """The plain version of `clahe_cells` (same contract), on any device."""
    C, cap, _ = crops.shape
    if C == 0:
        return torch.zeros_like(crops, dtype=torch.float32)
    (vbins, vtiles, pbins, ptiles, pw, clim, area, valid) = clahe_prepare(
        crops, heights, widths, clip_limit=clip_limit, grid=grid, ns_cap=ns_cap)
    out = clahe_core_plain(vbins, vtiles, pbins, ptiles, pw, clim, area, ns_cap * ns_cap)
    out = out.reshape(C, cap, cap)

    big = torch.finfo(torch.float32).max
    lo2 = torch.where(valid, out, big).amin(dim=(1, 2), keepdim=True)
    hi2 = torch.where(valid, out, -big).amax(dim=(1, 2), keepdim=True)
    scale2 = torch.where(hi2 > lo2, torch.ones_like(hi2) / (hi2 - lo2), torch.zeros_like(hi2))
    return torch.where(valid, (out - lo2) * scale2, torch.zeros_like(out))


def bucket_caps(caps: tuple, full_cap: int) -> tuple:
    """The capacities of `size_buckets`' buckets, ascending: those of `caps`
    below the full crop capacity, then the full crop capacity."""
    return tuple(c for c in sorted(caps) if c < full_cap) + (full_cap,)


def size_buckets(heights: torch.Tensor, widths: torch.Tensor, valid: torch.Tensor,
                 caps: tuple, full_cap: int) -> list:
    """The CLAHE size buckets of the (N,) cells: [(cell indices, cap,
    ns_cap)], each cell in the tightest capacity that fits; cells with a
    side of 13-15 px need 13-15 tiles on that axis, so they ride the last
    bucket (the full crop capacity, ns_cap 16)."""
    all_caps = bucket_caps(caps, full_cap)
    ns_ok = (((heights >= 16) | (heights <= 12)) & ((widths >= 16) | (widths <= 12)))
    buckets = []
    fits_prev = torch.zeros_like(valid)
    for cap_b in all_caps[:-1]:
        fits = (heights <= cap_b) & (widths <= cap_b) & ns_ok
        buckets.append((valid & fits & ~fits_prev, cap_b, NS_CAP_16PX))
        fits_prev = fits
    buckets.append((valid & ~fits_prev, all_caps[-1], NS_CAP))
    return [(torch.nonzero(mask).flatten(), cap_b, ns_cap) for mask, cap_b, ns_cap in buckets]


def clahe_bucket(crops: torch.Tensor, ids: torch.Tensor, heights: torch.Tensor,
                 widths: torch.Tensor, cap: int, clip_limit: float = 0.02, grid: int = 8,
                 ns_cap: int = NS_CAP) -> torch.Tensor:
    """CLAHE of the cells `ids` (C,) of an (N, full_cap, full_cap) crop
    tensor with heights and widths (N,), at capacity `cap`: what
    `clahe_cells(crops[ids][:, :cap, :cap], heights[ids], widths[ids])`
    returns.  CUDA tensors go through one launch of the fused kernel, which
    reads the crops in place (float32, int32 ids/heights/widths)."""
    if crops.device.type == "cpu":
        ids = ids.long()
        return clahe_cells_plain(crops[ids][:, :cap, :cap], heights[ids], widths[ids],
                                 clip_limit=clip_limit, grid=grid, ns_cap=ns_cap)
    from cell_image_analysis_tpu_torch.ops.cuda.clahe_kernel import clahe_cells_cuda

    return clahe_cells_cuda(crops, ids, heights, widths, cap, clip_limit=clip_limit, grid=grid,
                            ns_cap=ns_cap)


def clahe_cells(crops: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor,
                clip_limit: float = 0.02, grid: int = 8, ns_cap: int = NS_CAP) -> torch.Tensor:
    """Batched CLAHE of (C, cap, cap) crops whose valid region is
    [:h, :w]; every routed cell must have ceil(side / max(1, side // grid))
    <= ns_cap per axis.  Returns (C, cap, cap) float32 in [0, 1], padding 0."""
    C, cap, _ = crops.shape
    ids = torch.arange(C, dtype=torch.int32, device=crops.device)
    return clahe_bucket(crops.float().contiguous(), ids, heights.int(), widths.int(), cap,
                        clip_limit=clip_limit, grid=grid, ns_cap=ns_cap)
