"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages read the same committed assets: the U-Net weights
(assets/unet_synthetic.pkl) and the scoring parameters
(assets/scoring_synthetic.npz).  Inputs are made with numpy from a seed and
handed to both sides as arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cell_image_analysis_tpu.config import SegConfig as JaxSegConfig
from cell_image_analysis_tpu_torch.config import SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import SCORING_PARAMS_PATH

# the screening bench's StarDist settings (utils/bench.py _batch_pipeline),
# as the port's config and as the JAX package's
BENCH_SEG = SegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
JAX_BENCH_SEG = JaxSegConfig(max_candidates=256, raster_patch=96, raster_cap=128)
BENCH_STAGE_A = dict(label_capacity=128, cell_capacity=128, rcap=32)


def scoring_arrays() -> dict:
    with np.load(SCORING_PARAMS_PATH) as z:
        return {k: z[k] for k in z.files}


def jax_scoring():
    """(flax CAE, JAX ScoringParams) built from the committed npz."""
    import jax.numpy as jnp

    from cell_image_analysis_tpu.models.cae import CAE
    from cell_image_analysis_tpu.models.svm import SVMParams
    from cell_image_analysis_tpu.pipeline.scoring import ScoringParams

    a = scoring_arrays()
    cae: dict = {}
    for key, v in a.items():
        if key.startswith("cae/"):
            _, coll, layer, leaf = key.split("/")
            cae.setdefault(coll, {}).setdefault(layer, {})[leaf] = jnp.asarray(v)

    def svm(name):
        return SVMParams(*(jnp.asarray(a[f"svm_{name}/{f}"]) for f in SVMParams._fields))

    params = ScoringParams(
        cae_variables=cae,
        scaler_center=jnp.asarray(a["scaler_center"]),
        scaler_scale=jnp.asarray(a["scaler_scale"]),
        pca_mean=jnp.asarray(a["pca_mean"]),
        pca_components=jnp.asarray(a["pca_components"]),
        svm_conservative=svm("conservative"),
        svm_moderate=svm("moderate"),
        ensemble_mse_threshold=jnp.asarray(a["ensemble_mse_threshold"]),
        fft_scaler_center=jnp.asarray(a["fft_scaler_center"]),
        fft_scaler_scale=jnp.asarray(a["fft_scaler_scale"]),
        svm_fft=svm("fft"),
    )
    return CAE(), params


def padded_crops(rng, sizes, cap, scale=3000.0, garbage=1e9):
    """(C, cap, cap) integer-valued crops of the given (h, w) sizes, with
    garbage in the padding (it must not affect any result)."""
    crops = np.full((len(sizes), cap, cap), garbage, np.float32)
    for i, (h, w) in enumerate(sizes):
        crops[i, :h, :w] = np.round(rng.uniform(size=(h, w)) * scale)
    hs = np.array([s[0] for s in sizes], np.int32)
    ws = np.array([s[1] for s in sizes], np.int32)
    return crops, hs, ws


def torch_threads() -> None:
    """The suite runs under several xdist workers: one thread each."""
    torch.set_num_threads(1)


def unblock_filter(Ub: torch.Tensor) -> torch.Tensor:
    """`ops.winograd.kernel_filter_layout` undone: (Co_p/32, Ci_p/8, 16, 2,
    32, 4) -> (16, Ci_p, Co_p)."""
    cb, ch = Ub.shape[:2]
    return Ub.permute(2, 1, 3, 5, 0, 4).reshape(16, 8 * ch, 32 * cb)


def winograd_kernel_emulation(xp: torch.Tensor, U_hi: torch.Tensor, U_lo: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """The arithmetic of `csrc/winograd_conv3x3.cu` in float32 torch on the
    CPU, on the launcher's operands (`ops.winograd.pad_input`,
    `winograd_operands`): the input transform V = B^T d B with the kernel's
    adds, V split into TF32 halves, the three products lo*hi + hi*lo +
    hi*hi summed over Ci in float32, and the inverse transform plus bias,
    as the kernel's two warpgroups form it: the partial Y of position rows
    0-1 plus that of rows 2-3.  TF32 products are exact in float32, so only
    the order of the sums over Ci differs from the tensor cores."""
    from cell_image_analysis_tpu_torch.ops.winograd import tf32_split

    B, H, W, ci = xp.shape
    co = bias.shape[0]
    d = F.pad(xp, (0, 0, 1, 1, 1, 1)).unfold(1, 4, 2).unfold(2, 4, 2)  # (B, H/2, W/2, ci, 4, 4)
    rt = torch.stack([d[..., 0, :] - d[..., 2, :], d[..., 1, :] + d[..., 2, :],
                      d[..., 2, :] - d[..., 1, :], d[..., 1, :] - d[..., 3, :]], dim=-2)
    V = torch.stack([rt[..., 0] - rt[..., 2], rt[..., 1] + rt[..., 2],
                     rt[..., 2] - rt[..., 1], rt[..., 1] - rt[..., 3]], dim=-1)
    V = V.reshape(-1, ci, 16).permute(2, 0, 1)                             # (16, tiles, ci)
    V_hi, V_lo = tf32_split(V)
    U_hi, U_lo = unblock_filter(U_hi)[..., :co], unblock_filter(U_lo)[..., :co]
    M = V_lo @ U_hi + V_hi @ U_lo + V_hi @ U_hi                            # (16, tiles, co)
    m = M.permute(1, 2, 0).reshape(B, H // 2, W // 2, co, 4, 4)

    def partial(c0, c1):  # A^T's columns for the rows a with c0[a], c1[a] in output rows 0, 1
        g0 = sum(c * m[..., a, :] for a, c in enumerate(c0) if c)
        g1 = sum(c * m[..., a, :] for a, c in enumerate(c1) if c)
        return torch.stack([torch.stack([g[..., 0] + g[..., 1] + g[..., 2],
                                         g[..., 1] - g[..., 2] - g[..., 3]], dim=-1)
                            for g in (g0, g1)], dim=-2)                   # (..., co, 2, 2)

    y = partial((1, 1, 0, 0), (0, 1, 0, 0)) + partial((0, 0, 1, 0), (0, 0, -1, -1))
    y = y + bias[:, None, None]
    return y.permute(0, 1, 4, 2, 5, 3).reshape(B, H, W, co)


def winograd_3xtf32(x: torch.Tensor, W: torch.Tensor, bias: torch.Tensor, *, in_scale=None,
                    in_shift=None, out_relu: bool = False) -> torch.Tensor:
    """What the CUDA route of `ops.winograd.winograd_conv3x3` computes, on
    the CPU: the wrapper's padding and operands, the kernel's arithmetic;
    with an input prologue, relu(scale x + shift) in one rounding (the
    kernel's fmaf) on the pixels of the frame before the even padding only,
    the padded row or column and the channels left 0; with `out_relu`,
    relu at the end."""
    from cell_image_analysis_tpu_torch.ops.winograd import (
        input_affine,
        pad_input,
        winograd_operands,
    )

    h, w = x.shape[1:3]
    xp = pad_input(x)
    if in_scale is not None:
        scale, shift = input_affine(in_scale, in_shift, xp.shape[-1])
        shift = shift[:, None, None, :] if shift.dim() == 2 else shift
        act = torch.relu((scale.double() * xp.double() + shift.double()).float())
        frame = torch.zeros(xp.shape[1:3], dtype=torch.bool)
        frame[:h, :w] = True
        xp = torch.where(frame[None, :, :, None], act, torch.zeros(()))
    y = winograd_kernel_emulation(xp, *winograd_operands(W, bias))[:, :h, :w]
    return torch.relu(y) if out_relu else y


# the fused activations' cases (b, h, w, ci, co, act): the input prologue
# with its shift per channel ("channel") or per image ("image"), or the
# output ReLU ("out_relu"); Ci = 2 and 5 (padded to 8), Co not a multiple
# of 32, odd sides
WINO_ACT_CASES = [
    (2, 10, 12, 2, 7, "channel"),
    (2, 9, 11, 16, 40, "image"),
    (1, 7, 8, 5, 33, "out_relu"),
    (3, 8, 9, 8, 32, "channel"),
    (2, 18, 22, 64, 64, "image"),
]


def wino_act_inputs(case, device="cpu", seed: int = 0) -> tuple:
    """(x, W, bias, activation keywords) of a `WINO_ACT_CASES` entry: the
    shift positive everywhere, so that padding read as relu(shift) instead
    of 0 shows, the scale of either sign."""
    b, h, w, ci, co, act = case
    g = torch.Generator().manual_seed(seed + 1000 * ci + co)
    x = torch.randn((b, h, w, ci), generator=g)
    W = torch.randn((3, 3, ci, co), generator=g) / (3 * ci ** 0.5)
    bias = torch.randn((co,), generator=g) * 0.1
    scale = torch.rand((ci,), generator=g) * 3 - 1
    shift = torch.rand((b, ci) if act == "image" else (ci,), generator=g) + 0.5
    kw = (dict(out_relu=True) if act == "out_relu" else
          dict(in_scale=scale.to(device), in_shift=shift.to(device)))
    return x.to(device), W.to(device), bias.to(device), kw


def wino_act_unfused(x, W, bias, in_scale=None, in_shift=None, out_relu=False) -> torch.Tensor:
    """The unfused composition: the activation as its own pass, F.conv2d's
    SAME conv (zero padding of the activated input), the ReLU after."""
    if in_scale is not None:
        shift = in_shift[:, None, None, :] if in_shift.dim() == 2 else in_shift
        x = torch.relu(x * in_scale + shift)
    y = F.conv2d(x.permute(0, 3, 1, 2), W.permute(3, 2, 0, 1), bias, padding=1)
    y = y.permute(0, 2, 3, 1)
    return torch.relu(y) if out_relu else y


def _band_of(rank: int, bands: int, h: int, kh: int, ns_h: int):
    """`band_of` of csrc/clahe_cells.cu: (r0, r1, y0, y1, yb0, yb1)."""
    per = (ns_h + bands - 1) // bands
    r0 = min(rank * per, ns_h)
    r1 = min(r0 + per, ns_h)
    if r0 >= r1:
        return 0, 0, 0, 0, 0, 0
    last = r1 == ns_h
    y0 = 0 if r0 == 0 else r0 * kh - kh // 2
    y1 = h if last else r1 * kh - kh // 2
    yb0 = min(y0, max(0, 2 * h - 1 - ns_h * kh)) if last else y0
    return r0, r1, y0, y1, yb0, min(r1 * kh, h)


def _reflect_np(i: np.ndarray, n: int) -> np.ndarray:
    over = i - (n - 1)
    i = np.where(over > 0, n - 1 - over, i)
    return np.minimum(np.maximum(i, 0), max(n - 1, 0))


def _clip_hist_np(hist: np.ndarray, clim: int) -> np.ndarray:
    """The kernel's `clip_histogram` on one 256-bin histogram."""
    h = hist.astype(np.int64)
    n_excess = int(np.maximum(h - clim, 0).sum())
    h = np.minimum(h, clim)
    bin_incr = n_excess // 256
    upper = clim - bin_incr
    low = h < upper
    n_excess -= int(low.sum()) * bin_incr
    h = np.where(low, h + bin_incr, h)
    mid = (h >= upper) & (h < clim)
    n_excess += int(np.where(mid, h - clim, 0).sum())
    h = np.where(mid, clim, h)
    added = 1
    while n_excess > 0 and added > 0:
        step = max(1, 256 // max(n_excess, 1))
        el = (h < clim) & (np.arange(256) % step == 0)
        add = el & (np.cumsum(el) <= n_excess)
        h = h + add
        added = int(add.sum())
        n_excess -= added
    return h


def clahe_kernel_emulation(crops: np.ndarray, ids, heights, widths, cap: int, bands: int,
                           clip_limit: float = 0.02, grid: int = 8, ns_cap: int = 16) -> np.ndarray:
    """The work split of `csrc/clahe_cells.cu` in numpy on the CPU: for each
    cell `ids[c]` of the (N, full_cap, full_cap) float32 `crops`, read in
    place, the kernel's `bands` blocks each reduce min / max / integrality
    over their own crop rows, combine the partials, quantize and bin only
    their rows, build only their band's tile histograms and CDF maps, blend
    their output rows with the row of maps above the band taken from the
    neighbouring band, and combine per-band min / max partials of the blend
    for the rescale.  Every access outside a band's rows or maps raises."""
    f32 = np.float32
    out = np.zeros((len(ids), cap, cap), f32)
    for c, i in enumerate(ids):
        h, w = int(heights[i]), int(widths[i])
        assert 0 <= h <= cap and 0 <= w <= cap
        if h == 0 or w == 0:
            continue
        crop = crops[i]
        kh, kw = max(h // grid, 1), max(w // grid, 1)
        ns_h, ns_w = -(-h // kh), -(-w // kw)
        assert ns_h <= ns_cap and ns_w <= ns_cap
        bnds = [_band_of(r, bands, h, kh, ns_h) for r in range(bands)]
        per = (ns_h + bands - 1) // bands

        # 1. per-band partials of min, max and integrality, then combined
        lo, hi, int_ok = f32(np.finfo(f32).max), f32(-np.finfo(f32).max), True
        for (_, _, _, _, yb0, yb1) in bnds:
            v = crop[yb0:yb1, :w]
            if v.size:
                lo, hi = min(lo, v.min()), max(hi, v.max())
                int_ok &= bool(np.all((v == np.rint(v)) & (v >= 0) & (v < 16777216.0)))
        rng_ = f32(hi - lo)
        exact = int_ok and rng_ <= 65535.0 and hi > lo
        scale = f32(16383) / rng_ if hi > lo else f32(0)
        D = max(int(min(max(rng_, f32(0)), f32(65535))), 1)

        # 2. bins of each band's own rows
        bins = []
        for (_, _, _, _, yb0, yb1) in bnds:
            v = crop[yb0:yb1, :w]
            if not hi > lo:
                q14 = np.zeros(v.shape, np.int64)
            elif exact:
                k = np.clip(v - lo, 0, 65535).astype(np.int64)
                t = 2 * k * 16383 + D
                q, r = t // (2 * D), t % (2 * D)
                q14 = q - ((r == 0) & (q % 2 == 1))
            else:
                fq = np.rint((v - lo) * scale)
                q14 = np.clip(fq, -2.0 ** 31, 2.0 ** 31 - 128).astype(np.int64)
            bins.append(np.clip(q14 // 65, 0, 255))

        def band_bins(r, rows):
            yb0, yb1 = bnds[r][4:]
            assert np.all((rows >= yb0) & (rows < yb1)), "a row outside the band's bins"
            return bins[r][rows - yb0]

        # 3. each band's tile histograms, clipped, as integer CDF maps
        area = kh * kw
        clim = max(int(f32(clip_limit) * f32(area)), 1)
        xv = np.arange(ns_w * kw)
        maps = []
        for r, (r0, r1, *_) in enumerate(bnds):
            m = np.zeros((r1 - r0, ns_w, 256), np.int64)
            for ty in range(r0, r1):
                yv = np.arange(ty * kh, (ty + 1) * kh)
                b = band_bins(r, _reflect_np(yv, h))[:, _reflect_np(xv, w)]
                for tx in range(ns_w):
                    hist = np.bincount(b[:, tx * kw:(tx + 1) * kw].ravel(), minlength=256)
                    cdf = np.cumsum(_clip_hist_np(hist, clim))
                    m[ty - r0, tx] = np.minimum(cdf * 16383 // area, 16383)
            maps.append(m)

        # 4. the blend of each band's output rows; the maps above the band
        # come from its neighbour
        x = np.arange(w)
        xp = x + kw // 2
        ptx, ax = xp // kw, xp % kw
        mx0, mx1 = np.clip(ptx - 1, 0, ns_w - 1), np.minimum(ptx, ns_w - 1)
        blends, parts = [], []
        for r, (r0, r1, y0, y1, _, _) in enumerate(bnds):
            rows = np.arange(y0, y1)
            yp = rows + kh // 2
            pty, ay = yp // kh, yp % kh

            def tile_rows(my):
                owner = my // per
                assert np.all((owner == r) | (owner == r - 1)), "maps beyond the neighbour"
                return np.stack([maps[o][t - o * per] for o, t in zip(owner, my)]) \
                    if len(my) else np.zeros((0, ns_w, 256), np.int64)

            t0 = tile_rows(np.clip(pty - 1, 0, ns_h - 1))
            t1 = tile_rows(np.minimum(pty, ns_h - 1))
            b = band_bins(r, rows)                                    # (rows, w)
            ri = np.arange(len(rows))[:, None]
            m00, m01 = t0[ri, mx0, b], t0[ri, mx1, b]
            m10, m11 = t1[ri, mx0, b], t1[ri, mx1, b]
            ny0, ny1 = (kh - ay)[:, None], ay[:, None]
            nx0, nx1 = kw - ax, ax
            v = (ny0 * (nx0 * m00 + nx1 * m01) + ny1 * (nx0 * m10 + nx1 * m11)) // area
            blends.append((y0, y1, v))
            if v.size:
                parts.append((v.min(), v.max()))

        # 5. min / max from the per-band partials, then the rescale
        lo2, hi2 = f32(min(p[0] for p in parts)), f32(max(p[1] for p in parts))
        scale2 = f32(1) / (hi2 - lo2) if hi2 > lo2 else f32(0)
        for y0, y1, v in blends:
            out[c, y0:y1, :w] = (v.astype(f32) - lo2) * scale2
    return out


def _find(p, x, halve: bool = True) -> int:
    """Root of x in parent array p, halving the path as `find_root` does;
    a parent that no pass wrote (-1) is a fault of the emulated kernel."""
    px = p[x]
    while px != x:
        assert px >= 0, f"read parent[{x}], which no pass wrote"
        gp = p[px]
        assert gp >= 0, f"read parent[{px}], which no pass wrote"
        if halve and gp != px:
            p[x] = min(p[x], gp)
        x, px = px, gp
    return x


def _unite(p, a: int, b: int) -> None:
    """`unite`: link the larger root under the smaller (one thread's atomicMin
    at a time: the kernel's unions in some order)."""
    a, b = _find(p, a), _find(p, b)
    if a != b:
        a, b = min(a, b), max(a, b)
        p[b] = a


def _tile_local(t: np.ndarray, conn: int, rng) -> np.ndarray:
    """`build_tile` of csrc/cc_tile_labels.cu on one (th, tw) tile (False
    outside the frame): each foreground pixel's local root (tile-local
    index), -1 on the background.  Pixels start at their run's first pixel;
    the unions with the row above, minus those a left neighbour's implies,
    run in an order drawn from rng."""
    th, tw = t.shape
    col = np.arange(tw)
    start = np.maximum.accumulate(np.where(t, -1, col), axis=1) + 1   # run starts
    l = np.where(t, np.arange(th)[:, None] * tw + start, -1).reshape(-1)
    pairs = []
    for r, c in zip(*np.nonzero(t[1:])):
        r += 1
        i = r * tw + c
        up, left = t[r - 1, c], c > 0 and t[r, c - 1]
        if up and not (left and t[r - 1, c - 1]):
            pairs.append((i, i - tw))
        if conn == 2:
            if c > 0 and not up and not left and t[r - 1, c - 1]:
                pairs.append((i, i - tw - 1))
            if c + 1 < tw and not up and not t[r, c + 1] and t[r - 1, c + 1]:
                pairs.append((i, i - tw + 1))
    for k in rng.permutation(len(pairs)):
        _unite(l, *pairs[k])
    for i in np.flatnonzero(t):
        l[i] = _find(l, i, halve=False)
    return l


def cc_tile_emulation(mask: np.ndarray, conn: int, th: int = 32, tw: int = 64, seed: int = 0):
    """The passes of `csrc/cc_tile_labels.cu` in numpy at tile th x tw,
    with the unions of each pass in an order drawn from `seed`: (labels
    (B, H, W) int32, count (B,) int32), `label_components`' contract.

    A  tile-local union-find; parent[g] = g at local roots and
       parent[p] = root(p) at the foreground pixels of the tile's edges;
       a bit a local root in its (row, tile column) segment's word;
    B  unions in `parent` of the touching foreground pairs across tile
       edges, minus those the pair beside them in the same tiles implies;
    C  a segment keeps the bits of the local roots that are still roots;
       its count of them before it in its row, and each row's total;
    D  exclusive prefix of the rows' totals;
    E  tile-local union-find again; each local root's global root G gets
       1 + prefix(row(G)) + offset(segment(G)) + the roots before G in its
       segment."""
    rng = np.random.default_rng(seed)
    m = np.asarray(mask, bool)
    B, H, W = m.shape
    ty_n, tx_n = -(-H // th), -(-W // tw)
    parent = np.full((B, H * W), -1, np.int64)
    bits = np.zeros((B, H, tx_n), object)
    tiles = [(b, ty, tx) for b in range(B) for ty in range(ty_n) for tx in range(tx_n)]

    def tile(b, ty, tx):
        t = np.zeros((th, tw), bool)
        sub = m[b, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
        t[:sub.shape[0], :sub.shape[1]] = sub
        return t, _tile_local(t, conn, rng), sub.shape

    def g(ty, tx, i):
        return (ty * th + i // tw) * W + tx * tw + i % tw

    # A
    for k in rng.permutation(len(tiles)):
        b, ty, tx = tiles[k]
        t, l, (rows_in, cols_in) = tile(b, ty, tx)
        for i in np.flatnonzero(t):
            r, c = divmod(i, tw)
            if l[i] == i:
                bits[b, ty * th + r, tx] |= 1 << int(c)
            if l[i] == i or r in (0, rows_in - 1) or c in (0, cols_in - 1):
                parent[b, g(ty, tx, i)] = g(ty, tx, l[i])
    # B
    pairs = []
    for b in range(B):
        f = m[b].reshape(-1)
        for r in range(th, H, th):
            for c in range(W):
                pi, qi = r * W + c, (r - 1) * W + c
                if not f[pi]:
                    continue
                up, inner_l, inner_r = f[qi], c % tw != 0, (c + 1) % tw != 0
                if up and not (inner_l and f[pi - 1] and f[qi - 1]):
                    pairs.append((b, pi, qi))
                if conn == 2 and c > 0 and f[qi - 1] and not (inner_l and (up or f[pi - 1])):
                    pairs.append((b, pi, qi - 1))
                if (conn == 2 and c + 1 < W and f[qi + 1]
                        and not (inner_r and (up or f[pi + 1]))):
                    pairs.append((b, pi, qi + 1))
        for c in range(tw, W, tw):
            for r in range(H):
                pi, qi = r * W + c, r * W + c - 1
                if not f[pi]:
                    continue
                left, inner_u = f[qi], r % th != 0
                if left and not (inner_u and f[pi - W] and f[qi - W]):
                    pairs.append((b, pi, qi))
                if conn == 2 and inner_u and f[qi - W] and not (left or f[pi - W]):
                    pairs.append((b, pi, qi - W))
                if (conn == 2 and r + 1 < H and (r + 1) % th != 0 and f[qi + W]
                        and not (left or f[pi + W])):
                    pairs.append((b, pi, qi + W))
    for k in rng.permutation(len(pairs)):
        b, pi, qi = pairs[k]
        _unite(parent[b], pi, qi)
    # C
    for (b, r, tx), word in np.ndenumerate(bits):
        bits[b, r, tx] = sum(1 << c for c in range(tw) if word >> c & 1
                             and parent[b, r * W + tx * tw + c] == r * W + tx * tw + c)
    counts = np.vectorize(lambda x: bin(x).count("1"), otypes=[np.int64])(bits)
    offsets = np.cumsum(counts, axis=2) - counts                      # within the row
    rows = counts.sum(axis=2)
    # D
    row_first = np.cumsum(rows, axis=1) - rows
    count = rows.sum(axis=1).astype(np.int32)
    # E
    labels = np.zeros((B, H, W), np.int32)
    for k in rng.permutation(len(tiles)):
        b, ty, tx = tiles[k]
        t, l, (rows_in, cols_in) = tile(b, ty, tx)
        lab = {}
        for i in np.flatnonzero(t & (l.reshape(th, tw) == np.arange(th * tw).reshape(th, tw))):
            G = _find(parent[b].copy(), g(ty, tx, i), halve=False)
            gr, gc = divmod(int(G), W)
            s = (b, gr, gc // tw)
            lab[i] = (1 + row_first[b, gr] + offsets[s]
                      + bin(bits[s] & ((1 << (gc % tw)) - 1)).count("1"))
        out = np.array([lab[li] if li >= 0 else 0 for li in l]).reshape(th, tw)
        labels[b, ty * th:ty * th + rows_in, tx * tw:tx * tw + cols_in] = out[:rows_in, :cols_in]
    return labels, count


def write_jax_store(model_dir: str, fft: bool = True, ensemble: bool = True, X=None) -> dict:
    """A model directory written by the JAX package's own
    `save_training_artifacts` from `utils/bench._fit_params(seed=0, X=X)`'s
    `host` dict; returns that dict.  `fft` / `ensemble` False leave out the
    optional files, as a store from before those capabilities."""
    from cell_image_analysis_tpu.io.artifacts import save_training_artifacts
    from cell_image_analysis_tpu.utils.bench import _fit_params

    _, _, host = _fit_params(seed=0, X=X)
    save_training_artifacts(
        model_dir, host["model"], host["variables"], host["variables"], host["scaler"],
        host["pca"], {"Conservative": host["cons"], "Moderate": host["mod"]},
        host["ens"] if ensemble else None,
        fft_scaler=host["fft_scaler"] if fft else None,
        fft_detector=host["fft_det"] if fft else None)
    return host


# a narrow StarDist U-Net for the mesh tests: depth 2, 8 base filters
NARROW_UNET = dict(depth=2, base_filters=8, head_filters=16)


def narrow_unet(epochs: int = 100):
    """(port U-Net module on the CPU, its flax-layout variables): the
    `NARROW_UNET` architecture from `init_unet(0)`, fitted on 4 synthetic
    128^2 frames (`synthetic_training_set`), full batch at lr 1e-2, enough
    to find most cells of a `make_frame` frame.  Both packages take the
    variables, so their runs share every weight."""
    from cell_image_analysis_tpu_torch.io.artifacts import unet_params_to_jax
    from cell_image_analysis_tpu_torch.models.unet import init_unet
    from cell_image_analysis_tpu_torch.train.unet_trainer import (
        make_unet_optimizer,
        synthetic_training_set,
        training_tensors,
        unet_train_step,
    )

    model = init_unet(0, device="cpu", **NARROW_UNET)
    frames, labels = synthetic_training_set(n_frames=4, size=128)[:2]
    batch = training_tensors(frames, labels, device="cpu")
    opt = make_unet_optimizer(model, 1e-2)
    for _ in range(epochs):
        unet_train_step(model, opt, batch)
    model.eval()
    return model, {"params": unet_params_to_jax(model.state_dict())}


def _tf32_np(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 values (`ops.winograd.tf32_round`)."""
    bits = np.asarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).astype(np.int32).view(np.float32)


def vit_attention_kernel_emulation(q, k, vt, rel_h, rel_w, scale: float) -> np.ndarray:
    """`csrc/vit_attention.cu` on the CPU, block by block and thread by
    thread, with the kernel's index arithmetic: the cp.async offsets of K
    and of the key-permuted `vt` in the stage, the in-place TF32 split, the
    wgmma m64n32k8 operands (A from each thread's fragment registers, B
    from the stage through the no-swizzle K-major descriptor: element (k,
    n) at 128 (k / 4) + 4 n + k % 4 floats), the accumulators' rows and
    columns, the bias, the online softmax with exp2 and the P fragments
    taken from the accumulators as they lie, each key block's P V summed
    apart and added to the output.  The products sum in float64;
    q, k, vt (BH, N, 64) / (BH, 64, N), rel_h (BH, N, N / 32), rel_w (BH,
    N, 32) float32 numpy -> (BH, N, 64) float32."""
    BH, N, D = q.shape
    KH, HALF, OPER, LOG2E = rel_h.shape[-1], 16 * 32 * 4, 2 * 16 * 32 * 4, np.float32(
        1.4426950408889634)
    out = np.zeros((BH, N, D), np.float32)
    tid = np.arange(256)
    lane, warp = tid & 31, tid >> 5
    g, t = lane >> 2, lane & 3

    def wgmma(acc, a_regs, smem, base, wg):
        # acc (128, 16), a_regs (128, 4): the warpgroup's threads
        A = np.zeros((64, 8))
        th = np.arange(128)
        for i in range(4):
            rows = 16 * (th >> 5) + ((th & 31) >> 2) + 8 * (i & 1)
            cols = (th & 3) + 4 * (i >> 1)
            A[rows, cols] = a_regs[:, i]
        kk, nn = np.meshgrid(np.arange(8), np.arange(32), indexing="ij")
        B = smem[base + 128 * (kk // 4) + 4 * nn + kk % 4].astype(np.float64)
        C = A @ B
        for e in range(16):
            n, ee = e >> 2, e & 3
            rows = 16 * (th >> 5) + ((th & 31) >> 2) + 8 * (ee >> 1)
            cols = 8 * n + 2 * (th & 3) + (ee & 1)
            acc[:, e] += C[rows, cols]

    for bh in range(BH):
        for qb in range(N // 128):
            row0 = qb * 128 + 16 * warp + g                       # (256,)
            qa = np.zeros((256, 8, 8), np.float32)
            for s in range(8):
                for i in range(4):
                    x = q[bh, row0 + 8 * (i & 1), 8 * s + t + 4 * (i >> 1)] * np.float32(scale)
                    qa[:, s, i] = _tf32_np(x)
                    qa[:, s, 4 + i] = _tf32_np(x - qa[:, s, i])
            rw = np.zeros((256, 2, 8), np.float32)
            for r in range(2):
                for n in range(4):
                    for j in range(2):
                        rw[:, r, 2 * n + j] = rel_w[bh, row0 + 8 * r, 8 * n + 2 * t + j]
            o = np.zeros((256, 2, 16), np.float64)
            m = np.full((256, 2), -np.inf, np.float32)
            l_ = np.zeros((256, 2), np.float32)
            for blk in range(N // 64):
                S = np.zeros(4 * OPER, np.float32)
                k0 = blk * 64
                for e in range(1024):
                    j, n = (e & 3) + 4 * (e >> 8), (e >> 2) & 63
                    off = (n >> 5) * HALF + j * 128 + (n & 31) * 4
                    S[off:off + 4] = k[bh, k0 + n, 4 * j:4 * j + 4]
                    S[2 * OPER + off:2 * OPER + off + 4] = vt[bh, n, k0 + 4 * j:k0 + 4 * j + 4]
                for op in range(2):
                    x = S[2 * op * OPER:(2 * op + 1) * OPER].copy()
                    S[2 * op * OPER:(2 * op + 1) * OPER] = _tf32_np(x)
                    S[(2 * op + 1) * OPER:(2 * op + 2) * OPER] = _tf32_np(x - _tf32_np(x))
                for wg in range(2):
                    th = slice(128 * wg, 128 * wg + 128)
                    sc = np.zeros((128, 2, 16), np.float64)
                    for s in range(8):
                        for h in range(2):
                            base = h * HALF + 2 * s * 128
                            wgmma(sc[:, h], qa[th, s, 4:], S, base, wg)
                            wgmma(sc[:, h], qa[th, s, :4], S, OPER + base, wg)
                            wgmma(sc[:, h], qa[th, s, :4], S, base, wg)
                    sc = sc.astype(np.float32)
                    r0 = row0[th]
                    mx = m[th].copy()
                    for h in range(2):
                        for n in range(4):
                            for e in range(4):
                                r = e >> 1
                                rh = rel_h[bh, r0 + 8 * r, 2 * blk + h]
                                x = (sc[:, h, 4 * n + e] + rh) + rw[th, r, 2 * n + (e & 1)]
                                sc[:, h, 4 * n + e] = x
                                mx[:, r] = np.maximum(mx[:, r], x)
                    quad = mx.reshape(32, 4, 2).max(axis=1)              # the xor-1, 2 shuffles
                    mx = np.repeat(quad, 4, axis=0)
                    alpha = np.exp2((m[th] - mx) * LOG2E).astype(np.float32)
                    m[th] = mx
                    l_[th] *= alpha
                    pa = np.zeros((128, 8, 8), np.float32)
                    for s in range(8):
                        h, n = s >> 2, s & 3
                        p = np.zeros((128, 4), np.float32)
                        for e in range(4):
                            p[:, e] = np.exp2((sc[:, h, 4 * n + e] - m[th, e >> 1]) * LOG2E)
                            l_[th, e >> 1] += p[:, e]
                        a = p[:, [0, 2, 1, 3]]
                        pa[:, s, :4] = _tf32_np(a)
                        pa[:, s, 4:] = _tf32_np(a - pa[:, s, :4])
                    for h in range(2):                  # the block's P V apart
                        pv = np.zeros((128, 16))
                        for s in range(8):
                            base = 2 * OPER + h * HALF + 2 * s * 128
                            wgmma(pv, pa[:, s, 4:], S, base, wg)
                            wgmma(pv, pa[:, s, :4], S, OPER + base, wg)
                            wgmma(pv, pa[:, s, :4], S, base, wg)
                        o[th, h] = (o[th, h].astype(np.float32) * alpha[:, (np.arange(16) >> 1) & 1]
                                    + pv.astype(np.float32))
            lq = np.repeat(l_.reshape(64, 4, 2).sum(axis=1), 4, axis=0)
            for h in range(2):
                for n in range(4):
                    for r in range(2):
                        for j in range(2):
                            out[bh, row0 + 8 * r, 32 * h + 8 * n + 2 * t + j] = (
                                o[:, h, 4 * n + 2 * r + j] / lq[:, r])
    return out


def _rz_f32(v: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero: the tensor cores' float32
    accumulation, which drops the low bits of every sum."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _sw128(r, k):
    """Float index of element (r, k) of a 32-wide K-major tile under the
    128-byte swizzle (TMA's placement): byte 128 r + 16 ((k / 4) ^ (r % 8))
    + 4 (k % 4)."""
    return 32 * r + 4 * ((k >> 2) ^ (r & 7)) + (k & 3)


def vit_linear_kernel_emulation(x, w, b, promote: bool = True) -> np.ndarray:
    """`csrc/vit_linear.cu` on the CPU, tile by tile and thread by thread,
    with the kernel's index arithmetic: TMA's 128-byte swizzled placement of
    the x and W stages, the splitter warps' in-place TF32 split of W, each
    consumer lane's ldmatrix.x4 address and the registers it returns (the
    TF32 A fragment, split in registers), the B operand read through the
    swizzled K-major descriptor advanced 32 bytes a k step, the product order
    (a stage's 8 small products lo*hi, hi*lo, then its 4 hi*hi), the accumulators' rows and columns and
    the bias at the store.  The tensor cores' sums are modelled as exact sums
    of the 8 products and the accumulator, rounded toward zero to float32;
    a stage's 12 products start from zero and are added to the tile's sum in
    float32 (`promote=False`: one chain over the whole of K, as a kernel
    without the promotion would run).  x (M, K), w (N, K), b (N) float32
    numpy, M, N multiples of 128, K of 32 -> (M, N) float32."""
    M, K = x.shape
    N = w.shape[0]
    y = np.zeros((M, N), np.float32)
    lane = np.arange(32)
    th = np.arange(128)                                   # a consumer warpgroup's threads
    warp, g, t = th >> 5, (th & 31) >> 2, th & 3
    e = np.arange(64)
    acc_rows = (16 * warp + g)[:, None] + 8 * ((e & 3) >> 1)[None, :]     # (128, 64)
    acc_cols = (8 * (e >> 2) + (e & 1))[None, :] + 2 * t[:, None]
    a_rows = (16 * warp + g)[:, None] + 8 * (np.arange(4) & 1)[None, :]   # (128, 4)
    a_cols = t[:, None] + 4 * (np.arange(4) >> 1)[None, :]
    place = _sw128(np.arange(128)[:, None], np.arange(32)[None, :])      # (128, 32)
    # ldmatrix.x4: lane L gives the byte address of row L % 8 of matrix L / 8; a
    # lane receives word lane % 4 of row lane / 4 of each matrix i
    ld_src = np.zeros((2, 4, 128, 4), np.int64)          # [cwg][ks][thread][register]
    for cwg in range(2):
        for ks in range(4):
            for wp in range(4):
                lrow = 64 * cwg + 16 * wp + (lane & 7) + 8 * ((lane >> 3) & 1)
                addr = lrow * 128 + (((2 * ks + (lane >> 4)) ^ (lane & 7)) << 4)
                for i in range(4):
                    ld_src[cwg, ks, 32 * wp + lane, i] = addr[8 * i + (lane >> 2)] // 4 + (lane & 3)
    # the B descriptor of k step ks: element (k, n) at byte 1024 (n / 8) + 128 (n % 8) + 32 ks
    # + 4 k, before the swizzle XORs bits 4-6 with bits 7-9
    nn, kl = np.arange(128)[None, :], np.arange(8)[:, None]
    b_src = []
    for ks in range(4):
        una = (nn >> 3) * 1024 + (nn & 7) * 128 + 32 * ks + 4 * kl
        b_src.append((una ^ (((una >> 7) & 7) << 4)) >> 2)                 # (8, 128)
    for m0 in range(0, M, 128):
        for n0 in range(0, N, 128):
            sums = np.zeros((2, 128, 64), np.float32)
            acc = np.zeros((2, 128, 64), np.float32)
            for kb in range(K // 32):
                xs = np.zeros(4096, np.float32)
                ws = np.zeros(4096, np.float32)
                xs[place] = x[m0:m0 + 128, 32 * kb:32 * kb + 32]
                ws[place] = w[n0:n0 + 128, 32 * kb:32 * kb + 32]
                whi = _tf32_np(ws)                        # the splitters, in place
                wlo = _tf32_np(ws - whi)
                for cwg in range(2):
                    ahi, alo = [], []
                    for ks in range(4):
                        regs = xs[ld_src[cwg, ks]]
                        ahi.append(_tf32_np(regs))
                        alo.append(_tf32_np(regs - ahi[ks]))
                    # the small products of the stage's 4 k steps, then its hi * hi
                    order = [(ks, a, bsm) for ks in range(4) for a, bsm in ((alo, whi), (ahi, wlo))]
                    order += [(ks, ahi, whi) for ks in range(4)]
                    for p, (ks, a_regs, bsm) in enumerate(order):
                        A = np.zeros((64, 8))
                        A[a_rows, a_cols] = a_regs[ks]
                        C = A @ bsm[b_src[ks]].astype(np.float64)          # (64, 128), exact
                        first = p == 0 and (promote or kb == 0)
                        prev = 0.0 if first else acc[cwg].astype(np.float64)
                        acc[cwg] = _rz_f32(prev + C[acc_rows, acc_cols])
                if promote:
                    sums += acc
            total = sums if promote else acc
            for cwg in range(2):
                y[m0 + 64 * cwg + acc_rows, n0 + acc_cols] = total[cwg] + b[n0 + acc_cols]
    return y
