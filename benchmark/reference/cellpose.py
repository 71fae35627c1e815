"""The plain reference of Cellpose 3's segmentation (`cyto3`'s CPnet and
`dynamics.compute_masks`), one frame at a time, in plain PyTorch, NumPy and
SciPy.  Nothing of the program is imported.

Written from MouseLand/cellpose 3 (`resnet_torch.CPnet`, `core.run_net` /
`_run_tiled`, `transforms.normalize99` / `pad_image_ND` / `make_tiles` /
`_taper_mask` / `average_tiles`, `dynamics.follow_flows` /
`steps2D_interp` (GPU branch) / `get_masks` / `masks_to_flows_gpu` /
`remove_bad_flow_masks`, `metrics.flow_error`,
`utils.fill_holes_and_remove_small_masks`), and from its equations:

- the network: every conv pre-activation, BatchNorm (eval, eps 1e-5), ReLU,
  conv (`F.conv2d`, float32; both TF32 flags off unless the control asks);
  the 1x1 projections without ReLU; four residual encoder blocks with a
  2x2 max pool before blocks 1-3; the style, the mean of the last block's
  map over its L2 norm; four residual decoder blocks with a nearest 2x
  upsample before blocks 2-0, the style through a linear map into three of
  the four convs and the skip added before the first of them; a 1x1 conv
  to (dy, dx, cellprob);
- the tiles: normalize99 (the 1st and 99th percentile), channel 1 zeros,
  zero padding to a multiple of 16 plus 8 px a side, 224^2 tiles at 10%
  overlap, the taper-mask blend in float64 into float32, the crop back;
- the dynamics: the flow following in `grid_sample` steps on the device, the
  masks from a histogram of final positions with a Python loop over seeds,
  the flow-error QC (the heat diffusion on the device in float64, as
  `masks_to_flows_gpu`), and the hole filling with a loop over masks.

Departures from Cellpose 3, each also the program's:
- the percentiles are numpy 2's float32 linear interpolation, computed
  explicitly (float32 virtual index and fraction, `_lerp`'s two branches),
  so that the result does not depend on the numpy version;
- the field's division by 5 is numpy's; the positions' division by L - 1
  is PyTorch's on the device where the reference runs;
- no augmentation, no rescale (diameter = diam_mean), channels [0, 0];
- the QC uses the GPU form of `masks_to_flows` (one `n_iter` a frame) and
  runs in the reference's device; the CPU form iterates each mask on its
  own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

# float32 with TF32 off; the control (`control.py`) turns TF32 on around a
# screening (`models.tf32`), which this module leaves as it finds it
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def load(path: str, device) -> dict:
    """{Cellpose state-dict name: float32 tensor on `device`} of an .npz."""
    with np.load(path, allow_pickle=False) as z:
        return {k: torch.as_tensor(z[k].astype(np.float32), device=device)
                for k in z.files if k != "meta"}


# ---- the network ----------------------------------------------------------


def _bn(s: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"],
                        s[f"{name}.weight"], s[f"{name}.bias"], training=False, eps=1e-5)


def batchconv(s: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """BN, ReLU, conv (SAME)."""
    w = s[f"{name}.2.weight"]
    return F.conv2d(F.relu(_bn(s, f"{name}.0", x)), w, s[f"{name}.2.bias"],
                    padding=w.shape[-1] // 2)


def batchconv0(s: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """BN, conv (SAME)."""
    w = s[f"{name}.1.weight"]
    return F.conv2d(_bn(s, f"{name}.0", x), w, s[f"{name}.1.bias"], padding=w.shape[-1] // 2)


def batchconvstyle(s: dict, name: str, style: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor | None = None) -> torch.Tensor:
    if y is not None:
        x = x + y
    feat = F.linear(style, s[f"{name}.full.weight"], s[f"{name}.full.bias"])
    return batchconv(s, f"{name}.conv", x + feat[:, :, None, None])


def n_blocks(s: dict) -> int:
    n = 0
    while f"downsample.down.res_down_{n}.proj.1.weight" in s:
        n += 1
    return n


def cpnet(s: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 3, H, W): dy, dx, cellprob."""
    xd = []
    for n in range(n_blocks(s)):
        y = x if n == 0 else F.max_pool2d(xd[n - 1], 2, stride=2)
        name = f"downsample.down.res_down_{n}"
        y = batchconv0(s, f"{name}.proj", y) + batchconv(
            s, f"{name}.conv.conv_1", batchconv(s, f"{name}.conv.conv_0", y))
        xd.append(y + batchconv(s, f"{name}.conv.conv_3", batchconv(s, f"{name}.conv.conv_2", y)))
    style = F.avg_pool2d(xd[-1], kernel_size=xd[-1].shape[2:]).flatten(1)
    style = style / torch.sum(style ** 2, dim=1, keepdim=True) ** 0.5
    x = xd[-1]
    for n in range(len(xd) - 1, -1, -1):
        if n < len(xd) - 1:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        name = f"upsample.up.res_up_{n}"
        skip = xd[n]
        x = batchconv0(s, f"{name}.proj", x) + batchconvstyle(
            s, f"{name}.conv.conv_1", style, batchconv(s, f"{name}.conv.conv_0", x), y=skip)
        x = x + batchconvstyle(s, f"{name}.conv.conv_3", style,
                               batchconvstyle(s, f"{name}.conv.conv_2", style, x))
    return batchconv(s, "output", x)


# ---- tiled inference ------------------------------------------------------


def percentile(x: np.ndarray, q: float) -> np.float32:
    """numpy 2's linear percentile of float32 data, written out."""
    n = x.size
    idx = np.float32(n - 1) * (np.float32(q) / np.float32(100))
    lo = int(np.floor(idx))
    hi = min(lo + 1, n - 1)
    g = np.float32(idx - np.float32(lo))
    part = np.partition(x.reshape(-1), (lo, hi))
    a, b = part[lo], part[hi]
    d = np.float32(b - a)
    return np.float32(b - d * (np.float32(1) - g)) if g >= 0.5 else np.float32(a + d * g)


def normalize99(x: np.ndarray, lower: float = 1.0, upper: float = 99.0) -> np.ndarray:
    x = x.astype(np.float32)
    x01, x99 = percentile(x, lower), percentile(x, upper)
    if x99 - x01 > 1e-3:
        return ((x - x01) / (x99 - x01)).astype(np.float32)
    return np.zeros_like(x)


def pad_image_nd(img: np.ndarray, div: int = 16, extra: int = 1) -> tuple:
    """(padded (C, Ly, Lx), row slice, col slice of the frame)."""
    lpad = int(div * np.ceil(img.shape[-2] / div) - img.shape[-2])
    y1, y2 = extra * div // 2 + lpad // 2, extra * div // 2 + lpad - lpad // 2
    lpad = int(div * np.ceil(img.shape[-1] / div) - img.shape[-1])
    x1, x2 = extra * div // 2 + lpad // 2, extra * div // 2 + lpad - lpad // 2
    out = np.pad(img, ((0, 0), (y1, y2), (x1, x2)), mode="constant")
    return out, slice(y1, y1 + img.shape[-2]), slice(x1, x1 + img.shape[-1])


def make_tiles(imgi: np.ndarray, bsize: int = 224, tile_overlap: float = 0.1) -> tuple:
    nchan, ly, lx = imgi.shape
    tile_overlap = min(0.5, max(0.05, tile_overlap))
    by, bx = min(bsize, ly), min(bsize, lx)
    ny = 1 if ly <= bsize else int(np.ceil((1. + 2 * tile_overlap) * ly / bsize))
    nx = 1 if lx <= bsize else int(np.ceil((1. + 2 * tile_overlap) * lx / bsize))
    ystart = np.linspace(0, ly - by, ny).astype(int)
    xstart = np.linspace(0, lx - bx, nx).astype(int)
    ysub, xsub, tiles = [], [], []
    for j in range(len(ystart)):
        for i in range(len(xstart)):
            ysub.append([ystart[j], ystart[j] + by])
            xsub.append([xstart[i], xstart[i] + bx])
            tiles.append(imgi[:, ysub[-1][0]:ysub[-1][1], xsub[-1][0]:xsub[-1][1]])
    return np.stack(tiles).astype(np.float32), ysub, xsub


def taper_mask(ly: int = 224, lx: int = 224, sig: float = 7.5) -> np.ndarray:
    bsize = max(224, max(ly, lx))
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / sig))
    mask = mask * mask[:, np.newaxis]
    return mask[bsize // 2 - ly // 2:bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2:bsize // 2 + lx // 2 + lx % 2]


def average_tiles(y: np.ndarray, ysub: list, xsub: list, ly: int, lx: int) -> np.ndarray:
    navg = np.zeros((ly, lx))
    yf = np.zeros((y.shape[1], ly, lx), np.float32)
    mask = taper_mask(y.shape[-2], y.shape[-1])
    for j in range(len(ysub)):
        yf[:, ysub[j][0]:ysub[j][1], xsub[j][0]:xsub[j][1]] += y[j] * mask
        navg[ysub[j][0]:ysub[j][1], xsub[j][0]:xsub[j][1]] += mask
    yf /= navg
    return yf


def run_net(s: dict, frame: np.ndarray, cfg: dict, device) -> np.ndarray:
    """(3, H, W) float32 network output of one raw (H, W) frame."""
    img = np.stack([normalize99(frame, cfg["norm_pmin"], cfg["norm_pmax"]),
                    np.zeros(frame.shape, np.float32)])
    img, sy, sx = pad_image_nd(img)
    tiles, ysub, xsub = make_tiles(img, cfg["tile"], cfg["tile_overlap"])
    y = np.zeros((len(tiles), 3) + tiles.shape[-2:])
    step = 36
    with torch.no_grad():
        for k in range(0, len(tiles), step):
            out = cpnet(s, torch.as_tensor(tiles[k:k + step], device=device))
            y[k:k + step] = out.cpu().numpy()
    yf = average_tiles(y, ysub, xsub, img.shape[-2], img.shape[-1])
    return yf[:, sy, sx]


# ---- the dynamics ---------------------------------------------------------


def steps2d_interp(p: np.ndarray, dP: np.ndarray, niter: int, device) -> np.ndarray:
    """Cellpose's GPU branch: p (2, n) (y, x), dP (2, Ly, Lx) the field."""
    shape = np.array(dP.shape[1:])[[1, 0]].astype("float") - 1
    pt = torch.from_numpy(p[[1, 0]].T).float().to(device).unsqueeze(0).unsqueeze(0)
    im = torch.from_numpy(dP[[1, 0]]).float().to(device).unsqueeze(0)
    for k in range(2):
        im[:, k, :, :] *= 2. / shape[k]
        pt[:, :, :, k] /= shape[k]
    pt = pt * 2 - 1
    for _ in range(niter):
        dPt = F.grid_sample(im, pt, align_corners=False)
        for k in range(2):
            pt[:, :, :, k] = torch.clamp(pt[:, :, :, k] + dPt[:, k, :, :], -1., 1.)
    pt = (pt + 1) * 0.5
    for k in range(2):
        pt[:, :, :, k] *= shape[k]
    return pt[:, :, :, [1, 0]].cpu().numpy().squeeze(axis=(0, 1)).T


def follow_flows(dP: np.ndarray, niter: int, device) -> tuple:
    """(final positions (2, Ly, Lx) float32, moving pixels or None)."""
    shape = dP.shape[1:]
    p = np.array(np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij"),
                 np.float32)
    inds = np.array(np.nonzero(np.abs(dP[0]) > 1e-3)).astype(np.int32).T
    if inds.ndim < 2 or inds.shape[0] < 5:
        return p, None
    p[:, inds[:, 0], inds[:, 1]] = steps2d_interp(p[:, inds[:, 0], inds[:, 1]], dP, niter,
                                                  device)
    return p, inds


def get_masks(p: np.ndarray, iscell: np.ndarray, rpad: int = 20,
              max_size_fraction: float = 0.4) -> tuple:
    """(masks (Ly, Lx) int64, seeds): Cellpose 3's get_masks, its loops
    over seeds included."""
    p = p.copy()
    shape0 = p.shape[1:]
    inds = np.meshgrid(np.arange(shape0[0]), np.arange(shape0[1]), indexing="ij")
    for i in range(2):
        p[i, ~iscell] = inds[i][~iscell]
    pflows, edges = [], []
    for i in range(2):
        pflows.append(p[i].flatten().astype("int32"))
        edges.append(np.arange(-.5 - rpad, shape0[i] + .5 + rpad, 1))
    h, _ = np.histogramdd(tuple(pflows), bins=edges)
    hmax = h.copy()
    for i in range(2):
        hmax = ndi.maximum_filter1d(hmax, 5, axis=i)
    seeds = np.nonzero(np.logical_and(h - hmax > -1e-6, h > 10))
    pix = list(np.array(seeds).T)
    shape = h.shape
    expand = np.nonzero(np.ones((3, 3)))
    for it in range(5):
        for k in range(len(pix)):
            if it == 0:
                pix[k] = list(pix[k])
            newpix = []
            for i, e in enumerate(expand):
                epix = e[:, np.newaxis] + np.expand_dims(pix[k][i], 0) - 1
                newpix.append(epix.flatten())
            newpix = tuple(newpix)
            igood = h[newpix] > 2
            for i in range(2):
                pix[k][i] = newpix[i][igood]
            if it == 4:
                pix[k] = tuple(pix[k])
    m = np.zeros(shape, np.uint32)
    for k in range(len(pix)):
        m[pix[k]] = 1 + k
    for i in range(2):
        pflows[i] = pflows[i] + rpad
    m0 = m[tuple(pflows)]
    uniq, counts = np.unique(m0, return_counts=True)
    big = np.prod(shape0) * max_size_fraction
    bigc = uniq[counts > big]
    if len(bigc) > 0 and (len(bigc) > 1 or bigc[0] != 0):
        m0[np.isin(m0, bigc)] = 0
    return renumber(m0).reshape(shape0), len(pix)


def renumber(m: np.ndarray) -> np.ndarray:
    """1.. by first appearance in raster order, 0 kept (fastremap.renumber)."""
    flat = m.reshape(-1).astype(np.int64)
    vals, first = np.unique(flat, return_index=True)
    keep = vals != 0
    vals, first = vals[keep], first[keep]
    new = np.zeros(flat.max() + 1 if flat.size else 1, np.int64)
    new[vals[np.argsort(first)]] = np.arange(1, len(vals) + 1)
    return new[flat]


def masks_to_flows_gpu(masks: np.ndarray, device) -> tuple:
    """((2, Ly, Lx) float64 flows, n_iter) as Cellpose 3's masks_to_flows_gpu."""
    ly0, lx0 = masks.shape
    ly, lx = ly0 + 2, lx0 + 2
    padded = np.zeros((ly, lx), np.int64)
    padded[1:-1, 1:-1] = masks
    y, x = np.nonzero(padded)
    ny = np.stack((y, y - 1, y + 1, y, y, y - 1, y - 1, y + 1, y + 1), axis=0)
    nx = np.stack((x, x, x, x - 1, x + 1, x - 1, x + 1, x - 1, x + 1), axis=0)
    neighbors = np.stack((ny, nx), axis=-1)
    slices = ndi.find_objects(masks)
    centers = np.zeros((masks.max(), 2), "int")
    for i, si in enumerate(slices):
        if si is not None:
            sr, sc = si
            yi, xi = np.nonzero(masks[sr, sc] == (i + 1))
            yi = yi.astype(np.int32) + 1
            xi = xi.astype(np.int32) + 1
            ymed, xmed = np.median(yi), np.median(xi)
            imin = np.argmin((xi - xmed) ** 2 + (yi - ymed) ** 2)
            centers[i, 0] = yi[imin] + sr.start
            centers[i, 1] = xi[imin] + sc.start
    neighbor_masks = padded[neighbors[:, :, 0], neighbors[:, :, 1]]
    isneighbor = neighbor_masks == neighbor_masks[0]
    ext = np.array([[sr.stop - sr.start + 1, sc.stop - sc.start + 1] for sr, sc in slices])
    n_iter = 2 * (ext.sum(axis=1)).max()
    pt = torch.from_numpy(neighbors).to(device)
    T = torch.zeros((ly, lx), dtype=torch.double, device=device)
    meds = torch.from_numpy(centers).to(device).long()
    isneigh = torch.from_numpy(isneighbor).to(device)
    for _ in range(n_iter):
        T[meds[:, 0], meds[:, 1]] += 1
        tneigh = T[pt[:, :, 0], pt[:, :, 1]]
        tneigh *= isneigh
        T[pt[0, :, 0], pt[0, :, 1]] = tneigh.mean(axis=0)
    T = torch.log(1. + T)
    grads = T[pt[[2, 1, 4, 3], :, 0], pt[[2, 1, 4, 3], :, 1]]
    dy = grads[0] - grads[1]
    dx = grads[2] - grads[3]
    mu = np.stack((dy.cpu().numpy(), dx.cpu().numpy()), axis=-2)
    mu /= (1e-60 + (mu ** 2).sum(axis=0) ** 0.5)
    mu0 = np.zeros((2, ly0, lx0))
    mu0[:, y - 1, x - 1] = mu
    return mu0, int(n_iter)


def flow_error(masks: np.ndarray, dP: np.ndarray, device) -> np.ndarray:
    """Each mask's mean over its pixels of sum_k (flow_k - dP_k / 5)^2."""
    mu, _ = masks_to_flows_gpu(masks, device)
    errors = np.zeros(masks.max())
    for i in range(mu.shape[0]):
        errors += ndi.mean((mu[i] - dP[i] / 5.) ** 2, masks, index=np.arange(1, masks.max() + 1))
    return errors


def remove_bad_flow_masks(masks: np.ndarray, dP: np.ndarray, threshold: float,
                          device) -> np.ndarray:
    errors = flow_error(masks, dP, device)
    badi = 1 + (errors > threshold).nonzero()[0]
    masks = masks.copy()
    masks[np.isin(masks, badi)] = 0
    return masks


def fill_holes_and_remove_small_masks(masks: np.ndarray, min_size: int = 15) -> np.ndarray:
    masks = masks.copy()
    slices = ndi.find_objects(masks)
    j = 0
    for i, slc in enumerate(slices):
        if slc is not None:
            msk = masks[slc] == (i + 1)
            npix = msk.sum()
            if min_size > 0 and npix < min_size:
                masks[slc][msk] = 0
            elif npix > 0:
                msk = ndi.binary_fill_holes(msk)
                masks[slc][msk] = (j + 1)
                j += 1
    return masks


def compute_masks(dP: np.ndarray, cellprob: np.ndarray, cfg: dict, device) -> np.ndarray:
    """The label map of one frame's flows and cell probability."""
    thr = cfg["cellprob_threshold"]
    iscell = cellprob > thr
    if not iscell.sum():
        return np.zeros(cellprob.shape, np.int32)
    p, inds = follow_flows(dP * iscell / 5., cfg["niter"], device)
    if inds is None:
        return np.zeros(cellprob.shape, np.int32)
    masks, _ = get_masks(p, iscell, max_size_fraction=cfg["max_size_fraction"])
    if masks.max() > 0 and cfg["flow_threshold"] > 0:
        masks = remove_bad_flow_masks(masks, dP, cfg["flow_threshold"], device)
    return fill_holes_and_remove_small_masks(masks, cfg["min_size"]).astype(np.int32)


def labels(state: dict, frame: np.ndarray, cfg: dict, device) -> np.ndarray:
    """One raw (H, W) frame's int32 label map."""
    y = run_net(state, frame, cfg, device)
    return compute_masks(y[:2], y[2], cfg, device)
