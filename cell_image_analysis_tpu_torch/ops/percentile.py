"""Percentile normalization (csbdeep.utils.normalize semantics).

Counterpart of `cell_image_analysis_tpu/ops/percentile.py`:
`normalize_percentile` takes exact order statistics (`kth_smallest`) at
the ranks numpy's linear-interpolation percentile uses, computed in python
float64 (`percentile_ranks`), and lerps them in float32.  JAX selects them
with a sort-free bisection; the port with a radix select over the float's
order-preserving uint32 key, three digits from the top (11, 11 and 10
bits): on the card the kernel `csrc/kthvalue_radix.cu`, on the CPU its
plain version `kth_smallest_plain`, the same digit passes with
`torch.bincount`.  The values are the same.

`percentile` (any q, any axis), `masked_percentile` (over the masked
elements) and `median_iqr` (the RobustScaler's fit) sort, as JAX's do, and do JAX's rank arithmetic in float32: the index
`q / 100 * (n - 1)`, its floor and ceiling, and the lerp.  XLA compiles
JAX's lerp `lo * (1 - f) + hi * f` into a fused multiply-add of the low
term, so the port adds the exact float64 product `lo * (1 - f)` to the
float32 `hi * f` and rounds once; the scaler's fit then equals JAX's bit
for bit (the float64 sum could round twice only where it needs more than
53 bits, which the tests have not met).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cell_image_analysis_tpu_torch.utils.profiler import count

# (shift, bits) of the key's digits, top first: the kernel's three passes
RADIX_DIGITS = ((21, 11), (10, 11), (0, 10))
NAN_KEY = 0xFFC00000  # every NaN's key: above +inf's (0xFF800000), as torch orders NaN


def percentile_ranks(n: int, qs: tuple) -> list:
    """(k_lo, k_hi, frac) triples of numpy's linear-interpolation percentile
    for a length-n array, one per q (float64 index arithmetic)."""
    out = []
    for q in qs:
        idx = q / 100.0 * (n - 1)
        k_lo = int(np.floor(idx))
        k_hi = int(np.ceil(idx))
        out.append((k_lo, k_hi, np.float32(idx - k_lo)))
    return out


def radix_keys(flat: torch.Tensor) -> torch.Tensor:
    """The order-preserving uint32 key of each float32 element, as int64:
    a negative float's bits flipped, a positive float's sign bit set, every
    NaN `NAN_KEY`."""
    u = flat.view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(flat), NAN_KEY, key)


def key_values(key: torch.Tensor) -> torch.Tensor:
    """The float32 of each int64 key (`radix_keys`' inverse; NaN's key
    reads as 0x7FC00000)."""
    u = torch.where(key >= 2 ** 31, key & 0x7FFFFFFF, key ^ 0xFFFFFFFF)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def kth_smallest_plain(flat: torch.Tensor, ks: tuple) -> torch.Tensor:
    """The plain version of the kernel (same contract as `kth_smallest` on
    (B, N) float32): for each digit, top first, the histogram of the digit
    over the elements whose higher digits match the prefix found so far for
    a rank (ranks with one prefix share a histogram); the bin where the
    running count passes the rank extends its prefix, and the rank within
    the bin carries to the next digit."""
    B = flat.shape[0]
    distinct = list(dict.fromkeys(ks))
    R = len(distinct)
    keys = radix_keys(flat)
    frame = torch.arange(B, device=flat.device)[:, None]
    prefix = torch.zeros((B, R), dtype=torch.int64, device=flat.device)
    rank = torch.tensor(distinct, dtype=torch.int64, device=flat.device).expand(B, R)
    row = torch.zeros_like(keys)   # the first digit: every element, one row a frame
    for shift, bits in RADIX_DIGITS:
        # each rank's row: the first rank with its prefix
        owner = (prefix[:, :, None] == prefix[:, None, :]).int().argmax(dim=2)
        if shift + bits < 32:
            hi = keys >> (shift + bits)
            row = torch.full_like(keys, -1)
            for r in range(R):
                row = torch.where((hi == prefix[frame, r]) & (owner[frame, r] == r), r, row)
            # the elements that no rank's prefix matches leave for good (the
            # kernel reads them again and skips them)
            sel = row >= 0
            keys, frame, row = keys[sel], frame.expand_as(sel)[sel], row[sel]
        digit = (keys >> shift) & ((1 << bits) - 1)
        hist = torch.bincount((((frame * R + row) << bits) | digit).reshape(-1),
                              minlength=(B * R) << bits).reshape(B, R, 1 << bits)
        h = hist.gather(1, owner[:, :, None].expand(B, R, 1 << bits))
        cum = h.cumsum(2)
        d = torch.searchsorted(cum, rank[:, :, None].contiguous(), right=True)
        rank = rank - (cum.gather(2, d) - h.gather(2, d))[:, :, 0]
        prefix = (prefix << bits) | d[:, :, 0]
    return key_values(prefix)[:, [distinct.index(k) for k in ks]]


def kth_smallest(x: torch.Tensor, ks: tuple) -> torch.Tensor:
    """The k-th smallest elements (0-based ranks `ks`) of each leading-dim
    slice of x (B, ...) -> (B, len(ks)) float32, bit for bit the elements
    `torch.kthvalue` selects (but for the sign of a zero tied with its
    opposite: -0.0 orders below +0.0); a rank repeated is selected once.
    The kernel on a CUDA tensor (no host synchronisation), the plain
    version on a CPU tensor.  Counts the frames (`percentile.frames`)."""
    flat = x.reshape(x.shape[0], -1).float()
    n = flat.shape[1]
    if not all(0 <= k < n for k in ks):
        raise ValueError(f"kth_smallest: ranks {ks} outside [0, {n})")
    count("percentile.frames", flat.shape[0])
    if flat.device.type == "cpu":
        return kth_smallest_plain(flat, ks)
    from cell_image_analysis_tpu_torch.ops.cuda.kthvalue import kth_smallest_cuda

    return kth_smallest_cuda(flat, ks)


def percentile_select(x: torch.Tensor, qs: tuple) -> torch.Tensor:
    """numpy `percentile(x_b, qs)` of each leading-dim slice of x (B, ...)
    -> (B, len(qs)) float32, from exact order statistics."""
    rk = percentile_ranks(x[0].numel(), qs)
    v = kth_smallest(x, tuple(k for r in rk for k in r[:2]))
    out = []
    for i, (_, _, frac) in enumerate(rk):
        f = torch.full((), float(frac), dtype=torch.float32, device=x.device)  # no host copy
        out.append(v[:, 2 * i] * (1.0 - f) + v[:, 2 * i + 1] * f)
    return torch.stack(out, dim=1)


def normalize_percentile(x: torch.Tensor, pmin: float = 3.0, pmax: float = 99.8,
                         eps: float = 1e-20) -> torch.Tensor:
    """(x - p_min) / (p_max - p_min + eps) per frame of x (B, H, W) or (H, W),
    float32, no clipping."""
    single = x.dim() == 2
    xb = (x[None] if single else x).float()
    lohi = percentile_select(xb, (float(pmin), float(pmax)))
    lo = lohi[:, 0].reshape(-1, 1, 1)
    hi = lohi[:, 1].reshape(-1, 1, 1)
    out = (xb - lo) / (hi - lo + torch.full((), eps, dtype=torch.float32, device=x.device))
    return out[0] if single else out


def percentile(x: torch.Tensor, q, axis: int | None = None) -> torch.Tensor:
    """numpy-compatible percentile (linear interpolation) of `x` along
    `axis` (flattened when None), for a scalar or 1-D `q` in [0, 100]; a
    1-D q gives a leading axis of len(q).  The rank arithmetic is float32,
    as JAX's `ops.percentile.percentile`."""
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    if axis is None:
        xs = torch.sort(x.reshape(-1)).values
    else:
        xs = torch.movedim(torch.sort(x, dim=axis).values, axis, 0)
    n = xs.shape[0]
    idx = q / 100.0 * (n - 1)
    lo, hi = torch.floor(idx).long(), torch.ceil(idx).long()
    frac = idx - lo.float()
    if frac.dim():  # broadcast (Q,) weights over the remaining axes
        frac = frac.reshape(frac.shape + (1,) * (xs.dim() - 1))
    return (xs[lo].double() * (1.0 - frac).double() + (xs[hi] * frac).double()).float()


def masked_percentile(x: torch.Tensor, mask: torch.Tensor, q) -> torch.Tensor:
    """Percentile (scalar or 1-D q) over the elements of flattened `x`
    where `mask` is true: the others sort to the top as +inf, and the
    length is the mask's count, as JAX's `masked_percentile` (float32 rank
    arithmetic, the lerp as `percentile`'s)."""
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    mf = mask.reshape(-1).bool()
    xs = torch.sort(torch.where(mf, x.reshape(-1).float(), math.inf)).values
    idx = q / 100.0 * torch.clamp(mf.sum().float() - 1.0, min=0.0)
    lo, hi = torch.floor(idx).long(), torch.ceil(idx).long()
    frac = idx - lo.float()
    return (xs[lo].double() * (1.0 - frac).double() + (xs[hi] * frac).double()).float()


def median_iqr(x: torch.Tensor) -> tuple:
    """Per-feature median and interquartile range of an (N, D) matrix; the
    caller maps a zero range to 1 (sklearn's RobustScaler)."""
    qs = percentile(x, [25.0, 50.0, 75.0], axis=0)
    return qs[1], qs[2] - qs[0]
