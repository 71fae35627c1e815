"""Star-polygon non-maximum suppression (exact greedy fixpoint).

Counterpart of `cell_image_analysis_tpu/ops/nms.py`: the polygons'
vertices and areas, the dense K x K overlap (`overlap_matrix`, for
callers and tests), the sparse candidate-pair overlap (`overlap_matrix_sparse`: pairs whose center
distance is below the sum of their max radii, the `max_pairs` closest
kept, each integrated on a 24 x 8 polar quadrature over the smaller
polygon) and `star_nms`, the fixpoint whose result is exactly the greedy
outcome.  Everything is batched over a leading frame axis; the fixpoint
loop syncs with the host once per round.

Float expressions follow the JAX code term by term (same operation order,
same float32 constants) so that CPU results agree to the last ulp where
the libraries do.
"""

from __future__ import annotations

import math

import torch

from cell_image_analysis_tpu_torch.ops import gather_rows
from cell_image_analysis_tpu_torch.utils.profiler import count, span

_N_ANGLES = 24
_N_RADII = 8
_TWO_PI = 2.0 * math.pi


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on `like`'s device, made by a fill: a
    `torch.tensor(v, device=...)` would copy from the host and hold it up."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _remainder(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """jnp.remainder for a positive modulus: fmod, then + m where negative."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def polygon_vertices(centers: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """Centers (..., K, 2) and radii (..., K, R) -> vertices (..., K, R, 2)
    (row, column), ray k at angle 2 pi k / R."""
    R = dists.shape[-1]
    phi = torch.arange(R, dtype=torch.float32, device=dists.device) * _f32(_TWO_PI / R, dists)
    dy = dists * torch.sin(phi)
    dx = dists * torch.cos(phi)
    return torch.stack([centers[..., 0:1] + dy, centers[..., 1:2] + dx], dim=-1)


def polygon_areas(dists: torch.Tensor) -> torch.Tensor:
    """Exact star-polygon areas: sum_k 0.5 r_k r_{k+1} sin(2 pi / R)."""
    R = dists.shape[-1]
    s = torch.sin(_f32(_TWO_PI / R, dists))
    nxt = torch.roll(dists, -1, dims=-1)
    return 0.5 * s * torch.sum(dists * nxt, dim=-1)


def radius_at(dists: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Boundary radius at angle theta, linearly interpolated between the two
    neighbouring rays.  dists (..., R) broadcasts against theta (...).

    The JAX code sums all R rays against circular tent weights; only the
    two rays around theta have non-zero weight, so this gathers those two
    and weights them with the same tent expressions."""
    R = dists.shape[-1]
    two_pi = _f32(_TWO_PI, theta)
    t = _remainder(theta, two_pi) / two_pi * R
    k0 = torch.floor(t)
    k1 = k0 + 1.0

    def tent(k):
        d = torch.abs(t - k)
        return torch.clamp(1.0 - torch.minimum(d, R - d), min=0.0)

    shape = torch.broadcast_shapes(theta.shape, dists.shape[:-1])
    d = dists.expand(*shape, R)
    i0 = torch.remainder(k0.long(), R).expand(shape).unsqueeze(-1)
    i1 = torch.remainder(k1.long(), R).expand(shape).unsqueeze(-1)
    r0 = torch.gather(d, -1, i0)[..., 0]
    r1 = torch.gather(d, -1, i1)[..., 0]
    return r0 * tent(k0) + r1 * tent(k1)


def _quadrature(dists_i: torch.Tensor, centers_i: torch.Tensor):
    """Polar quadrature points (..., A*F, 2) and area weights (..., A*F)
    inside polygons i."""
    A, F = _N_ANGLES, _N_RADII
    ang = (torch.arange(A, dtype=torch.float32, device=dists_i.device) + 0.5) / A
    ang = ang * 2.0 * _f32(math.pi, ang)
    f = torch.sqrt((torch.arange(F, dtype=torch.float32, device=dists_i.device) + 0.5) / F)
    rb = radius_at(dists_i.unsqueeze(-2), ang)                  # (..., A)
    rr = rb[..., :, None] * f                                   # (..., A, F)
    yy = centers_i[..., 0, None, None] + rr * torch.sin(ang)[:, None]
    xx = centers_i[..., 1, None, None] + rr * torch.cos(ang)[:, None]
    pts = torch.stack([yy, xx], dim=-1).reshape(*rb.shape[:-1], A * F, 2)
    w = 0.5 * rb * rb * _f32(_TWO_PI / A, rb) / F
    w = w[..., :, None].expand(*rb.shape, F).reshape(*rb.shape[:-1], A * F)
    return pts, w


def overlap_matrix(centers: torch.Tensor, dists: torch.Tensor, metric: str = "iou",
                   chunk: int = 32) -> torch.Tensor:
    """The dense (K, K) pairwise overlap of polygons (K, 2), (K, R), or
    (B, K, K) of (B, K, 2), (B, K, R): O[i, j] integrates polygon i's
    quadrature against polygon j (so it is near-symmetric), diagonal zero;
    `chunk` rows of i at a time.  For callers and tests: screening runs
    `overlap_matrix_sparse`, whose entry for a pair is this one's with i
    the smaller polygon, bit for bit."""
    single = centers.dim() == 2
    c, d = (centers[None], dists[None]) if single else (centers, dists)
    B, K = c.shape[:2]
    areas = polygon_areas(d)                                    # (B, K)
    inter = torch.empty((B, K, K), dtype=torch.float32, device=c.device)
    for i0 in range(0, K, chunk):
        pts, w = _quadrature(d[:, i0:i0 + chunk], c[:, i0:i0 + chunk])   # (B, C, S, 2)
        dy = pts[:, :, None, :, 0] - c[:, None, :, 0, None]    # (B, C, K, S)
        dx = pts[:, :, None, :, 1] - c[:, None, :, 1, None]
        rho = torch.sqrt(dy * dy + dx * dx)
        rb = radius_at(d[:, None, :, None, :], torch.atan2(dy, dx))
        inter[:, i0:i0 + chunk] = torch.sum(w[:, :, None, :] * (rho <= rb), dim=-1)
    a_i, a_j = areas[:, :, None], areas[:, None, :]
    inter = torch.minimum(inter, torch.minimum(a_i, a_j))
    denom = torch.minimum(a_i, a_j) if metric == "ios" else a_i + a_j - inter
    O = inter / torch.clamp(denom, min=1e-12)
    O = O * (1.0 - torch.eye(K, dtype=O.dtype, device=O.device))
    return O[0] if single else O


def overlap_matrix_sparse(centers: torch.Tensor, dists: torch.Tensor, valid: torch.Tensor,
                          metric: str = "iou", max_pairs: int | None = 8192):
    """(B, K, K) pairwise overlap over the `max_pairs` closest candidate
    pairs, and a (B,) flag that more candidate pairs existed than that.

    `max_pairs=None` is the exact pair set: every candidate pair, and the
    flag is never set.  Only candidate pairs carry an overlap, so this
    stops at the largest count of candidate pairs in a frame instead of
    integrating all K^2 pairs (K = 1024, B = 16: 25 GB for the quadrature
    points alone).  It reads that count back, so this branch waits on the
    host once, and its shapes follow the data."""
    B, K = valid.shape
    areas = polygon_areas(dists)                                # (B, K)
    rmax = torch.amax(dists, dim=-1)
    dy = centers[..., 0][:, :, None] - centers[..., 0][:, None, :]
    dx = centers[..., 1][:, :, None] - centers[..., 1][:, None, :]
    d2 = dy * dy + dx * dx
    rsum = rmax[:, :, None] + rmax[:, None, :]
    idx = torch.arange(K, device=valid.device)
    cand = ((d2 < rsum * rsum) & valid[:, :, None] & valid[:, None, :]
            & (idx[:, None] < idx[None, :]))

    masked = torch.where(cand, d2, torch.full_like(d2, math.inf)).reshape(B, K * K)
    n_cand = cand.reshape(B, -1).sum(dim=1)
    if max_pairs is None:
        count("host_waits.pair_count")
        max_pairs = max(1, int(n_cand.max()))
    max_pairs = min(max_pairs, K * K)
    # lax.top_k(-masked): smallest first, lower index first on ties
    order = torch.sort(masked, dim=1, stable=True)
    pair_d, flat_idx = order.values[:, :max_pairs], order.indices[:, :max_pairs]
    pair_ok = torch.isfinite(pair_d)
    ii = flat_idx // K
    jj = flat_idx % K

    a_ii = torch.gather(areas, 1, ii)
    a_jj = torch.gather(areas, 1, jj)
    swap = a_jj < a_ii
    pi = torch.where(swap, jj, ii)
    pj = torch.where(swap, ii, jj)

    pts, w = _quadrature(gather_rows(dists, pi), gather_rows(centers, pi))  # (B, M, S, 2)
    c_j = gather_rows(centers, pj)
    dyp = pts[..., 0] - c_j[..., 0, None]
    dxp = pts[..., 1] - c_j[..., 1, None]
    rho = torch.sqrt(dyp * dyp + dxp * dxp)
    theta = torch.atan2(dyp, dxp)
    rb = radius_at(gather_rows(dists, pj).unsqueeze(-2), theta)   # (B, M, S)
    inter = torch.sum(w * (rho <= rb), dim=-1)
    a_pi = torch.gather(areas, 1, pi)
    a_pj = torch.gather(areas, 1, pj)
    inter = torch.minimum(inter, torch.minimum(a_pi, a_pj))
    if metric == "ios":
        denom = torch.minimum(a_pi, a_pj)
    else:
        denom = a_pi + a_pj - inter
    o = torch.where(pair_ok, inter / torch.clamp(denom, min=1e-12), torch.zeros_like(inter))

    ii_s = torch.where(pair_ok, ii, K)
    jj_s = torch.where(pair_ok, jj, K)
    bi = torch.arange(B, device=valid.device)[:, None].expand_as(ii_s)
    O = torch.zeros((B, K + 1, K + 1), dtype=torch.float32, device=valid.device)
    O[bi, ii_s, jj_s] = o
    O[bi, jj_s, ii_s] = o
    overflow = n_cand > max_pairs
    return O[:, :K, :K], overflow


def star_nms(centers: torch.Tensor, dists: torch.Tensor, probs: torch.Tensor,
             valid: torch.Tensor, nms_thresh: float = 0.3, metric: str = "iou",
             max_pairs: int | None = 8192):
    """Greedy star-polygon NMS on (B, K) candidates.  Returns the keep mask
    (B, K) and the (B,) pair-budget overflow flag.  `max_pairs=None`: every
    candidate pair (see `overlap_matrix_sparse`).  The span `nms.star_nms`;
    each round of the fixpoint counts in `nms.iterations` and is one host
    wait (`host_waits.nms`)."""
    with span("nms.star_nms"):
        return _star_nms(centers, dists, probs, valid, nms_thresh, metric, max_pairs)


def _star_nms(centers, dists, probs, valid, nms_thresh, metric, max_pairs):
    B, K = probs.shape
    O, overflow = overlap_matrix_sparse(centers, dists, valid, metric=metric,
                                        max_pairs=max_pairs)
    over = O > nms_thresh
    p = torch.where(valid, probs, torch.full_like(probs, -math.inf))
    idx = torch.arange(K, device=probs.device)
    higher = ((p[:, :, None] > p[:, None, :])
              | ((p[:, :, None] == p[:, None, :]) & (idx[:, None] < idx[None, :])))
    sup = over & higher                       # sup[b, j, i]: kept j suppresses i
    keep = valid
    while True:
        suppressed = torch.any(sup & keep[:, :, None], dim=1)
        new = valid & ~suppressed
        count("nms.iterations")
        count("host_waits.nms")
        if torch.equal(new, keep):
            return keep, overflow
        keep = new
