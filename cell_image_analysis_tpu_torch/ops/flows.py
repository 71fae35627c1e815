"""Cellpose's flow following: each cell pixel's final position after
`niter` Euler steps through its frame's flow field.

The JAX package has no counterpart.  The source is MouseLand/cellpose
`dynamics.follow_flows` and `steps2D_interp` (its GPU branch), whose
arithmetic the port keeps, quirks included:

- the field is `dP * (cellprob > threshold) / 5` (an IEEE division, as
  numpy's);
- the moving points are the pixels where the field's dy exceeds 1e-3 in
  magnitude; every other pixel keeps its own position, and a frame with
  fewer than 5 moving points has none (Cellpose returns no masks there);
- positions and field are normalised by L - 1 a side (the field times
  2 / (L - 1), the positions times 1 / (L - 1), then 2p - 1), sampled as
  `grid_sample(align_corners=False, padding_mode="zeros")` samples,
  which reads the normalised position as (p + 1) L / 2 - 1/2: Cellpose
  keeps both;
- each step p = clamp(p + bilinear(field, p), -1, 1); after the last one
  the normalisation is undone.

`follow_flows` launches `csrc/follow_flows.cu` for CUDA tensors (all steps
of a point in one launch, one thread a pixel) and runs `follow_flows_plain`
(the same loop through `grid_sample`, one call a step) for CPU tensors.
Both return every pixel's final (y, x) and each frame's count of moving
points.  The span `cellpose.follow_flows`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.utils.profiler import span

MIN_POINTS = 5  # follow_flows: fewer moving points than this, and a frame has no masks


def flow_field(dP: torch.Tensor, cellprob: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """(B, 2, H, W) `dP * (cellprob > threshold) / 5`, float32, dividing
    as numpy divides (a tensor divisor: no reciprocal on the card)."""
    five = torch.full((), 5.0, dtype=torch.float32, device=dP.device)
    return (dP.float() * (cellprob > threshold)[:, None].float()) / five


def moving_points(field: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool: the pixels `follow_flows` moves, |dy| > 1e-3, none in
    a frame with fewer than MIN_POINTS of them."""
    moving = field[:, 0].abs() > 1e-3
    enough = moving.flatten(1).sum(1) >= MIN_POINTS
    return moving & enough[:, None, None]


def _grid(h: int, w: int, device) -> torch.Tensor:
    """(2, H, W) float32 (y, x) of every pixel."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return torch.stack([yy, xx])


def follow_flows_plain(dP: torch.Tensor, cellprob: torch.Tensor, niter: int = 200,
                       threshold: float = 0.0) -> torch.Tensor:
    """(B, 2, H, W) final (y, x) float32 of every pixel: Cellpose's
    `steps2D_interp` on each frame's moving points (`grid_sample`, one call
    a step), batched over frames."""
    B, _, h, w = dP.shape
    field = flow_field(dP, cellprob, threshold)
    moving = moving_points(field)
    p = _grid(h, w, dP.device).expand(B, 2, h, w).clone()
    if not bool(moving.any()):
        return p
    shape = (w - 1.0, h - 1.0)                       # (x, y), as Cellpose flips them
    im = field[:, [1, 0]].clone()                    # (B, 2: dx, dy, H, W)
    frame, yy, xx = torch.nonzero(moving, as_tuple=True)
    n = frame.numel()
    # one batch row a frame, padded with points that sample nothing used
    per = torch.bincount(frame, minlength=B)
    slot = torch.arange(n, device=dP.device) - (torch.cumsum(per, 0) - per)[frame]
    m = int(per.max())
    pt = torch.zeros((B, 1, m, 2), dtype=torch.float32, device=dP.device)
    pt[frame, 0, slot, 0] = xx.float()
    pt[frame, 0, slot, 1] = yy.float()
    for k in range(2):
        im[:, k] *= 2.0 / shape[k]
        pt[..., k] /= shape[k]
    pt = pt * 2 - 1
    for _ in range(niter):
        dPt = F.grid_sample(im, pt, align_corners=False)   # (B, 2, 1, m)
        for k in range(2):
            pt[..., k] = torch.clamp(pt[..., k] + dPt[:, k], -1.0, 1.0)
    pt = (pt + 1) * 0.5
    for k in range(2):
        pt[..., k] *= shape[k]
    p[frame, 0, yy, xx] = pt[frame, 0, slot, 1]
    p[frame, 1, yy, xx] = pt[frame, 0, slot, 0]
    return p


def follow_flows(dP: torch.Tensor, cellprob: torch.Tensor, niter: int = 200,
                 threshold: float = 0.0) -> tuple:
    """(final (y, x) (B, 2, H, W) float32 of every pixel, moving points (B,)
    int32) of the (B, 2, H, W) flows `dP` and (B, H, W) cell
    probabilities: the kernel on the card, `follow_flows_plain` on the
    CPU.  No host synchronisation on the card."""
    with span("cellpose.follow_flows"):
        if dP.device.type == "cpu":
            moving = moving_points(flow_field(dP, cellprob, threshold))
            return (follow_flows_plain(dP, cellprob, niter, threshold),
                    moving.flatten(1).sum(1).int())
        from cell_image_analysis_tpu_torch.ops.cuda.flows import follow_flows_cuda

        return follow_flows_cuda(dP, cellprob, niter, threshold)
