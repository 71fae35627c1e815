"""The work the benchmark counts: operations and bytes from shapes, and the
chip's peaks.  Nothing here reads the program: every count follows from
the configuration's widths, the cell's frame size and what a run returned.
What one segmentation backend's network does is its own
`backends/<backend>/counts.py`.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit):
495 TFLOP/s TF32 on the tensor cores, the rate the port's float32 3x3
convolutions run at (3xTF32 Winograd products), and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12      # TF32 tensor-core FLOP/s, H100 SXM, dense
PEAK_BYTES = 3.35e12     # HBM3 bytes/s, H100 SXM
F32 = 4


def conv_flops(h: int, w: int, ci: int, co: int, k: int) -> float:
    """Direct-convolution FLOPs of one frame: a multiply and an add a tap."""
    return 2.0 * h * w * ci * co * k * k


def conv3x3_least_seconds(layers: list, frames: int) -> float:
    """The least time of the 3x3 convolutions `layers` ((name, h, w, ci,
    co) of one frame, a backend's `counts.conv3x3_layers`) over `frames`
    frames: per layer the larger of its FLOPs at the TF32 peak and its
    bytes (input, weights and output, each once) at the HBM peak, summed."""
    total = 0.0
    for _, h, w, ci, co in layers:
        flops = frames * conv_flops(h, w, ci, co, 3)
        nbytes = F32 * (frames * h * w * (ci + co) + 9 * ci * co + co)
        total += max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    return total


def cae_flops(scoring: dict, size: int = 64) -> float:
    """Direct FLOPs of one cell through the CAE: the encoder's 3x3 convs
    each before a 2x2 pool, the decoder's each before a 2x upsample, and
    the output conv."""
    enc = scoring["cae_filters"]
    dec = list(enc)
    chans = [1, *enc, *dec, 1]
    flops, s = 0.0, size
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        flops += conv_flops(s, s, ci, co, 3)
        if i < len(enc):
            s //= 2
        elif i < len(enc) + len(dec):
            s *= 2
    return flops


def percentile_least_seconds(frames: int, size: int) -> float:
    """Reading each frame's channel once (float32) at the HBM peak."""
    return frames * size * size * F32 / PEAK_BYTES


def clahe_least_seconds(pixels: int) -> float:
    """The scored cells' valid crop pixels read once and their equalized
    float32 pixels written once, at the HBM peak."""
    return 2 * pixels * F32 / PEAK_BYTES


def clahe_buckets(heights, widths, caps: tuple, full_cap: int) -> dict:
    """{capacity: cells} of the CLAHE size buckets the cells of these sides
    ride: the tightest of `caps` that holds both sides, where a side of
    13-15 px (13-15 tiles on that axis) sends a cell to the full crop
    capacity."""
    import numpy as np

    h, w = np.asarray(heights), np.asarray(widths)
    ns_ok = ((h >= 16) | (h <= 12)) & ((w >= 16) | (w <= 12))
    left = np.ones(h.shape, bool)
    out = {}
    for cap in sorted(c for c in caps if c < full_cap):
        fits = left & (h <= cap) & (w <= cap) & ns_ok
        out[cap] = int(fits.sum())
        left &= ~fits
    out[full_cap] = int(left.sum())
    return out
