"""mfu: the model FLOPs of the measured (untraced) window over its seconds
times the TF32 peak (work.PEAK_FLOPS): each frame's segmentation network
(the backend's `counts.frame_flops`: StarDist's U-Net convolutions and
probability head and its top-K dist-head rows; none for threshold) and
each scored cell's CAE, as direct arithmetic from their shapes.  The
window's own clock, so the profiler's cost does not enter; read on the
card only."""

from benchmark import backends, work


def read(ctx):
    if ctx.device_type != "cuda":
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    counts = backends.module(seg["backend"], "counts")
    frames = sum(len(b["frames"]) for b in ctx.batches)
    cells = sum(b["cells"] for b in ctx.batches)
    flops = (cells * work.cae_flops(ctx.config["scoring"])
             + frames * counts.frame_flops(ctx.traffic["size"], seg))
    return 100.0 * flops / (ctx.seconds * work.PEAK_FLOPS)
