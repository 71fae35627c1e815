"""mfu: the model FLOPs of the measured (untraced) window over its seconds
times the TF32 peak (work.PEAK_FLOPS): each frame's U-Net convolutions
and probability head and its top-K dist-head rows where the configuration
runs StarDist, and each scored cell's CAE, as direct arithmetic from their
shapes.  The window's own clock, so the profiler's cost does not enter;
read on the card only."""

from benchmark import work


def read(ctx):
    if ctx.device_type != "cuda":
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    frames = sum(len(b["frames"]) for b in ctx.batches)
    cells = sum(b["cells"] for b in ctx.batches)
    flops = cells * work.cae_flops(ctx.config["scoring"])
    if seg["backend"] == "stardist":
        size = ctx.traffic["size"]
        flops += frames * (work.unet_flops(size, seg)
                           + work.dist_head_flops(seg, seg["max_candidates"]))
    return 100.0 * flops / (ctx.seconds * work.PEAK_FLOPS)
