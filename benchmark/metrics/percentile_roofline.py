"""percentile_roofline: reading each traced frame's segmentation channel
once at the HBM peak (work.percentile_least_seconds) over the device
time of torch.kthvalue's kernels (`gatherKthValue`, `kthvalue`), in %."""

from benchmark import trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("gatherKthValue", "kthvalue"))
    if device <= 0:
        return None
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    return 100.0 * work.percentile_least_seconds(frames, ctx.traffic["size"]) / device
