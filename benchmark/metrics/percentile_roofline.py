"""percentile_roofline: reading each traced frame's segmentation channel
once at the HBM peak (work.percentile_least_seconds) over the device
time of the port's radix select (csrc/kthvalue_radix.cu: its kernels
`kthvalue_radix_init` and `kthvalue_radix_pass<0..2>`, which the needle
`kthvalue` finds; `gatherKthValue` is torch.kthvalue's, which the port
called before), in %."""

from benchmark import trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("gatherKthValue", "kthvalue"))
    if device <= 0:
        return None
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    return 100.0 * work.percentile_least_seconds(frames, ctx.traffic["size"]) / device
