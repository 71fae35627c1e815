"""unet_conv3x3_roofline: the least time of the traced window's frames'
thirteen 3x3 U-Net convolutions (work.conv3x3_least_seconds) over the
device time of the port's Winograd kernel (`winograd_kernel`,
csrc/winograd_conv3x3.cu), in %."""

from benchmark import trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("winograd_kernel",))
    if device <= 0:
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    return 100.0 * work.conv3x3_least_seconds(ctx.traffic["size"], seg, frames) / device
