"""unet_conv3x3_roofline: the least time of the traced window's frames'
3x3 convolutions that run through the port's Winograd kernel (the
backend's `counts.conv3x3_layers`: StarDist's thirteen U-Net convs;
work.conv3x3_least_seconds) over the device time of that kernel
(`winograd_kernel`, csrc/winograd_conv3x3.cu), in %."""

from benchmark import backends, trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("winograd_kernel",))
    if device <= 0:
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    layers = backends.module(seg["backend"], "counts").conv3x3_layers(ctx.traffic["size"], seg)
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    return 100.0 * work.conv3x3_least_seconds(layers, frames) / device
