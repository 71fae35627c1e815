"""vit_attention_roofline: the least time of the traced window's frames'
fused attention (the backend's `counts.attention_work`: the larger of its
FLOPs at the TF32 peak and its bytes at the HBM peak) over the device time
of the kernels named `vit_attention` (csrc/vit_attention.cu), in %.  None
where the trace holds no such kernel."""

from benchmark import backends, trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("vit_attention",))
    if device <= 0:
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    counts = backends.module(seg["backend"], "counts")
    if not hasattr(counts, "attention_work"):
        return None
    flops, nbytes = counts.attention_work(ctx.traffic["size"], seg)
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    least = frames * max(flops / work.PEAK_FLOPS, nbytes / work.PEAK_BYTES)
    return 100.0 * least / device
