"""follow_flows_roofline: the least time of the traced window's frames'
flow following, their flows and cell probability read once and every
pixel's final position written once at the HBM peak (the backend's
`counts.follow_flows_bytes`), over the device time of the kernels named
`follow_flows` (csrc/follow_flows.cu: `follow_flows_count_kernel` and
`follow_flows_kernel`), in %.  None where the trace holds no such kernel."""

from benchmark import backends, trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("follow_flows",))
    if device <= 0:
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    counts = backends.module(seg["backend"], "counts")
    if not hasattr(counts, "follow_flows_bytes"):
        return None
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    nbytes = frames * counts.follow_flows_bytes(ctx.traffic["size"], seg)
    return 100.0 * nbytes / work.PEAK_BYTES / device
