"""vit_linear_roofline: the least time of the traced window's frames' ViT
block linears over the device time of the kernels named `vit_linear`
(csrc/vit_linear.cu), in %.  The work: qkv, proj, lin1 and lin2, 2 N E
(3E + E + 2M) FLOPs a tile and block (N tokens of width E, an MLP of M;
the configuration's `vit` widths, the backend's `counts.tiles_a_side`
tiles a frame), once at the TF32 peak: the share of one TF32 product's
time, which three products (3xTF32) can reach a third of.  None where the
trace holds no such kernel (a cell without a ViT, a program that runs its
linears elsewhere)."""

from benchmark import backends, trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("vit_linear",))
    if device <= 0:
        return None
    seg = dict(ctx.config["segmentation"], **ctx.workload["segmentation"])
    v = seg.get("vit")
    counts = backends.module(seg["backend"], "counts")
    if v is None or not hasattr(counts, "tiles_a_side"):
        return None
    E, M = v["dim"], v["hidden"]
    side = seg["tile"] // v["patch"]
    tiles = counts.tiles_a_side(ctx.traffic["size"], seg) ** 2
    flops = tiles * v["depth"] * 2.0 * side * side * E * (3 * E + E + 2 * M)
    frames = sum(len(b["frames"]) for b in ctx.traced_batches)
    return 100.0 * frames * flops / work.PEAK_FLOPS / device
