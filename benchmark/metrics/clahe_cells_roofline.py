"""clahe_cells_roofline: the traced window's scored cells' valid crop
pixels read once and written once as float32 at the HBM peak
(work.clahe_least_seconds), from the bounding-box sides of the returned
cells, over the device time of the CLAHE kernel (`clahe_cells_kernel`,
csrc/clahe_cells.cu), in %."""

from benchmark import trace, work


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    if any("heights" not in b for b in ctx.traced_batches):
        return None
    device = trace.kernel_seconds(ctx.trace["by_name"], ("clahe_cells_kernel",))
    if device <= 0:
        return None
    pixels = sum(int((b["heights"] * b["widths"]).sum()) for b in ctx.traced_batches)
    return 100.0 * work.clahe_least_seconds(pixels) / device
