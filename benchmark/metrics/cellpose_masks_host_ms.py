"""cellpose_masks_host_ms: the host's milliseconds a traced batch inside the
port's span `cellpose.masks` (`ops.cellpose_masks.get_masks` and the read
of the label table's size and the seed and point counts; the host's wait
for CPnet falls before it, in `cellpose.tiles`).  None without the span."""


def read(ctx):
    span = (ctx.spans or {}).get("cellpose.masks")
    if not span or not ctx.traced_batches:
        return None
    return span["host_ms"] / len(ctx.traced_batches)
