"""cells_per_s: cells scored (rows the wait half returned) over the
window's seconds, from the first batch's start to the last wait's return."""


def read(ctx):
    return sum(b["cells"] for b in ctx.batches) / ctx.seconds
