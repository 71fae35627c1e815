"""setup_s: from the process's start to the first timed batch: imports,
kernel build or load, the frame pool, the weights, the warm-up."""


def read(ctx):
    return ctx.setup_s
