"""winograd_fused_pct: the Winograd kernel's launches that ran with an
elementwise activation fused beside the conv (an input prologue, such as
Cellpose's BatchNorm and ReLU, or an output ReLU, such as StarDist's), in %
of its launches: the port's counters `winograd.fused` over
`winograd.launches` in the untraced window.  None without launches (a cell
with no U-Net, or a program that does not count them)."""


def read(ctx):
    counters = ctx.counters or {}
    launches = counters.get("winograd.launches", 0)
    if not launches:
        return None
    return 100.0 * counters.get("winograd.fused", 0) / launches
