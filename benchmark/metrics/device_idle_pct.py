"""device_idle_pct: 100 x (1 - the device's busy seconds a batch over the
seconds a batch of the measured window).  The busy seconds are the union
of the device's operation intervals in the traced batches (torch.profiler)
over their number; the seconds a batch are the untraced window's length
over its batches.  Under the profiler a host-bound batch takes longer
while its device work does not, so the traced window's own idle share
(`device.busy_s` / `device.window_s`) reads higher than the untraced
loop's; this one does not."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches or ctx.trace["busy_s"] <= 0:
        return None
    busy = ctx.trace["busy_s"] / len(ctx.traced_batches)
    interval = ctx.seconds / len(ctx.batches)
    return 100.0 * (1.0 - busy / interval)
