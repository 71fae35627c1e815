"""start_host_ms: the host's milliseconds inside score_frames_fused_start,
summed over the window's batches (the benchmark's own clock around the
call; the StarDist path's host waits inside star_nms show here)."""


def read(ctx):
    return 1e3 * sum(b["start_host_s"] for b in ctx.batches)
