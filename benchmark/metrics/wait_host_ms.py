"""wait_host_ms: the host's milliseconds inside score_frames_fused_wait,
summed over the window's batches (the size-bucket loop of CLAHE, resize
and scoring, and any fallback re-run, show here)."""


def read(ctx):
    return 1e3 * sum(b["wait_host_s"] for b in ctx.batches)
