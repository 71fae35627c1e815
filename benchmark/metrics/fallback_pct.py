"""fallback_pct: batches of the window that re-ran through the exact twin
(the benchmark's counter on the fallback function), in % of its batches."""


def read(ctx):
    return 100.0 * sum(bool(b["fell_back"]) for b in ctx.batches) / len(ctx.batches)
