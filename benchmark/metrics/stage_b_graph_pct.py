"""stage_b_graph_pct: stage B's chunks that ran as one replay of a captured
CUDA graph, in % of its chunks: the port's counters `stage_b.graph_chunks`
over `chunks` in the untraced window (the CPU reads 0: its chunks run
eagerly, `stage_b.eager_chunks`).  None without chunks, or where the
program counts neither route (a program without the graph route)."""


def read(ctx):
    counters = ctx.counters or {}
    chunks, graphs = counters.get("chunks", 0), counters.get("stage_b.graph_chunks", 0)
    if not chunks or not (graphs or counters.get("stage_b.eager_chunks")):
        return None
    return 100.0 * graphs / chunks
