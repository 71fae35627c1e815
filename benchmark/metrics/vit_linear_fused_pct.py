"""vit_linear_fused_pct: the ViT block linears that ran the tensor-core
kernel (csrc/vit_linear.cu), in % of their calls: the port's counters
`vit.linear_fused` over `vit.linear_calls` in the untraced window.  None
without calls (a cell with no ViT, or a program that does not count
them)."""


def read(ctx):
    counters = ctx.counters or {}
    calls = counters.get("vit.linear_calls", 0)
    if not calls:
        return None
    return 100.0 * counters.get("vit.linear_fused", 0) / calls
