"""vit_attention_fused_pct: the ViT's attention calls that ran the fused
kernel (csrc/vit_attention.cu), in % of its calls: the port's counters
`vit.attention_fused` over `vit.attention_calls` in the untraced window.
None without calls (a cell with no ViT, or a program that does not count
them)."""


def read(ctx):
    counters = ctx.counters or {}
    calls = counters.get("vit.attention_calls", 0)
    if not calls:
        return None
    return 100.0 * counters.get("vit.attention_fused", 0) / calls
