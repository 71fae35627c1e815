"""flow_qc_host_ms: the host's milliseconds a traced batch inside the port's
span `cellpose.flow_qc` (`ops.cellpose_masks.remove_bad_flow_masks`: the
float64 heat diffusion of every mask, one loop step a host launch, and
the flow errors).  None without the span."""


def read(ctx):
    span = (ctx.spans or {}).get("cellpose.flow_qc")
    if not span or not ctx.traced_batches:
        return None
    return span["host_ms"] / len(ctx.traced_batches)
