"""batch_p90_ms: the 90th percentile (linear) over every batch of the
window of the time from the host call that starts the batch (the draw of
its frames included) to the return of its wait."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile([b["t_end"] - b["t_start"] for b in ctx.batches], 90))
