"""95th percentile of every frame's latency in the window, host clock
around ``process_frame`` (which ends with its results on the host)."""

import numpy as np


def read(ctx):
    if not ctx.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95))
