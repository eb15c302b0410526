"""95th percentile of `tick`'s wall over the traced run's window ticks
after the profiled ones (ms): the R = 0 cells' tail, paced by the host."""

import numpy as np


def read(ctx):
    t = ctx["window_tick_s"]
    if len(t) < 20:
        return None
    return float(np.percentile(np.asarray(t) * 1e3, 95))
