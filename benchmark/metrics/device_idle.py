"""Share of a tick in which no kernel, copy or memset runs on the device:
the device's busy seconds a traced tick (the profiler's trace) against
the mean wall of the run's untraced window ticks. The traced ticks' own
wall is not the denominator: the profiler stretches a tick's host side
(an R = 0 tick by 1.4-1.8x) and its idle share with it."""


def read(ctx):
    t, w = ctx["trace"], ctx["window_tick_s"]
    if not t["ticks"] or not t["busy_s"] or not len(w):
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["ticks"]) / (sum(w) / len(w)))
