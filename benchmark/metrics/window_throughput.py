"""Audio seconds advanced over all streams a second, over the traced run's
window ticks after the profiled ones: the end-to-end throughput of a cell
whose host's speed drifts too far from run to run to hold it to a bound
(benchmark/traffic: one shift of PCM a stream a tick)."""


def read(ctx):
    t = ctx["window_tick_s"]
    if len(t) < 20:
        return None
    tr = ctx["traffic"]
    audio_tick_s = 8 * (1 + tr["latency_mode"]) * 160 / 16000.0
    return ctx["streams"] * audio_tick_s * len(t) / sum(t)
