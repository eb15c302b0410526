"""The whole tick's share of the configuration's peak: the model FLOPs of
a tick (the encoder's from its shapes for every chunk, the decoder's
from the labels these inputs emitted, over the traced ticks;
benchmark/roofline.py) over the mean wall of the run's untraced window
ticks times `peak_flops`."""


def read(ctx):
    t, rl, cfg, w = (ctx["trace"], ctx["roofline"], ctx["config"],
                     ctx["window_tick_s"])
    if not t["ticks"] or not t["chunks"] or not len(w):
        return None
    m, R, S = cfg["model"], ctx["traffic"]["latency_mode"], ctx["streams"]
    flops = (rl.encoder_flops_per_chunk(m, S, R) * t["chunks"]
             + rl.decoder_flops(m, S * t["chunks"] * (1 + R), t["tokens"]))
    return 100.0 * (flops / t["ticks"]) / ((sum(w) / len(w))
                                          * cfg["peak_flops"])
