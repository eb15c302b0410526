"""Share of its roofline that the ring attention reaches: the least time
the card could take for the traced calls of `fused_ring_attention` (from
their shapes, benchmark/roofline.py), over the device time of the work
launched under them."""


def read(ctx):
    t, rl = ctx["trace"], ctx["roofline"]
    dev = t["device_s"].get("bench.attn")
    calls = t["calls"]["attn"]
    if not dev or not calls:
        return None
    return 100.0 * sum(rl.attention_bound_s(*c) for c in calls) / dev
