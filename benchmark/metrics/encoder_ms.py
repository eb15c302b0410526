"""Device milliseconds a tick of the work launched under `encode_chunk`
(subsampling and the 24 conformer layers), from the trace."""


def read(ctx):
    t = ctx["trace"]
    dev = t["device_s"].get("bench.encoder")
    if not dev or not t["ticks"]:
        return None
    return dev * 1e3 / t["ticks"]
