"""Device milliseconds a tick of the work launched under
`mel_frontend_step` (the device DSP), from the trace."""


def read(ctx):
    t = ctx["trace"]
    dev = t["device_s"].get("bench.frontend")
    if not dev or not t["ticks"]:
        return None
    return dev * 1e3 / t["ticks"]
