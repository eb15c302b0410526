"""Host milliseconds a tick inside `LockstepEngine._collect` (tokens to the
host, detokenization, the transcripts), from the `bench.collect` span."""


def read(ctx):
    t = ctx["trace"]
    if t["count"].get("bench.collect") is None or not t["ticks"]:
        return None
    return t["host_s"]["bench.collect"] * 1e3 / t["ticks"]
