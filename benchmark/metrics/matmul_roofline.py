"""Share of its roofline that the encoder's matmuls reach (`qmm`: cuBLAS
for dense weights, the port's `w8a8_matmul` for W8A8): the least time the
card could take for the traced calls' M, K, N (benchmark/roofline.py),
over the device time of the work launched under them."""


def read(ctx):
    t, rl = ctx["trace"], ctx["roofline"]
    dev = t["device_s"].get("bench.qmm")
    calls = t["calls"]["qmm"]
    if not dev or not calls:
        return None
    return 100.0 * sum(rl.matmul_bound_s(*c) for c in calls) / dev
