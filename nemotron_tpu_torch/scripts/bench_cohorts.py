"""Phase-staggered cohort capacity bench (see streaming/cohorts.py).

The port's counterpart of scripts/bench_cohorts.py, with its flags, its
JSON keys and its line. C staggered cohorts of B streams share one weight
set; they fit a card in real time while

    compute:  C <= floor(chunk_period / step_time)
    memory:   C*B state sets + weights + activations <= the card's memory

Three modes:

  default (device capacity): C cohorts' encoder/decoder state resident on
      the card, fused chunk steps (`streaming.session.chunk_step`, or the
      beam step with --beam K) round-robin over them, C steps a round and
      one torch.cuda.synchronize() a round. Real time: the round's p50 <
      the chunk period; `compute_headroom_cohorts` = floor(period / step
      p50).
  --e2e: CohortScheduler end to end (pipelined LockstepEngine ticks with
      the device DSP), each tick timed up to a synchronize.
  --serving: ServingCohorts (ragged ServingEngines, every slot fed one
      chunk a tick: the engine's worst case), timed as --e2e.

    python -m nemotron_tpu_torch.scripts.bench_cohorts [--cohorts C]
        [--batch B] [--mode bf16|w8a8-int8kv] [--rounds N] [--e2e]
        [--serving] [--kv-int4] [--quick] [--json F] [--rc R] [--shared]
        [--beam K] [--dsp auto|numpy|native|device] [--cpu]

--rc R: latency mode (the real-time budget is the mode's chunk period,
80 / 160 / 560 / 1120 ms at R = 0 / 1 / 6 / 13); --shared: the shared
x-ring; --kv-int4: int4 K/V rings; --beam K: the fused beam step.

Differences from the JAX script: no "sync RTT" is measured or subtracted
(the key `rtt_ms` is gone), since every round ends in a synchronize; the
batch defaults to the port's serving cell, 64 streams (the JAX script's
800 was a TPU's); --dsp is read from this call's arguments. Runs on the
card unless --cpu. Added keys: `param_bytes` (the weights) and
`state_bytes_per_stream` (one stream's encoder and decoder state), the
terms of the memory bound.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ._common import (SERVING_SLOTS, bench_config, bench_params, bench_states,
                      bench_w8a8, device_of, opt, sync, tree_bytes)

MODES = ("bf16", "w8a8-int8kv")


def realtime(round_p50_s: float, period_s: float) -> bool:
    """A staggered round of C steps fits the chunk period."""
    return round_p50_s < period_s


def compute_headroom_cohorts(step_p50_s: float, period_s: float):
    """How many cohorts' steps fit the chunk period (None without a step
    time)."""
    return int(period_s // step_p50_s) if step_p50_s > 0 else None


def build(argv, quick, device):
    """(params in the compute dtype, cfg, cc, mode name, compute dtype):
    the mode's weights in bf16, as the JAX script casts them, and its cache
    layout."""
    from ..config import CacheConfig
    from ..params import cast_params

    cfg = bench_config(quick)
    rc = opt(argv, "--rc", 13, int)
    cc = CacheConfig(att_right_context=rc, n_mels=cfg.n_mels)
    if "--shared" in argv:
        cc = dataclasses.replace(cc, shared_cache=True)
    mode = opt(argv, "--mode", "bf16" if quick else "w8a8-int8kv", str)
    if mode not in MODES:
        print(f"error: unknown --mode {mode!r}", file=sys.stderr)
        raise SystemExit(1)
    if mode.endswith("int8kv"):
        cc = dataclasses.replace(cc, kv_cache_int8=True)
    if "--kv-int4" in argv:
        cc = dataclasses.replace(cc, kv_cache_int8=False, kv_cache_int4=True)
    base = bench_params(cfg, device)
    if mode.startswith("w8a8"):
        base = bench_w8a8(base)
    dtype = torch.bfloat16
    return cast_params(base, dtype), cfg, cc, mode, dtype


def memory(params, cfg, cc, B, dtype, beam=1) -> dict:
    """The memory side of the capacity bound: the weights' bytes and one
    stream's state bytes (C*B of them resident, beside one weight set)."""
    enc, dec = bench_states(cfg, cc, B, dtype, "cpu", beam)
    return {"param_bytes": tree_bytes(params),
            "state_bytes_per_stream": (tree_bytes(enc)
                                       + tree_bytes(dec)) // B}


def bench_device(params, cfg, cc, C, B, rounds, period_s, dtype, beam=1):
    """C cohorts' states resident; staggered chunk steps round-robin."""
    from ..models import encoder as enc_mod
    from ..streaming.session import chunk_step, chunk_step_beam

    dev = params.device
    pos_heads = enc_mod.precompute_pos_heads(params, cfg, cc, dtype)
    states = [bench_states(cfg, cc, B, dtype, dev, beam) for _ in range(C)]
    if beam > 1:

        def step(enc, dec, mel):
            return chunk_step_beam(params, cfg, cc, mel, enc, dec,
                                   pos_heads, beam, 10)
    else:
        def step(enc, dec, mel):
            return chunk_step(params, cfg, cc, mel, enc, dec, pos_heads)[1:]
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (B, cc.chunk_mel_frames, cfg.n_mels), dtype=np.float32)).to(
            dev, dtype)

    def one_round():
        for c in range(C):
            states[c] = step(*states[c], mel)
        sync(dev)

    t0 = time.perf_counter()
    one_round()          # every cohort's first step
    print(f"warmup ({C} cohort first-steps): "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    per_round = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        one_round()
        per_round.append(time.perf_counter() - t0)
    r = np.asarray(per_round)
    step_p50 = float(np.percentile(r, 50)) / C
    return {
        "round_p50_ms": float(np.percentile(r, 50)) * 1e3,
        "round_p90_ms": float(np.percentile(r, 90)) * 1e3,
        "step_p50_ms": step_p50 * 1e3,
        "rounds": rounds,
        "realtime": realtime(float(np.percentile(r, 50)), period_s),
        "compute_headroom_cohorts": compute_headroom_cohorts(step_p50,
                                                             period_s),
    }


def _tick_stats(per_tick, per_round, rounds, period_s, note) -> dict:
    t, r = np.asarray(per_tick), np.asarray(per_round)
    return {
        "tick_p50_ms": float(np.percentile(t, 50)) * 1e3,
        "tick_p90_ms": float(np.percentile(t, 90)) * 1e3,
        "round_p50_ms": float(np.percentile(r, 50)) * 1e3,
        "round_p90_ms": float(np.percentile(r, 90)) * 1e3,
        "rounds": rounds,
        "realtime": realtime(float(np.percentile(r, 50)), period_s),
        "note": note,
    }


def bench_e2e(params, cfg, cc, C, B, rounds, period_s, dtype, beam=1):
    """CohortScheduler end to end: staggered pipelined LockstepEngine
    ticks, PCM staging and the upload included."""
    from ..streaming.cohorts import CohortScheduler

    sched = CohortScheduler(params, cfg, None, cc, n_streams=B,
                            n_cohorts=C, compute_dtype=dtype,
                            beam_size=beam)
    dev = params.device
    rng = np.random.default_rng(0)
    n = cc.shift_samples

    def block():
        return (rng.standard_normal((B, n)) * 6000).astype(np.int16)

    # warm-up: two rounds (the pipelined path's first tick differs)
    for _ in range(2):
        for c in range(C):
            sched.tick(c, block(), pipelined=True)
    sync(dev)

    per_tick, per_round = [], []
    for _ in range(rounds):
        r0 = time.perf_counter()
        for c in range(C):
            t0 = time.perf_counter()
            sched.tick(c, block(), pipelined=True)
            sync(dev)
            per_tick.append(time.perf_counter() - t0)
        per_round.append(time.perf_counter() - r0)
    return _tick_stats(per_tick, per_round, rounds, period_s,
                       "pipelined ticks (+1 tick text latency); includes "
                       "host PCM staging and the host-to-card copy")


def bench_serving(params, cfg, cc, C, B, rounds, period_s, dtype, beam=1,
                  dsp="auto"):
    """ServingCohorts: C cohorts of ragged ServingEngines, every slot
    active and fed one chunk a tick -- the engine's whole per-slot
    bookkeeping (buffering, masking, emission extraction) included. All
    slots advancing is the ragged engine's worst case."""
    from ..streaming.cohorts import ServingCohorts

    sched = ServingCohorts(params, cfg, None, cc, n_slots=B, n_cohorts=C,
                           compute_dtype=dtype, beam_size=max(beam, 1),
                           dsp=dsp)
    ids = [[sched.add_stream(cohort=c) for _ in range(B)]
           for c in range(C)]
    dev = params.device
    rng = np.random.default_rng(0)
    n = cc.shift_samples

    def feed(c):
        block = (rng.standard_normal((B, n)) * 6000).astype(np.int16)
        sched.feed_audio({gid: block[i] for i, gid in enumerate(ids[c])})

    for _ in range(2):                       # warm-up: the steady state
        for c in range(C):
            feed(c)
            sched.step(c)
    sync(dev)

    per_tick, per_round = [], []
    for _ in range(rounds):
        r0 = time.perf_counter()
        for c in range(C):
            t0 = time.perf_counter()
            feed(c)
            sched.step(c)
            sync(dev)
            per_tick.append(time.perf_counter() - t0)
        per_round.append(time.perf_counter() - r0)
    return _tick_stats(per_tick, per_round, rounds, period_s,
                       "ragged ServingEngine cohorts, all slots advancing "
                       "(worst case); includes host PCM staging, per-slot "
                       "bookkeeping and the host-to-card copy")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    quick = "--quick" in argv
    device = device_of("--cpu" in argv)
    C = opt(argv, "--cohorts", 2, int)
    B = opt(argv, "--batch", 4 if quick else SERVING_SLOTS, int)
    rounds = opt(argv, "--rounds", 3 if quick else 20, int)
    beam = opt(argv, "--beam", 1, int)

    params, cfg, cc, mode, dtype = build(argv, quick, device)
    period_s = cc.shift_samples / cc.sample_rate
    if "--serving" in argv:
        res = bench_serving(params, cfg, cc, C, B, rounds, period_s, dtype,
                            beam=beam, dsp=opt(argv, "--dsp", "auto", str))
    else:
        fn = bench_e2e if "--e2e" in argv else bench_device
        res = fn(params, cfg, cc, C, B, rounds, period_s, dtype, beam=beam)
    res.update({
        "bench": ("serving" if "--serving" in argv
                  else "e2e" if "--e2e" in argv else "device"),
        "mode": mode + ("-int4kv" if "--kv-int4" in argv else "")
        + ("-shared" if "--shared" in argv else "")
        + (f"-beam{beam}" if beam > 1 else ""),
        "rc": cc.att_right_context,
        "cohorts": C, "batch": B,
        "streams_total": C * B,
        "chunk_period_ms": period_s * 1e3,
    })
    res.update(memory(params, cfg, cc, B, dtype, beam))
    line = json.dumps(res)
    print(line)
    out = opt(argv, "--json", None, str)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
