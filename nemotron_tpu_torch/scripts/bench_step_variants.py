"""The fused chunk step across batch sizes, weight / cache tiers and
latency modes: a microbenchmark for optimization decisions.

The port's counterpart of scripts/bench_step_variants.py, with its flags,
its JSON and its lines. Each point runs `chunk_step` (greedy) or
`chunk_step_beam` (--beam K) at one batch, tier and right context: one
warm-up step, then `--chains` chains of `--len` state-threaded steps,
each chain timed on the host clock up to a torch.cuda.synchronize().
Each point reports the p50 / min / max of the chain means.

    python -m nemotron_tpu_torch.scripts.bench_step_variants [--batches 64]
        [--modes w8a8-int8kv] [--rc 13] [--chains 4] [--len 10] [--beam K]
        [--quick] [--cpu]

--modes (comma list): bf16, w8a8, bf16-int8kv, w8a8-int8kv, w8a8-int4kv,
w8a8-static, w8a8-static-int8kv (static: SmoothQuant's activation
scales, calibrated on 10 s of seeded noise through the host DSP).
--rc (comma list) 0, 1, 6, 13: the per-step real-time budget is the
mode's shift span (80 / 160 / 560 / 1120 ms).

The JAX script's --unroll, --attn, --attn-block and --fuse pick XLA and
Pallas lowerings through NEMOTRON_TPU_* environment knobs (the layer
scan's unroll, XLA or Pallas attention and its block, K chunk steps traced
into one program). The port has none of these lowerings: each flag is
taken only at its default (--unroll 1,24, --attn xla, --attn-block 8,
--fuse 1) and any other value exits 2 naming the flag. Its keys are
`{mode}/B{batch}` (+ `/R{rc}` off R = 13, `/beam{K}` for a beam), without
the JAX key's `unroll{U}-{attn}/` prefix, which names no port variant.

Differences from the JAX script: no "sync RTT" is subtracted (every chain
ends in a synchronize); the batches default to the port's serving cell,
64 streams (the JAX script's 768 and 896 were a TPU's); only an
out-of-memory error skips a point, any other failure ends the run. Runs
on the card unless --cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ._common import (SERVING_SLOTS, bench_config, bench_params, bench_states,
                      bench_w8a8, device_of, sync)

# the JAX script's lowering flags, at the only value the port takes
LOWERING_DEFAULTS = {"unroll": "1,24", "attn": "xla", "attn_block": "8",
                     "fuse": "1"}
MODES = ("bf16", "w8a8", "bf16-int8kv", "w8a8-int8kv", "w8a8-int4kv",
         "w8a8-static", "w8a8-static-int8kv")


def mode_params(mode, base, cfg, cc, dtype):
    """(params in `dtype`, cache config) of one tier; SystemExit on an
    unknown mode."""
    from ..params import cast_params

    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode}")
    if mode in ("w8a8-static", "w8a8-static-int8kv"):
        from ..config import PreprocessorConfig
        from ..frontend.preprocessor import StreamingPreprocessor
        from ..ops.smoothquant import smooth_quantize

        pre = StreamingPreprocessor(
            base.preprocessor.filterbank.float().cpu().numpy(),
            base.preprocessor.window.float().cpu().numpy(), n_streams=2,
            cfg=PreprocessorConfig(n_mels=cfg.n_mels), device=base.device)
        calib = (np.random.default_rng(7).standard_normal((2, 10 * 16000))
                 * 6000).astype(np.int16)
        mel = torch.from_numpy(pre.process(calib)).to(base.device)
        params = smooth_quantize(cast_params(base, torch.float32), cfg, mel,
                                 att_chunk=cc.chunk_enc_len, static_act=True)
        return (cast_params(params, dtype),
                dataclasses.replace(cc, kv_cache_int8="int8kv" in mode))
    params = base
    if mode.startswith("w8a8"):
        params = bench_w8a8(base)
    return (cast_params(params, dtype),
            dataclasses.replace(cc, kv_cache_int8=mode.endswith("int8kv"),
                                kv_cache_int4=mode.endswith("int4kv")))


def point(params, cfg, cc, B, dtype, beam, chains, chain_len, rng) -> dict:
    """One (tier, rc, batch) point: {p50_ms, min_ms, max_ms} of the chain
    means."""
    from ..models import encoder as enc_mod
    from ..streaming.session import chunk_step, chunk_step_beam

    dev = params.device
    pos_heads = enc_mod.precompute_pos_heads(params, cfg, cc, dtype)
    es, ds = bench_states(cfg, cc, B, dtype, dev, beam)
    mel = torch.from_numpy(rng.standard_normal(
        (B, cc.chunk_mel_frames, cfg.n_mels))).to(dev, dtype)

    def step(es, ds):
        if beam > 1:
            return chunk_step_beam(params, cfg, cc, mel, es, ds, pos_heads,
                                   beam, 10)
        return chunk_step(params, cfg, cc, mel, es, ds, pos_heads)[1:]

    es, ds = step(es, ds)
    sync(dev)
    est = []
    for _ in range(chains):
        t0 = time.perf_counter()
        for _ in range(chain_len):
            es, ds = step(es, ds)
        sync(dev)
        est.append((time.perf_counter() - t0) / chain_len)
    ms = sorted(x * 1e3 for x in est)
    return {"p50_ms": round(ms[len(ms) // 2], 2), "min_ms": round(ms[0], 2),
            "max_ms": round(ms[-1], 2)}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog="bench_step_variants")
    ap.add_argument("--batches", default=str(SERVING_SLOTS))
    ap.add_argument("--unroll", default=LOWERING_DEFAULTS["unroll"])
    ap.add_argument("--attn", default=LOWERING_DEFAULTS["attn"])
    ap.add_argument("--attn-block", default=LOWERING_DEFAULTS["attn_block"])
    ap.add_argument("--modes", default="w8a8-int8kv")
    ap.add_argument("--rc", default="13",
                    help="comma list of right-context latency modes")
    ap.add_argument("--fuse", default=LOWERING_DEFAULTS["fuse"])
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--len", type=int, default=10, dest="chain_len")
    ap.add_argument("--beam", type=int, default=1,
                    help="beam width K: the fused encoder + beam step")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv[1:])
    for key, default in LOWERING_DEFAULTS.items():
        if getattr(args, key) != default:
            flag = "--" + key.replace("_", "-")
            print(f"error: {flag} {getattr(args, key)!r}: the port has no "
                  f"such lowering to choose (only {flag} {default} is "
                  "taken)", file=sys.stderr)
            return 2

    from ..config import CacheConfig

    device = device_of(args.cpu)
    cfg = bench_config(args.quick)
    batches = [4] if args.quick else [int(b) for b in
                                      args.batches.split(",")]
    dtype = torch.float32 if args.quick else torch.bfloat16
    rcs = [int(r) for r in args.rc.split(",")]
    base = bench_params(cfg, device)
    cc = CacheConfig(att_right_context=rcs[0], n_mels=cfg.n_mels)
    with torch.no_grad():
        tiers = {m: mode_params(m, base, cfg, cc, dtype)
                 for m in args.modes.split(",")}

        results = {}
        rng = np.random.default_rng(0)
        for mode, (params, cc_mode) in tiers.items():
            for rc in rcs:
                cc_run = dataclasses.replace(cc_mode, att_right_context=rc)
                for B in batches:
                    key = f"{mode}/B{B}" + (f"/R{rc}" if rc != 13 else "") \
                        + (f"/beam{args.beam}" if args.beam > 1 else "")
                    try:
                        results[key] = point(params, cfg, cc_run, B, dtype,
                                             args.beam, args.chains,
                                             args.chain_len, rng)
                    except torch.cuda.OutOfMemoryError as e:
                        print(f"{mode} B={B}: {type(e).__name__}: {e}",
                              file=sys.stderr)
                        torch.cuda.empty_cache()
                        continue
                    print(f"{key}: {results[key]}", file=sys.stderr)

    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
