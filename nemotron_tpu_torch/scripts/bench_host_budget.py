"""The host's budget a tick at cohort scale.

The port's counterpart of scripts/bench_host_budget.py, with its flags,
its JSON keys and its line. The card's capacity is one question; whether
the host's side of a tick -- PCM handling, the C++ DSP, mel staging,
emission extraction, transcript bookkeeping -- fits the chunk period at
that capacity is another. Each host stage of a tick of ONE cohort of B
streams is timed alone on real-shaped data (p50 / p90 over `--rounds`),
then summed a tick and a period (C cohorts run C ticks a period):

  pcm_copy        [B, shift] int16 ingest copy
  frontend_mel    the C++ PCM -> log-mel for B streams (frontend/native.py;
                  the engine's dsp="native" path; the device DSP removes
                  it); null where the library does not build
  mel_stage       the f32 mel slab made contiguous and copied into a
                  tensor on the run's device, up to a synchronize (the
                  host-to-card copy of a host-DSP tick)
  extract_emitted [B, T, MAX] token slab -> each stream's emissions
                  (models.decoder.extract_emitted)
  transcript      each emission detokenized and appended
                  (utils.text.tokens_to_text)

    python -m nemotron_tpu_torch.scripts.bench_host_budget [--batch 64]
        [--cohorts 3] [--rounds 20] [--emit-rate 2.5] [--json F] [--cpu]

Run it on an otherwise idle host. Differences from the JAX script: the
batch defaults to the port's serving cell, 64 streams (the JAX script's
800 was a TPU's); mel_stage includes the copy to the run's device. Runs
on the card unless --cpu.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ._common import SERVING_SLOTS, device_of, opt, sync


def timeit(fn, rounds):
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    a = np.asarray(ts)
    return {"p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p90_ms": float(np.percentile(a, 90)) * 1e3}


def emission_slab(B, T, MAX, blank, emit_rate, period_s, rng) -> np.ndarray:
    """A [B, T, MAX] int32 token slab, blank but for B * emit_rate *
    period_s emissions at random (stream, frame) places in symbol slot 0
    (scripts/bench_host_budget.py:118-124)."""
    toks = np.full((B, T, MAX), blank, np.int32)
    n_emit = int(B * emit_rate * period_s)
    bs = rng.integers(0, B, n_emit)
    ts_ = rng.integers(0, T, n_emit)
    toks[bs, ts_, 0] = rng.integers(0, blank, n_emit)
    return toks


def transcripts(emitted: dict, vocab: list, B: int) -> list[str]:
    """Each stream's emissions detokenized and appended to its
    transcript."""
    from ..utils.text import tokens_to_text

    out = [""] * B
    for s, pairs in emitted.items():
        out[s] += tokens_to_text(pairs, vocab)
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    from ..config import CacheConfig, ModelConfig
    from ..frontend import native as nat
    from ..frontend.preprocessor import (hann_window, mel_filterbank_slaney,
                                         pad_window)
    from ..models.decoder import extract_emitted

    device = device_of("--cpu" in argv)
    B = opt(argv, "--batch", SERVING_SLOTS, int)
    C = opt(argv, "--cohorts", 3, int)
    rounds = opt(argv, "--rounds", 20, int)
    emit_rate = opt(argv, "--emit-rate", 2.5, float)  # tokens/s/stream
    cfg = ModelConfig()
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    period_s = cc.shift_samples / cc.sample_rate
    n = cc.shift_samples
    rng = np.random.default_rng(0)

    res: dict = {"batch": B, "cohorts": C, "streams_total": B * C,
                 "chunk_period_ms": period_s * 1e3,
                 "tick_budget_ms": period_s * 1e3 / C,
                 "host_cores": os.cpu_count()}

    # --- PCM ingest copy --------------------------------------------------
    pcm = (rng.standard_normal((B, n)) * 6000).astype(np.int16)
    dst = np.empty_like(pcm)

    def pcm_copy():
        np.copyto(dst, pcm)

    res["pcm_copy"] = timeit(pcm_copy, rounds)
    res["pcm_mb_per_tick"] = pcm.nbytes / 1e6

    # --- the C++ frontend -------------------------------------------------
    if nat.available():
        fb = mel_filterbank_slaney(cc.n_mels, 512, cc.sample_rate)
        win = pad_window(hann_window(400), 512)
        fe = nat.NativeFrontend(fb, win, n_streams=B, n_mels=cc.n_mels)
        fe.process(pcm)                      # warm the residue path

        def frontend():
            fe.process(pcm)

        res["frontend_mel"] = timeit(frontend, rounds)
        mb_s = pcm.nbytes / (res["frontend_mel"]["p50_ms"] / 1e3) / 1e6
        res["frontend_mb_per_s_per_core"] = round(mb_s, 1)
    else:
        res["frontend_mel"] = None

    # --- mel staging: the slab made contiguous, copied to the device ------
    frames = cc.chunk_mel_frames
    mel = rng.standard_normal((B, frames, cc.n_mels)).astype(np.float32)
    staged = torch.empty(mel.shape, dtype=torch.float32, device=device)

    def stage():
        staged.copy_(torch.from_numpy(np.ascontiguousarray(mel).copy()))
        sync(device)

    res["mel_stage"] = timeit(stage, rounds)

    # --- emission extraction at a speech-like rate ------------------------
    T, MAX = cc.valid_out_len, 10
    blank = cfg.vocab_size - 1
    toks = emission_slab(B, T, MAX, blank, emit_rate, period_s, rng)
    offsets = np.zeros(B, np.int64)

    def extract():
        return extract_emitted(toks, blank, offsets)

    res["extract_emitted"] = timeit(extract, rounds)
    res["emissions_per_tick"] = int(B * emit_rate * period_s)

    # --- transcript append ------------------------------------------------
    vocab = [f"▁w{i}" for i in range(cfg.vocab_size)]
    emitted = extract_emitted(toks, blank, offsets)
    res["transcript"] = timeit(lambda: transcripts(emitted, vocab, B), rounds)

    host_ms = sum(res[k]["p50_ms"] for k in
                  ("pcm_copy", "frontend_mel", "mel_stage",
                   "extract_emitted", "transcript") if res.get(k))
    res["host_ms_per_tick_1core"] = round(host_ms, 2)
    res["host_ms_per_period_all_cohorts_1core"] = round(host_ms * C, 2)
    # the frontend parallelizes per stream; everything else is one slab
    # op. Cores needed if ticks must not take more than half the period
    # (the rest for the engine loop and jitter):
    res["cores_for_half_period"] = max(1, int(np.ceil(
        host_ms * C / (period_s * 1e3 * 0.5))))
    res["verdict_realtime_1core"] = host_ms * C < period_s * 1e3

    line = json.dumps(res)
    print(line)
    out = opt(argv, "--json", None, str)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
