"""Offline batch throughput: the reference's own scenario.

The port's counterpart of scripts/bench_batch.py, with its JSON keys and
its lines. The reference's headline batch numbers (BASELINE.md) are
PCM -> text of one 20 s utterance: 5.8 s on a CPU (RTF 0.29) and 2.0 s on
an RTX 4080 (RTF 0.10), always batch 1. This runs the same full-utterance
pipeline -- the host DSP (the C++ frontend where it builds, else numpy),
the upload, `encode_batch` and greedy decode -- at full width on the
card: one 20 s utterance for a like-for-like RTF, then batches of them
(which the reference lacks), then one 300 s utterance (past the
reference's 164 s position-table cap).

The host DSP (`dsp_s`) and the upload (`upload_s`: the host-to-card copy
of the mel, up to a synchronize) are timed once a scenario; the compute
(`device_s`) is the p50 of `reps` runs of encode + decode, each timed on
the host clock up to a synchronize, after one warm-up run.
`end_to_end_s` = dsp + upload + compute. Added keys: `tokens` (the
non-blank tokens decoded, every utterance together) and `dtype`.

Prints one JSON line a scenario.

    python -m nemotron_tpu_torch.scripts.bench_batch [--quick] [--cpu]
        [--gguf MODEL.gguf [--blank-bias B]] [--scenarios 1x20,32x20,64x20,1x300]

--gguf: a GGUF's weights instead of the seeded random ones (with the
blank-biased joint), in f32, quantized weights kept (a Q8_0 GGUF's
encoder runs the Q8 kernel); --blank-bias B sets its joint's blank bias
to B (a random-weight GGUF otherwise emits the 10-symbol worst case on
every frame, and greedy decode, one host sync an emission, takes the
time); --scenarios: BATCHxSECONDS pairs.

Differences from the JAX script: no "sync RTT" is subtracted (every timed
region ends in a synchronize); the --gguf, --blank-bias and --scenarios
flags and the two added keys. Runs on the card unless --cpu.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ._common import (bench_config, bench_params, device_name, device_of,
                      opt, sync)

SR = 16000


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Sine + noise int16, the reference's synthetic fixture recipe
    (scripts/bench_batch.py:41-48)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(
        t.size)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def host_mel(params, cfg, audio: list) -> np.ndarray:
    """Each utterance's log-mel through its own host StreamingPreprocessor
    (the C++ DSP where it builds, else numpy), stacked [B, T, n_mels] f32
    (the utterances of a scenario have one length)."""
    from ..config import PreprocessorConfig
    from ..frontend.preprocessor import StreamingPreprocessor

    fb = params.preprocessor.filterbank.float().cpu().numpy()
    win = params.preprocessor.window.float().cpu().numpy()
    mels = []
    for a in audio:
        pre = StreamingPreprocessor(
            fb, win, cfg=PreprocessorConfig(n_mels=cfg.n_mels),
            device="cpu", backend="auto")
        mels.append(pre.process(a.reshape(1, -1))[0])
    return np.stack(mels).astype(np.float32)


def transcribe(params, cfg, mel: torch.Tensor, dtype) -> torch.Tensor:
    """encode_batch + greedy decode of a [B, T, n_mels] mel on the params'
    device: the tokens [B, T', MAX] (blank-padded)."""
    from ..models import decoder as dec_mod
    from ..models import encoder as enc_mod

    enc = enc_mod.encode_batch(params, cfg, mel)
    state = dec_mod.init_decoder_state(cfg, mel.shape[0], dtype, mel.device)
    tokens, _ = dec_mod.greedy_decode(params, cfg, enc, state)
    return tokens


def texts_of(tokens, cfg, vocab) -> list[str]:
    """Each utterance's transcript (its token ids where there is no
    vocabulary)."""
    from ..models.decoder import tokens_to_list
    from ..utils.text import tokens_to_text

    out = []
    for toks in tokens_to_list(tokens, cfg.blank_token):
        out.append(tokens_to_text(toks, vocab) if vocab
                   else " ".join(str(t) for t, _ in toks))
    return out


def run_scenario(params, cfg, batch, seconds, reps, dtype) -> tuple:
    """(the scenario's JSON record, its tokens on the host)."""
    dev = params.device
    audio = [synth_audio(seconds, seed=i) for i in range(batch)]
    t0 = time.perf_counter()
    mel_np = host_mel(params, cfg, audio)
    dsp_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mel = torch.from_numpy(mel_np).to(dev, dtype)
    sync(dev)
    upload_s = time.perf_counter() - t0

    tokens = transcribe(params, cfg, mel, dtype)      # warm-up
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tokens = transcribe(params, cfg, mel, dtype)
        sync(dev)
        times.append(time.perf_counter() - t0)
    device_s = float(np.percentile(times, 50))
    tokens = tokens.cpu().numpy()

    audio_s = batch * seconds
    end_to_end = dsp_s + upload_s + device_s
    return {
        "metric": "batch_transcribe",
        "batch": batch,
        "utterance_s": seconds,
        "audio_s": audio_s,
        "device_s": round(device_s, 4),
        "dsp_s": round(dsp_s, 4),
        "upload_s": round(upload_s, 4),
        "end_to_end_s": round(end_to_end, 4),
        "rtf_device": round(device_s / audio_s, 6),
        "rtf_end_to_end": round(end_to_end / audio_s, 6),
        "audio_s_per_compute_s": round(audio_s / device_s, 1),
        "ref_rtf_cuda_4080": 0.10,
        "ref_rtf_cpu": 0.29,
        "tokens": int((tokens != cfg.blank_token).sum()),
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_name(dev),
    }, tokens


def scenarios_of(spec: str) -> list[tuple[int, float]]:
    out = []
    for part in spec.split(","):
        b, s = part.lower().split("x")
        out.append((int(b), float(s)))
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    quick = "--quick" in argv
    device = device_of("--cpu" in argv)
    gguf = opt(argv, "--gguf", None, str)

    from ..params import cast_params, load_model

    if gguf:
        params, cfg, _ = load_model(gguf, device=device)
        bias = opt(argv, "--blank-bias", None, float)
        if bias is not None:
            from .token_agreement import with_blank_bias

            params = with_blank_bias(params, cfg, bias)
        dtype = torch.float32
    else:
        cfg = bench_config(quick)
        dtype = torch.bfloat16
        params = cast_params(bench_params(cfg, device), dtype)
    if quick:
        scenarios, reps = [(1, 5.0), (4, 5.0)], 2
    else:
        # (batch, seconds an utterance): 20 s is the reference's headline
        # fixture; 300 s is past its 164 s batch-mode cap
        scenarios, reps = [(1, 20.0), (32, 20.0), (64, 20.0), (1, 300.0)], 5
    spec = opt(argv, "--scenarios", None, str)
    if spec:
        try:
            scenarios = scenarios_of(spec)
        except ValueError:
            print(f"error: --scenarios {spec!r}: BATCHxSECONDS,...",
                  file=sys.stderr)
            return 1

    with torch.no_grad():
        for batch, seconds in scenarios:
            out, _ = run_scenario(params, cfg, batch, seconds, reps, dtype)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
