"""The one traffic generator: PCM for every stream of a closed-loop cell,
made from the traffic file's parameters and `--seed`.

Each stream speaks a voiced, speech-band signal of its own: harmonics of
a fundamental that drifts around the stream's pitch, cut to the
traffic's band, under a syllable-rate envelope, gated into phrases with
pauses, at the stream's level, over a noise floor. The signal is made on
the device as one continuous recording of `bank_ticks` ticks a stream
and kept on the host as int16 blocks; tick t of the run hands every
stream block t mod bank_ticks, so the window's ticks cost no generation.
Every seed gives the same sizes and the same cadence: only the signals
differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000


def shift_samples(latency_mode: int) -> int:
    """Samples a stream consumes a tick: one chunk's shift, 8 (1 + R) mel
    hops of 160 samples."""
    return 8 * (1 + latency_mode) * 160


def _uniform(gen, shape, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float64)


def make_bank(traffic: dict, seed: int, device) -> np.ndarray:
    """int16 PCM [bank_ticks, streams, shift_samples] from `seed`."""
    S, T = traffic["streams"], traffic["bank_ticks"]
    N = shift_samples(traffic["latency_mode"])
    sig = traffic["signal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    n = T * N
    out = np.empty((T, S, N), np.int16)
    # streams in blocks, so the device holds a few hundred MB at most
    block = max(1, (1 << 24) // n)
    t = torch.arange(n, device=device, dtype=torch.float64) / SAMPLE_RATE
    for s0 in range(0, S, block):
        b = min(block, S - s0)
        f0 = _uniform(gen, (b, 1), sig["f0_hz"], device)
        vib = _uniform(gen, (b, 1), sig["pitch_drift_hz"], device)
        vib_ph = _uniform(gen, (b, 1), (0.0, 2 * math.pi), device)
        # instantaneous pitch drifts by +-10% at the drift rate
        phase = 2 * math.pi * (f0 * t + 0.1 * f0 / (2 * math.pi * vib)
                               * torch.sin(2 * math.pi * vib * t + vib_ph))
        lo, hi = sig["band_hz"]
        x = torch.zeros((b, n), device=device, dtype=torch.float64)
        n_harm = int(hi // sig["f0_hz"][0])
        ph = _uniform(gen, (b, n_harm), (0.0, 2 * math.pi), device)
        # one formant-like peak a stream, moving at the syllable rate
        syl = _uniform(gen, (b, 1), sig["syllable_hz"], device)
        syl_ph = _uniform(gen, (b, 1), (0.0, 2 * math.pi), device)
        formant = 500.0 + 1500.0 * (0.5 + 0.5 * torch.sin(
            2 * math.pi * syl * t / 2 + syl_ph))
        for h in range(1, n_harm + 1):
            fh = h * f0 * (1 + 0.1 * torch.sin(2 * math.pi * vib * t
                                               + vib_ph))
            keep = ((fh >= lo) & (fh <= hi)).to(torch.float64)
            gain = keep / h * (1.0 + 2.0 * torch.exp(
                -((fh - formant) / 400.0) ** 2))
            x += gain * torch.sin(h * phase + ph[:, h - 1:h])
        env = (0.5 - 0.5 * torch.cos(2 * math.pi * syl * t + syl_ph)) ** 2
        # phrases of phrase_s seconds separated by pause_s of silence
        phrase = _uniform(gen, (b, 1), sig["phrase_s"], device)
        pause = _uniform(gen, (b, 1), sig["pause_s"], device)
        start = _uniform(gen, (b, 1), (0.0, 1.0), device) * (phrase + pause)
        gate = (torch.remainder(t + start, phrase + pause) < phrase)
        x = x * env * gate.to(torch.float64)
        x = x / x.abs().amax(dim=1, keepdim=True).clamp_min(1e-9)
        level = 10.0 ** (_uniform(gen, (b, 1), sig["level_dbfs"], device)
                         / 20.0)
        noise = torch.randn((b, n), generator=gen, device=device,
                            dtype=torch.float64)
        x = x * level + noise * 10.0 ** (sig["noise_dbfs"] / 20.0)
        pcm = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(
            torch.int16)
        out[:, s0:s0 + b] = pcm.reshape(b, T, N).transpose(0, 1).cpu().numpy()
    return out


def stream_pcm(bank: np.ndarray, streams, n_ticks: int) -> np.ndarray:
    """The PCM that `n_ticks` ticks handed to each of `streams`:
    [len(streams), n_ticks * shift_samples] int16."""
    T = bank.shape[0]
    idx = np.arange(n_ticks) % T
    return np.concatenate([bank[i][streams] for i in idx], axis=1)
