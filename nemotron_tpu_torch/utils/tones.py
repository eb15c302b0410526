"""Synthetic tone-transcription task: the evaluation streams of the trained
tones fixtures (`weights/tones_tiny*.gguf`).

The port's own copy of the evaluation half of `nemotron_tpu/utils/tones.py`
(numpy only; the training sampler waits for the training slice). An
utterance is a sequence of pure tones drawn from `n_tones` log-spaced
frequencies over the speech band; the transcript is the sequence of tone
indices (token id == tone index), so the token error against the known
labels is a real error rate. The same seed gives the same int16 audio and
labels as the JAX package.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
GAP_RANGE = (0.05, 0.09)   # silence after each tone (clean onsets)


def tone_frequencies(n_tones: int, lo: float = 180.0,
                     hi: float = 3600.0) -> np.ndarray:
    """Log-spaced tone inventory inside the mel filterbank's sensitive band."""
    return np.geomspace(lo, hi, n_tones).astype(np.float64)


def render_tones(labels, durations, rng: np.random.Generator,
                 n_tones: int, n_samples: int,
                 noise: float = 0.02, gaps=None) -> np.ndarray:
    """Render (labels, per-tone durations in seconds) to int16 PCM of
    exactly n_samples (zero-padded; the tone tail past n_samples is cut).

    Each tone: a 10 ms raised-cosine attack/release envelope and a random
    amplitude/phase, over a white-noise floor. `gaps` (same length as
    labels): seconds of silence AFTER each tone."""
    freqs = tone_frequencies(n_tones)
    sig = np.zeros(n_samples)
    pos = 0
    if gaps is None:
        gaps = np.zeros(len(labels))
    for lab, dur, gap in zip(labels, durations, gaps):
        n = int(dur * SAMPLE_RATE)
        t = np.arange(n) / SAMPLE_RATE
        tone = rng.uniform(0.5, 0.9) * np.sin(
            2 * np.pi * freqs[int(lab)] * t + rng.uniform(0, 2 * np.pi))
        edge = int(0.010 * SAMPLE_RATE)
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
        tone[:edge] *= ramp
        tone[-edge:] *= ramp[::-1]
        end = min(pos + n, n_samples)
        sig[pos:end] += tone[: end - pos]
        pos += n + int(gap * SAMPLE_RATE)
        if pos >= n_samples:
            break
    sig += noise * rng.standard_normal(n_samples)
    return np.clip(sig * 16000, -32767, 32767).astype(np.int16)


def enc_frames_of_mel(t: int) -> int:
    """Mel frames -> encoder frames after the 3 stride-2 causal stages."""
    for _ in range(3):
        t = t // 2 + 1
    return t


def grammar_transitions(n_tones: int, branch: int = 3,
                        seed: int = 17) -> np.ndarray:
    """A sparse Markov label grammar: token i may only be followed by
    `branch` fixed successors (uniform among them). Returns the
    [n_tones, branch] int32 successor table (deterministic in seed)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n_tones, size=branch, replace=False)
                     for _ in range(n_tones)]).astype(np.int32)


def markov_labels(rng: np.random.Generator, n: int,
                  trans: np.ndarray) -> np.ndarray:
    """Sample a length-n label sequence from a grammar_transitions table
    (uniform start, then uniform over each token's successor row)."""
    out = np.empty(n, np.int64)
    cur = int(rng.integers(0, trans.shape[0]))
    for i in range(n):
        out[i] = cur
        cur = int(trans[cur, rng.integers(0, trans.shape[1])])
    return out


def make_eval_streams(n_streams: int, seconds: float, n_tones: int,
                      seed: int = 0,
                      dur_range: tuple[float, float] = (0.20, 0.32),
                      return_onsets: bool = False,
                      noise: float = 0.02,
                      label_sampler=None):
    """Continuous tone streams for accuracy runs.

    Returns (audio [S, N] int16, truths: list of per-stream label lists).
    Each stream is an unbroken tone sequence filling `seconds`; the truth
    keeps exactly the tones whose onset falls inside the window (a final
    tone cut at the boundary stays in the truth).

    noise: white-noise floor amplitude (default matches training).
    label_sampler: optional callable (rng, n) -> labels overriding the
    uniform draw (e.g. markov_labels with a grammar_transitions table).
    return_onsets=True additionally returns per-stream onset times in
    seconds (same length as each truth list).
    """
    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    audio = np.zeros((n_streams, n), np.int16)
    truths: list[list[int]] = []
    onsets: list[list[float]] = []
    for s in range(n_streams):
        approx = int(seconds / dur_range[0]) + 2
        labs = (rng.integers(0, n_tones, approx) if label_sampler is None
                else np.asarray(label_sampler(rng, approx), np.int64))
        durs = rng.uniform(*dur_range, approx)
        gaps = rng.uniform(*GAP_RANGE, approx)
        starts = np.concatenate(
            [[0.0], np.cumsum(durs + gaps)[:-1]]) * SAMPLE_RATE
        keep = starts < n
        audio[s] = render_tones(labs[keep], durs[keep], rng, n_tones, n,
                                gaps=gaps[keep], noise=noise)
        truths.append([int(x) for x in labs[keep]])
        onsets.append([float(x) / SAMPLE_RATE for x in starts[keep]])
    if return_onsets:
        return audio, truths, onsets
    return audio, truths
