"""Synthetic tone-transcription task: the in-repo trainable ASR dataset,
and the evaluation streams of the trained tones fixtures
(`weights/tones_tiny*.gguf`).

The port's own copy of `nemotron_tpu/utils/tones.py`. An utterance is a
sequence of pure tones drawn from `n_tones` log-spaced frequencies over
the speech band; the transcript is the sequence of tone indices (token id
== tone index), so the token error against the known labels is a real
error rate. The same seed (and step) gives the same int16 audio, labels,
lengths and warm-up history as the JAX package; the log-mel comes from the
port's frontend on the device the caller names.
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


def make_dataset(n_utts: int, tones_per_utt: int, n_tones: int,
                 filterbank: np.ndarray, window: np.ndarray,
                 n_mels: int, seed: int = 0,
                 dur_range: tuple[float, float] = (0.20, 0.32),
                 device="cuda") -> dict:
    """Pre-rendered training pool with STATIC shapes.

    Returns numpy dict {mel [N, Tm, n_mels] f32, labels [N, U] i32,
    mel_lengths [N] i32 (ENCODER frames, the unit training.loss_fn masks
    in), label_lengths [N] i32} -- the exact batch layout the training
    stack consumes (nemotron_tpu/utils/tones.py:77-118). All utterances
    carry U = tones_per_utt labels; audio length varies with the sampled
    durations and is zero-padded to the pool maximum, with mel_lengths
    masking the padding out of the loss. The FFT runs on `device`.
    """
    from ..config import PreprocessorConfig
    from ..frontend.preprocessor import StreamingPreprocessor

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_tones, (n_utts, tones_per_utt))
    durs = rng.uniform(*dur_range, (n_utts, tones_per_utt))
    gaps = rng.uniform(*GAP_RANGE, (n_utts, tones_per_utt))
    n_samples = int((dur_range[1] + GAP_RANGE[1]) * tones_per_utt
                    * SAMPLE_RATE) + 400
    audio = np.stack([
        render_tones(labels[i], durs[i], rng, n_tones, n_samples,
                     gaps=gaps[i])
        for i in range(n_utts)])

    pre = StreamingPreprocessor(filterbank, window, n_streams=n_utts,
                                cfg=PreprocessorConfig(n_mels=n_mels),
                                device=device)
    mel = pre.process(audio)                       # [N, Tm, n_mels]

    # per-utterance valid length from the true (un-padded) signal span
    sig_samples = ((durs + gaps).sum(axis=1) * SAMPLE_RATE).astype(np.int64)
    mel_valid = np.minimum(sig_samples // 160 + 1, mel.shape[1])
    enc_len = np.array([enc_frames_of_mel(int(t)) for t in mel_valid])

    return {
        "mel": np.asarray(mel, np.float32),
        "labels": labels.astype(np.int32),
        "mel_lengths": enc_len.astype(np.int32),
        "label_lengths": np.full(n_utts, tones_per_utt, np.int32),
    }


class TonesSampler:
    """Fresh-utterance batch sampler: every batch is NEW audio.

    Why this exists (a measured finding): training on a fixed pre-rendered
    pool collapses. The RNN-T lattice teacher-forces label prefixes, so
    with a small pool the prediction network can IDENTIFY the utterance
    from its first 2-3 labels and recall the rest -- train loss drops to
    ~(first-token entropy) while the encoder receives no useful gradient
    and converges to an input-INDEPENDENT function (measured: trained
    encoder batch-wise std 1.2e-4 vs 0.12 at init; every utterance decodes
    to the same fixed sequence). With fresh labels every step the
    unconditional label entropy (U * log n_tones) is a hard floor for any
    audio-ignoring model, so every nat below it must come through the
    encoder.

    Same static shapes as `make_dataset` (nemotron_tpu/utils/tones.py:
    121-244); mel through the port's StreamingPreprocessor on `device`.
    One sampler instance is single-threaded -- create one per prefetch
    worker.
    """

    def __init__(self, filterbank: np.ndarray, window: np.ndarray,
                 n_mels: int, n_tones: int, tones_per_utt: int, batch: int,
                 seed: int = 0,
                 dur_range: tuple[float, float] = (0.20, 0.32),
                 tones_per_utt_min: int | None = None,
                 history_max: int = 0,
                 long_gap_prob: float = 0.0,
                 long_gap_range: tuple[float, float] = (0.5, 2.0),
                 max_long_gaps: int = 2, device="cuda"):
        from ..config import PreprocessorConfig
        from ..frontend.preprocessor import StreamingPreprocessor

        self.n_tones = n_tones
        self.tones_per_utt = tones_per_utt
        # Variable utterance length (measured): with a FIXED count
        # the prediction network learns "after exactly U tokens, always
        # blank" and the model falls silent at U tokens on the continuous
        # eval streams (measured: exactly 10/stream emitted over 60 s,
        # TER 94%). Drawing U_i ~ Uniform[min, U] per utterance removes
        # the count cue; label_lengths masks the unused label slots.
        self.tones_per_utt_min = (tones_per_utt if tones_per_utt_min is None
                                  else tones_per_utt_min)
        assert 1 <= self.tones_per_utt_min <= tones_per_utt
        # Decoder-history warm-up (measured): variable utterance
        # length alone only MOVES the count cliff to U_max -- the trained
        # model transcribed a continuous stream perfectly for exactly
        # U_max tokens, then fell silent forever (the LSTM prediction
        # network learns absolute emission count). history_max > 0 adds
        # R ~ {0, 64, ..., history_max} random warm-up labels per STEP
        # (training.prediction_network consumes them before the utterance)
        # so P(emit | count) is flat over the whole serving range. R is
        # constant within a step (static shapes; one program per R).
        self.history_max = history_max
        assert history_max % 64 == 0, "history_max must be a multiple of 64"
        # Silence augmentation: with probability long_gap_prob per
        # CANDIDATE slot (up to max_long_gaps random positions per
        # utterance, which may include the position after the last tone =
        # trailing silence), the post-tone gap is drawn from
        # long_gap_range instead of GAP_RANGE. A model trained only on
        # 50-90 ms gaps has never seen silence and degenerates on it
        # (measured: an earlier tones_tiny fixture emits a "T8 T12 ..."
        # loop through 3 s of silence); long gaps teach "silence ->
        # blank", the property utterance endpointing needs.
        assert 0.0 <= long_gap_prob <= 1.0
        self.long_gap_prob = long_gap_prob
        self.long_gap_range = long_gap_range
        self.max_long_gaps = max_long_gaps
        self.batch = batch
        self.dur_range = dur_range
        self.n_samples = int((dur_range[1] + GAP_RANGE[1]) * tones_per_utt
                             * SAMPLE_RATE) + 400
        if long_gap_prob > 0:
            self.n_samples += int(max_long_gaps * long_gap_range[1]
                                  * SAMPLE_RATE)
        self._pre = StreamingPreprocessor(
            filterbank, window, n_streams=batch,
            cfg=PreprocessorConfig(n_mels=n_mels), device=device)
        self._seed = seed

    def sample(self, step: int) -> dict:
        """Deterministic-in-(seed, step) fresh batch, same dict layout as
        make_dataset."""
        rng = np.random.default_rng([self._seed, step])
        B, U = self.batch, self.tones_per_utt
        u_lens = rng.integers(self.tones_per_utt_min, U + 1, B)
        labels = rng.integers(0, self.n_tones, (B, U))
        durs = rng.uniform(*self.dur_range, (B, U))
        gaps = rng.uniform(*GAP_RANGE, (B, U))
        # zero out slots past each utterance's length: render stops there
        # and the loss masks them via label_lengths
        live = np.arange(U)[None, :] < u_lens[:, None]
        durs = durs * live
        gaps = gaps * live
        if self.long_gap_prob > 0:
            for i in range(B):
                cand = rng.choice(u_lens[i],
                                  size=min(self.max_long_gaps, u_lens[i]),
                                  replace=False)
                take = rng.random(cand.size) < self.long_gap_prob
                if take.any():
                    gaps[i, cand[take]] = rng.uniform(
                        *self.long_gap_range, int(take.sum()))
        audio = np.stack([
            render_tones(labels[i, :u_lens[i]], durs[i], rng, self.n_tones,
                         self.n_samples, gaps=gaps[i]) for i in range(B)])
        self._pre.reset()
        mel = self._pre.process(audio)
        sig = ((durs + gaps).sum(axis=1) * SAMPLE_RATE).astype(np.int64)
        mel_valid = np.minimum(sig // 160 + 1, mel.shape[1])
        out = {
            "mel": np.asarray(mel, np.float32),
            "labels": labels.astype(np.int32),
            "mel_lengths": np.array([enc_frames_of_mel(int(t))
                                     for t in mel_valid], np.int32),
            "label_lengths": u_lens.astype(np.int32),
        }
        if self.history_max:
            R = int(rng.integers(0, self.history_max // 64 + 1)) * 64
            if R:
                out["history"] = rng.integers(0, self.n_tones,
                                              (B, R)).astype(np.int32)
        return out


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
