"""Mel-spectrogram frontend.

The port's counterpart of `nemotron_tpu/frontend/preprocessor.py` with the
numpy host backend:
  - HOST (numpy): i16 -> f32 scaling, pre-emphasis with cross-call carry,
    residue buffering, framing into [n_frames, n_fft] windows.
  - DEVICE (torch, on the session's device): window multiply, 512-point
    rFFT, power spectrum, mel filterbank matmul, log.

Numerics mirror reference src/preprocessor.cpp:330-395 (pre-emphasis 0.97
carrying last_sample, center-pad emulation via an initial n_fft/2-zero
buffer, Hann(400) zero-padded to 512, power spectrum, log(x + 2^-24)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PreprocessorConfig
from ..device import resolve_device


def mel_spectrogram(frames: torch.Tensor, window: torch.Tensor,
                    filterbank: torch.Tensor,
                    log_zero_guard: float = 2.0 ** -24) -> torch.Tensor:
    """frames: [..., n_frames, n_fft] f32 (pre-emphasized and framed);
    window: [n_fft]; filterbank: [n_mels, n_freqs].
    Returns log-mel [..., n_frames, n_mels] f32."""
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ filterbank.T
    return torch.log(mel + np.float32(log_zero_guard).item())


def pad_window(window: np.ndarray, n_fft: int) -> np.ndarray:
    """Zero-pad the analysis window to n_fft, centered
    (reference src/preprocessor.cpp:296-299)."""
    pad = (n_fft - window.shape[0]) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[pad:pad + window.shape[0]] = window
    return out


def hann_window(n: int) -> np.ndarray:
    """Symmetric Hann (torch.hann_window(n, periodic=False))."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))).astype(
        np.float32)


def mel_filterbank_slaney(n_mels: int = 128, n_fft: int = 512,
                          sample_rate: int = 16000, fmin: float = 0.0,
                          fmax: float | None = None) -> np.ndarray:
    """Slaney-style mel filterbank (librosa.filters.mel(htk=False,
    norm='slaney')), the construction NeMo's FilterbankFeatures uses
    (nemotron_tpu/frontend/preprocessor.py:53-95). Only needed without a
    GGUF: the tones training task builds its frontend with it, and the
    saved GGUF then carries it (reference src/nemo-ggml.cpp:354-356)."""
    if fmax is None:
        fmax = sample_rate / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mel = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        freqs)

    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


class StreamingPreprocessor:
    """Stateful PCM -> log-mel for S parallel streams. All S streams advance
    by the same number of samples per call. The FFT runs on `device`: the
    card unless the caller asks for the CPU."""

    def __init__(self, filterbank, window, n_streams: int = 1,
                 cfg: PreprocessorConfig = PreprocessorConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        fb = np.asarray(filterbank, np.float32)
        if fb.shape != (cfg.n_mels, cfg.n_freqs):
            raise ValueError(f"filterbank {fb.shape} != "
                             f"{(cfg.n_mels, cfg.n_freqs)}")
        self.filterbank = torch.from_numpy(fb).to(self.device)
        self.window = torch.from_numpy(pad_window(
            np.asarray(window, np.float32), cfg.n_fft)).to(self.device)
        self.n_streams = n_streams
        self.reset()

    def reset(self, stream: int | None = None) -> None:
        if stream is None:
            self.last_sample = np.zeros(self.n_streams, np.float32)
            self.residue = np.zeros((self.n_streams, self.cfg.initial_pad),
                                    np.float32)
        else:
            # keep the shared residue length; the reset stream behaves as if
            # it had been hearing silence
            self.last_sample[stream] = 0.0
            self.residue[stream, :] = 0.0

    def state_dict(self) -> dict:
        """The DSP state, for a session snapshot (numpy copies)."""
        return {"last_sample": self.last_sample.copy(),
                "residue": self.residue.copy()}

    def load_state_dict(self, state: dict) -> None:
        self.last_sample = np.asarray(state["last_sample"],
                                      np.float32).copy()
        self.residue = np.asarray(state["residue"], np.float32).copy()

    def n_frames_for(self, n_new_samples: int) -> int:
        avail = self.residue.shape[1] + n_new_samples
        if avail < self.cfg.n_fft:
            return 0
        return (avail - self.cfg.n_fft) // self.cfg.n_window_stride + 1

    def frame_only(self, audio_i16: np.ndarray) -> np.ndarray:
        """Host state update and framing without the spectral half: returns
        pre-emphasized frames [S, n_frames, n_fft] f32 numpy, for a caller
        that runs one `spectral` pass over many preprocessors' frames (the
        serving engine: one FFT call a tick, not one a slot)."""
        cfg = self.cfg
        if audio_i16.ndim == 1:
            audio_i16 = audio_i16[None]
        S, N = audio_i16.shape
        if S != self.n_streams:
            raise ValueError(f"{S} streams of audio for {self.n_streams}")

        x = audio_i16.astype(np.float32) / 32768.0
        prev = np.concatenate([self.last_sample[:, None], x[:, :-1]], axis=1)
        emph = x - np.float32(cfg.preemph) * prev
        self.last_sample = x[:, -1].copy()
        buf = np.concatenate([self.residue, emph], axis=1)

        n_frames = self.n_frames_for(N)
        if n_frames == 0:
            self.residue = buf
            return np.zeros((S, 0, cfg.n_fft), np.float32)
        hop, n_fft = cfg.n_window_stride, cfg.n_fft
        idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        frames = buf[:, idx]                      # [S, n_frames, n_fft]
        self.residue = buf[:, n_frames * hop:]
        return frames

    def spectral(self, frames: np.ndarray) -> np.ndarray:
        """The spectral half of `process`: frames [..., n_fft] f32 ->
        log-mel [..., n_mels] f32 numpy, through `torch.fft` on the
        preprocessor's device."""
        mel = mel_spectrogram(torch.from_numpy(frames).to(self.device),
                              self.window, self.filterbank,
                              self.cfg.log_zero_guard)
        return mel.cpu().numpy().astype(np.float32)

    def process(self, audio_i16: np.ndarray) -> np.ndarray:
        """audio_i16: [S, N] (or [N] if n_streams == 1) int16.
        Returns log-mel [S, n_frames, n_mels] f32 numpy (n_frames may be 0)."""
        frames = self.frame_only(audio_i16)
        if frames.shape[1] == 0:
            return np.zeros((frames.shape[0], 0, self.cfg.n_mels), np.float32)
        return self.spectral(frames)
