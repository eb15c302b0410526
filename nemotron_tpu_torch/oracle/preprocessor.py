"""Stateful numpy mel-frontend oracle (the port's own copy of
`nemotron_tpu/oracle/preprocessor.py`).

Exact structural mirror of reference src/preprocessor.cpp:330-395:
i16 -> f32 scale 1/32768, pre-emphasis 0.97 with `last_sample` carried across
calls, center-pad emulation via an initial n_fft/2-zero buffer, Hann(400)
window zero-padded to 512, 512-pt FFT (np.fft.rfft here instead of the radix-2
loop -- identical math, float64 accumulate), power spectrum, mel filterbank
matmul, log(x + 2^-24), and ring-buffer carry-over of unconsumed samples.
"""

from __future__ import annotations

import numpy as np

from ..config import PreprocessorConfig


class OraclePreprocessor:
    def __init__(self, filterbank: np.ndarray, window: np.ndarray,
                 cfg: PreprocessorConfig = PreprocessorConfig()):
        self.cfg = cfg
        assert filterbank.shape == (cfg.n_mels, cfg.n_freqs)
        assert window.shape == (cfg.n_window_size,)
        self.filterbank = filterbank.astype(np.float32)
        pad = (cfg.n_fft - cfg.n_window_size) // 2
        self.window = np.zeros(cfg.n_fft, dtype=np.float32)
        self.window[pad : pad + cfg.n_window_size] = window
        self.reset()

    def reset(self) -> None:
        self.last_sample = 0.0
        self.audio_buf = np.zeros(self.cfg.initial_pad, dtype=np.float32)

    def n_frames_for(self, n_new_samples: int) -> int:
        avail = self.audio_buf.size + n_new_samples
        if avail < self.cfg.n_fft:
            return 0
        return (avail - self.cfg.n_fft + self.cfg.n_window_stride) // self.cfg.n_window_stride

    def process(self, audio_i16: np.ndarray) -> np.ndarray:
        """audio_i16: int16 samples. Returns mel [n_frames, n_mels] f32."""
        cfg = self.cfg
        if audio_i16.size == 0:
            return np.zeros((0, cfg.n_mels), dtype=np.float32)
        n_frames = self.n_frames_for(audio_i16.size)

        x = audio_i16.astype(np.float32) / 32768.0
        prev = np.concatenate([[np.float32(self.last_sample)], x[:-1]])
        emph = x - np.float32(cfg.preemph) * prev
        self.last_sample = float(x[-1])
        self.audio_buf = np.concatenate([self.audio_buf, emph])

        if n_frames == 0:
            return np.zeros((0, cfg.n_mels), dtype=np.float32)

        hop, n_fft = cfg.n_window_stride, cfg.n_fft
        frames = np.stack([self.audio_buf[t * hop : t * hop + n_fft]
                           for t in range(n_frames)])
        frames = frames * self.window
        spec = np.fft.rfft(frames.astype(np.float64), n=n_fft, axis=-1)
        power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
        mel = power @ self.filterbank.T.astype(np.float32)
        mel = np.log(mel + np.float32(cfg.log_zero_guard))

        self.audio_buf = self.audio_buf[n_frames * hop :]
        assert self.audio_buf.size < n_fft
        return mel.astype(np.float32)
