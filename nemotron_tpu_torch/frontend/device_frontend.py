"""Mel frontend on the device: the whole DSP chain as batched tensor ops.

The port's counterpart of `nemotron_tpu/frontend/device_frontend.py`,
with its host wrapper `DeviceFrontend`. The host frontend
(`preprocessor.py`) frames on the host and ships f32 windows; here the
caller ships raw int16 PCM (6.4x fewer bytes) and the scaling,
pre-emphasis, framing, window, rFFT, mel matmul and log run on the device,
batched over all streams. The serving engines run it inside their ticks,
ahead of the encoder.

Numerics as the reference chain (src/preprocessor.cpp:46-57, 220-222,
296-299, 363-383): i16/32768 scaling, pre-emphasis 0.97 with a cross-call
carry, center-pad emulation through an initial n_fft/2-zero residue,
Hann(400) zero-padded to 512, power spectrum, log(x + 2^-24).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import PreprocessorConfig
from ..device import resolve_device
from .preprocessor import mel_spectrogram, pad_window


@dataclasses.dataclass
class FrontendState:
    """Per-stream DSP carry on the device. The residue length is fixed for
    a given feed size once the first call has run."""

    last_sample: Any   # [S] f32 pre-emphasis carry
    residue: Any       # [S, R] f32 unconsumed pre-emphasized samples


def init_frontend_state(n_streams: int, device,
                        cfg: PreprocessorConfig = PreprocessorConfig()
                        ) -> FrontendState:
    """Center-pad emulation: n_fft/2 zeros of history
    (reference src/preprocessor.cpp:220-222)."""
    return FrontendState(
        last_sample=torch.zeros((n_streams,), dtype=torch.float32,
                                device=device),
        residue=torch.zeros((n_streams, cfg.initial_pad),
                            dtype=torch.float32, device=device))


def frames_after(residue_len: int, n_new: int,
                 cfg: PreprocessorConfig = PreprocessorConfig()) -> int:
    """How many mel frames one step emits (host-side, deterministic)."""
    avail = residue_len + n_new
    if avail < cfg.n_fft:
        return 0
    return (avail - cfg.n_fft) // cfg.n_window_stride + 1


def residue_after(residue_len: int, n_new: int,
                  cfg: PreprocessorConfig = PreprocessorConfig()) -> int:
    """Residue length after one step (host-side, deterministic)."""
    nf = frames_after(residue_len, n_new, cfg)
    return residue_len + n_new - nf * cfg.n_window_stride


def mel_frontend_step(pcm_i16: torch.Tensor, state: FrontendState,
                      window: torch.Tensor, filterbank: torch.Tensor,
                      cfg: PreprocessorConfig = PreprocessorConfig()):
    """One batched DSP step on pcm_i16's device.

    pcm_i16: [S, N] int16. window: [n_fft] f32 (already padded).
    filterbank: [n_mels, n_freqs] f32.
    Returns (log_mel [S, F, n_mels] f32, new FrontendState) with
    F = frames_after(state.residue.shape[1], N)."""
    S, N = pcm_i16.shape
    R = state.residue.shape[1]
    hop, n_fft = cfg.n_window_stride, cfg.n_fft

    x = pcm_i16.to(torch.float32) / 32768.0
    prev = torch.cat([state.last_sample[:, None], x[:, :-1]], dim=1)
    emph = x - torch.tensor(cfg.preemph, dtype=torch.float32) * prev
    buf = torch.cat([state.residue, emph], dim=1)                 # [S, R+N]
    n_frames = frames_after(R, N, cfg)
    new_state = FrontendState(last_sample=x[:, -1],
                              residue=buf[:, n_frames * hop:])
    if n_frames == 0:
        return (torch.zeros((S, 0, cfg.n_mels), dtype=torch.float32,
                            device=buf.device), new_state)
    frames = buf.unfold(-1, n_fft, hop)                   # [S, F, n_fft]
    return (mel_spectrogram(frames, window, filterbank, cfg.log_zero_guard),
            new_state)


class DeviceFrontend:
    """Host wrapper with the StreamingPreprocessor interface (process /
    reset / n_frames_for / state_dict), for direct use and differential
    testing; the lockstep engine calls `mel_frontend_step` inside its tick
    instead. Runs on `device`: the card unless the caller asks for the
    CPU."""

    def __init__(self, filterbank: np.ndarray, window: np.ndarray,
                 n_streams: int = 1,
                 cfg: PreprocessorConfig = PreprocessorConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_streams = n_streams
        self.filterbank = torch.from_numpy(
            np.asarray(filterbank, np.float32)).to(self.device)
        self.window = torch.from_numpy(pad_window(
            np.asarray(window, np.float32), cfg.n_fft)).to(self.device)
        self.reset()

    def reset(self) -> None:
        self.state = init_frontend_state(self.n_streams, self.device,
                                         self.cfg)

    def n_frames_for(self, n_new: int) -> int:
        return frames_after(self.state.residue.shape[1], n_new, self.cfg)

    def state_dict(self) -> dict:
        """The DSP carry as numpy copies."""
        return {"last_sample": self.state.last_sample.cpu().numpy().copy(),
                "residue": self.state.residue.cpu().numpy().copy()}

    def load_state_dict(self, st: dict) -> None:
        self.state = FrontendState(**{
            k: torch.tensor(np.asarray(st[k], np.float32),
                            device=self.device)
            for k in ("last_sample", "residue")})

    def process(self, audio_i16: np.ndarray) -> np.ndarray:
        """audio_i16: [S, N] (or [N] for one stream) int16, N any size.
        Returns log-mel [S, n_frames, n_mels] (or [n_frames, n_mels]) f32
        numpy; n_frames may be 0."""
        squeeze = audio_i16.ndim == 1
        if squeeze:
            audio_i16 = audio_i16[None]
        pcm = torch.from_numpy(np.ascontiguousarray(audio_i16, np.int16))
        mel, self.state = mel_frontend_step(pcm.to(self.device), self.state,
                                            self.window, self.filterbank,
                                            self.cfg)
        out = mel.cpu().numpy()
        return out[0] if squeeze else out
