"""Mel frontend on the device: the whole DSP chain as batched tensor ops.

The port's counterpart of `nemotron_tpu/frontend/device_frontend.py`
(without its host wrapper `DeviceFrontend`). The host frontend
(`preprocessor.py`) frames on the host and ships f32 windows; here the
caller ships raw int16 PCM (6.4x fewer bytes) and the scaling,
pre-emphasis, framing, window, rFFT, mel matmul and log run on the device,
batched over all streams. The serving engine runs it inside its tick, ahead
of the encoder.

Numerics as the reference chain (src/preprocessor.cpp:46-57, 220-222,
296-299, 363-383): i16/32768 scaling, pre-emphasis 0.97 with a cross-call
carry, center-pad emulation through an initial n_fft/2-zero residue,
Hann(400) zero-padded to 512, power spectrum, log(x + 2^-24).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import PreprocessorConfig
from .preprocessor import mel_spectrogram


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
