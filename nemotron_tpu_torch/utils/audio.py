"""Audio input: raw s16le PCM (the reference's only input format) plus
RIFF/WAV decoding with resampling and float32 support.

The port's own copy of `nemotron_tpu/utils/audio.py` (numpy, struct and
scipy only). Any PCM16 or IEEE-float32 WAV at any sample rate decodes
directly: polyphase resampling to 16 kHz, stereo averaged to mono."""

from __future__ import annotations

import struct
from math import gcd

import numpy as np


def resample_i16(samples: np.ndarray, rate: int, target: int) -> np.ndarray:
    """Polyphase-resample int16 PCM from `rate` to `target` Hz."""
    if rate == target:
        return samples
    try:
        from scipy.signal import resample_poly
    except ImportError as e:
        raise ValueError(
            f"sample rate {rate} != required {target} and scipy is not "
            "available for resampling; resample first (e.g. ffmpeg -ar "
            f"{target})") from e

    g = gcd(rate, target)
    y = resample_poly(samples.astype(np.float32), target // g, rate // g)
    return np.clip(np.round(y), -32768, 32767).astype(np.int16)


def read_audio_bytes(data: bytes, expect_rate: int = 16000) -> np.ndarray:
    """Decode a whole audio buffer: WAV if it has a RIFF header, otherwise
    raw s16le."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return _decode_wav(data, expect_rate)
    return np.frombuffer(data, dtype="<i2")


def read_audio_file(path: str, expect_rate: int = 16000) -> np.ndarray:
    with open(path, "rb") as f:
        return read_audio_bytes(f.read(), expect_rate)


def _decode_wav(data: bytes, expect_rate: int) -> np.ndarray:
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("malformed WAV: missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == 1 and bits == 16:            # integer PCM16
        samples = np.frombuffer(pcm, dtype="<i2")
        if channels > 1:
            samples = samples.reshape(-1, channels).mean(axis=1) \
                .astype(np.int16)
    elif audio_fmt == 3 and bits == 32:          # IEEE float32
        f = np.frombuffer(pcm, dtype="<f4")
        if channels > 1:
            f = f.reshape(-1, channels).mean(axis=1)
        samples = np.clip(np.round(f * 32767.0), -32768,
                          32767).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV: format={audio_fmt} bits={bits} "
                         "(need PCM16 or IEEE float32)")
    return resample_i16(samples, rate, expect_rate)
