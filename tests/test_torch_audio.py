"""The port's inputs and CLIs against the JAX package's on the CPU: WAV and
PCM decoding (resampled rates, stereo, float32), the tones task's audio and
labels, the batch CLI's stdout against `cli/transcribe.py --cpu` and the
streaming CLI's on a WAV against `cli/transcribe_stream.py --cpu`, and the
batch CLI's refusals of flags that come with later slices."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from nemotron_tpu.utils import audio as jaudio
from nemotron_tpu.utils import tones as jtones
from nemotron_tpu_torch import cli_transcribe
from nemotron_tpu_torch.utils import audio as taudio
from nemotron_tpu_torch.utils import tones as ttones

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")


def wav_bytes(samples: np.ndarray, rate: int, fmt: int = 1) -> bytes:
    """A RIFF/WAV file: PCM16 (fmt 1) or IEEE float32 (fmt 3); samples
    [N] or [N, channels], with an odd-sized chunk before the data chunk."""
    ch = 1 if samples.ndim == 1 else samples.shape[1]
    bits = 16 if fmt == 1 else 32
    data = samples.astype("<i2" if fmt == 1 else "<f4").tobytes()
    fmt_chunk = struct.pack("<HHIIHH", fmt, ch, rate, rate * ch * bits // 8,
                            ch * bits // 8, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
            + b"LIST" + struct.pack("<I", 3) + b"abc\0"
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def tone_audio(seconds=3.0, seed=3):
    audio, _ = jtones.make_eval_streams(1, seconds, 16, seed=seed)
    return audio[0]


@pytest.mark.parametrize("rate", [16000, 8000, 44100])
def test_read_pcm16_wav_matches_jax(rate):
    x = tone_audio(1.0)[: rate // 2]
    data = wav_bytes(x, rate)
    got = taudio.read_audio_bytes(data)
    np.testing.assert_array_equal(got, jaudio.read_audio_bytes(data))
    assert got.dtype == np.int16
    assert abs(got.size - x.size * 16000 / rate) <= 1
    if rate == 16000:
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("fmt", [1, 3])
def test_read_stereo_and_float_wav_matches_jax(fmt):
    x = tone_audio(0.5).astype(np.float64)
    stereo = np.stack([x, -0.5 * x], axis=1)
    if fmt == 3:
        stereo = stereo / 32768.0
    data = wav_bytes(stereo, 22050, fmt)
    got = taudio.read_audio_bytes(data)
    np.testing.assert_array_equal(got, jaudio.read_audio_bytes(data))
    assert got.dtype == np.int16 and got.size > 0


def test_read_raw_pcm_and_files(tmp_path):
    x = tone_audio(0.5)
    np.testing.assert_array_equal(taudio.read_audio_bytes(x.tobytes()), x)
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(x, 16000))
    np.testing.assert_array_equal(taudio.read_audio_file(str(path)), x)
    np.testing.assert_array_equal(taudio.resample_i16(x, 16000, 16000), x)


def test_malformed_and_unsupported_wav_raise():
    with pytest.raises(ValueError, match="malformed"):
        taudio.read_audio_bytes(b"RIFF\0\0\0\0WAVEjunk")
    with pytest.raises(ValueError, match="unsupported WAV"):
        taudio.read_audio_bytes(wav_bytes(np.zeros(8), 16000, fmt=6))


def test_render_tones_matches_jax():
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    labels, durs = [3, 0, 15, 7], [0.2, 0.25, 0.31, 0.22]
    gaps = [0.05, 0.07, 0.06, 0.09]
    want = jtones.render_tones(labels, durs, rng_j, 16, 16000, gaps=gaps)
    got = ttones.render_tones(labels, durs, rng_t, 16, 16000, gaps=gaps)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int16 and np.abs(got).max() > 5000
    np.testing.assert_array_equal(ttones.tone_frequencies(16),
                                  jtones.tone_frequencies(16))
    assert [ttones.enc_frames_of_mel(t) for t in (0, 7, 1600)] == \
        [jtones.enc_frames_of_mel(t) for t in (0, 7, 1600)] == [1, 2, 201]


@pytest.mark.parametrize("markov", [False, True])
def test_make_eval_streams_matches_jax(markov):
    kw = {}
    if markov:
        trans = ttones.grammar_transitions(16)
        np.testing.assert_array_equal(trans, jtones.grammar_transitions(16))
        kw["label_sampler"] = lambda rng, n: ttones.markov_labels(rng, n,
                                                                 trans)
    want = jtones.make_eval_streams(3, 4.0, 16, seed=123,
                                    return_onsets=True, **kw)
    got = ttones.make_eval_streams(3, 4.0, 16, seed=123, return_onsets=True,
                                   **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int16 and got[0].shape == (3, 64000)
    assert got[1] == want[1] and got[2] == want[2]
    assert min(len(t) for t in got[1]) > 10


def run_cli(args, stdin=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *args], input=stdin,
                       capture_output=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()
    return r


@pytest.fixture(scope="module")
def audio_files(tmp_path_factory):
    """One raw PCM file, a 16 kHz WAV and an 8 kHz WAV (seeded tones)."""
    d = tmp_path_factory.mktemp("audio")
    pcm, wav16, wav8 = d / "a.pcm", d / "b.wav", d / "c.wav"
    tone_audio(3.0, seed=3).astype("<i2").tofile(pcm)
    wav16.write_bytes(wav_bytes(tone_audio(4.0, seed=4), 16000))
    wav8.write_bytes(wav_bytes(tone_audio(5.0, seed=5)[::2], 8000))
    return str(pcm), str(wav16), str(wav8)


@pytest.mark.parametrize("files,flags", [
    ((0,), []), ((1, 2), []), ((0,), ["--timestamps"]),
    ((0, 1, 2), ["--timestamps"])])
def test_batch_cli_stdout_matches_jax_cli(audio_files, files, flags):
    paths = [audio_files[i] for i in files]
    want = run_cli([os.path.join(REPO, "cli", "transcribe.py"), FIXTURE,
                    *paths, "--cpu", *flags])
    got = run_cli(["-m", "nemotron_tpu_torch.cli_transcribe", FIXTURE,
                   *paths, "--cpu", *flags])
    assert got.stdout.decode() == want.stdout.decode()
    lines = got.stdout.decode().splitlines()
    assert len(lines) == len(paths)
    assert all(len(line) > 20 for line in lines)
    assert ("{" in lines[0]) == ("--timestamps" in flags)
    if len(paths) > 1:
        assert lines[1].startswith(paths[1] + "\t")
    assert "RTF" in got.stderr.decode()


def test_stream_cli_reads_wav_as_the_jax_cli(audio_files):
    """An 8 kHz WAV, decoded and resampled, then streamed."""
    want = run_cli([os.path.join(REPO, "cli", "transcribe_stream.py"),
                    FIXTURE, audio_files[2], "80", "1", "--cpu"])
    got = run_cli(["-m", "nemotron_tpu_torch.cli", FIXTURE, audio_files[2],
                   "80", "1", "--cpu"])
    assert got.stdout.decode() == want.stdout.decode()
    assert len(got.stdout.decode().strip()) > 10


@pytest.mark.parametrize("flag,slice_name", [("--ctc", "TDT/CTC")])
def test_batch_cli_refuses_later_flags(capsys, flag, slice_name):
    """The TDT/CTC slice's --ctc is ported (tests/test_torch_ctc.py holds
    it to the JAX CLI): it is taken, and a missing model is the first
    error."""
    assert cli_transcribe.main(["t", "missing.gguf", "a.pcm", flag]) == 1
    err = capsys.readouterr().err
    assert "model file not found" in err
    assert "slice" not in err and "unsupported flag" not in err


@pytest.mark.parametrize("flags,want", [
    (["--bogus"], "unsupported flag --bogus"),
    (["--cpu", "--cuda"], "--cpu and --cuda"),
    (["--cuda", "--timestamps"], "model file not found"),
    (["--metal"], "warning: --metal is not a backend of this port; using "
                  "the CUDA card")])
def test_batch_cli_device_and_unknown_flags(capsys, flags, want):
    assert cli_transcribe.main(["t", "missing.gguf", "a.pcm", *flags]) == 1
    assert want in capsys.readouterr().err


def test_batch_cli_usage(capsys):
    assert cli_transcribe.main(["t", FIXTURE]) == 1
    assert "[--cpu|--cuda|--metal|--tpu] [--timestamps]" in \
        capsys.readouterr().err
