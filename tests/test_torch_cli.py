"""The port's streaming CLI on the CPU: the reference's device flags
(`[--cpu|--cuda|--metal]`, src/transcribe_stream.cpp:27-36). `--cuda` asks
for the card, which is the default; `--metal` and `--tpu` warn and run on
the card, as the JAX CLI warns (cli/transcribe_stream.py:59-62); `--cpu`
with `--cuda` is refused. A missing model shows that the flags were taken
before any device was touched. Then both CLIs' --timestamps, --confidence
and --srt/--vtt against the JAX CLIs (stdout and subtitle files byte for
byte), and the flags that come with later slices."""

import os
import subprocess
import sys

import pytest

from nemotron_tpu_torch import cli, cli_transcribe
from nemotron_tpu_torch.utils import tones as ttones


@pytest.mark.parametrize("flags", [["--cuda"], ["--cuda", "--kv-int8"],
                                   ["--quantize=w8a8", "--cuda"]])
def test_cuda_flag_is_accepted(capsys, flags):
    assert cli.main(["cli", "missing.gguf", "a.pcm", *flags]) == 1
    err = capsys.readouterr().err
    assert "model file not found: missing.gguf" in err
    assert "unsupported flag" not in err and "warning" not in err


@pytest.mark.parametrize("flag", ["--metal", "--tpu"])
def test_other_backends_warn_and_run_on(capsys, flag):
    assert cli.main(["cli", "missing.gguf", "a.pcm", "80", "13", flag]) == 1
    err = capsys.readouterr().err
    assert f"warning: {flag} is not a backend of this port" in err
    assert "using the CUDA card" in err
    assert "model file not found" in err


@pytest.mark.parametrize("flag", ["--metal", "--tpu"])
def test_other_backends_with_cpu_name_the_cpu(capsys, flag):
    assert cli.main(["cli", "missing.gguf", "a.pcm", "--cpu", flag]) == 1
    err = capsys.readouterr().err
    assert f"warning: {flag} is not a backend of this port; using the CPU" in err
    assert "CUDA card" not in err
    assert "model file not found" in err


def test_cpu_and_cuda_together_are_refused(capsys):
    assert cli.main(["cli", "missing.gguf", "a.pcm", "--cpu", "--cuda"]) == 1
    err = capsys.readouterr().err
    assert "--cpu and --cuda" in err
    assert "model file not found" not in err


def test_usage_names_the_device_flags(capsys):
    assert cli.main(["cli"]) == 1
    assert "[--cpu|--cuda|--metal|--tpu]" in capsys.readouterr().err


# -- timestamps, confidence and subtitles, against the JAX CLIs ---------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "tones_tiny.gguf")


def run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       timeout=300, env=env, cwd=cwd)
    assert r.returncode == 0, r.stderr.decode()
    return r


@pytest.fixture(scope="module")
def tone_files(tmp_path_factory):
    """Two seeded tone recordings (raw PCM), 6 s and 4 s."""
    d = tmp_path_factory.mktemp("tones")
    audio, _ = ttones.make_eval_streams(2, 6.0, 16, seed=91)
    paths = [d / "a.pcm", d / "b.pcm"]
    audio[0].astype("<i2").tofile(paths[0])
    audio[1, :64000].astype("<i2").tofile(paths[1])
    return [str(p) for p in paths]


@pytest.mark.parametrize("R,flags,sub", [
    ("6", ["--timestamps", "--confidence"], "vtt"),
    ("0", ["--confidence"], "srt")])
def test_stream_cli_subtitles_match_jax_cli(tmp_path, tone_files, R, flags,
                                            sub):
    """Stdout ({sec} and {p=...} annotations) and the subtitle file are
    byte-equal to cli/transcribe_stream.py --cpu's."""
    out = {}
    for name, cmd in (
            ("jax", [os.path.join(REPO, "cli", "transcribe_stream.py")]),
            ("torch", ["-m", "nemotron_tpu_torch.cli"])):
        path = tmp_path / f"{name}.{sub}"
        r = run([*cmd, FIXTURE, tone_files[0], "80", R, "--cpu", *flags,
                 f"--{sub}={path}"], REPO)
        out[name] = (r.stdout, path.read_bytes())
        assert f"cues to {path}" in r.stderr.decode()
    assert out["torch"] == out["jax"]
    text = out["torch"][0].decode()
    assert "{p=" in text and ("{0." in text) == ("--timestamps" in flags)
    assert b" --> " in out["torch"][1]


@pytest.mark.parametrize("files,flags", [
    ((0, 1), ["--confidence", "--srt"]),
    ((1,), ["--timestamps", "--confidence", "--vtt=FILE"]),
    ((0,), ["--vtt"])])
def test_batch_cli_subtitles_match_jax_cli(tmp_path, tone_files, files,
                                           flags):
    """Stdout and every subtitle file (next to each input, or =FILE) are
    byte-equal to cli/transcribe.py --cpu's."""
    out = {}
    for name, cmd in (("jax", [os.path.join(REPO, "cli", "transcribe.py")]),
                      ("torch", ["-m", "nemotron_tpu_torch.cli_transcribe"])):
        d = tmp_path / name
        d.mkdir()
        paths = []
        for i in files:
            paths.append(str(d / os.path.basename(tone_files[i])))
            with open(tone_files[i], "rb") as src, open(paths[-1], "wb") as f:
                f.write(src.read())
        args = [f.replace("FILE", str(d / "out.vtt")) for f in flags]
        r = run([*cmd, FIXTURE, *paths, "--cpu", *args], d)
        subs = sorted(p for p in os.listdir(d) if p.endswith((".srt",
                                                              ".vtt")))
        out[name] = (r.stdout.decode().replace(str(d), "D"), subs,
                     [(d / p).read_bytes() for p in subs])
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) == len(files)
    assert ("{p=" in out["torch"][0]) == ("--confidence" in flags)
    assert all(b" --> " in body for body in out["torch"][2])


@pytest.mark.parametrize("flags,want", [
    (["--srt"], "requires --srt=FILE"),
    (["--srt=a.srt", "--vtt=b.vtt"], "mutually exclusive")])
def test_stream_cli_refuses_bad_subtitle_flags(capsys, flags, want):
    assert cli.main(["cli", FIXTURE, "a.pcm", "--cpu", *flags]) == 1
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("flags,want", [
    (["--srt=a.srt"], "take one audio file"),
    (["--srt", "--vtt"], "mutually exclusive")])
def test_batch_cli_refuses_bad_subtitle_flags(capsys, flags, want):
    assert cli_transcribe.main(["t", FIXTURE, "a.pcm", "b.pcm", "--cpu",
                                *flags]) == 1
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("flag,slice_name", [
    ("--ctc", "TDT/CTC"), ("--kv-int4", "quant-tiers"),
    ("--rc-by-layer=13,6,1,0", "quant-tiers"),
    ("--quantize=w8a8-sq-static", "quant-tiers"),
    ("--calib=x.pcm", "quant-tiers"),
    ("--trace=d", "utils and native-bindings"),
    ("--profile=d", "utils and native-bindings")])
def test_stream_cli_refuses_later_flags(capsys, flag, slice_name):
    """Each flag of cli/transcribe_stream.py that a later slice of this
    port brought is taken now, and a missing model is the first error:
    the quant-tiers, TDT/CTC and utils slices' flags (the beam family's:
    tests/test_torch_refine.py; --ctc against the JAX CLI:
    tests/test_torch_ctc.py; --trace and --profile run:
    tests/test_torch_profiler.py)."""
    assert cli.main(["cli", "missing.gguf", "a.pcm", "--cpu", flag]) == 1
    err = capsys.readouterr().err
    assert "model file not found: missing.gguf" in err
    assert "slice" not in err and "unsupported flag" not in err
