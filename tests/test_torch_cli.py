"""The port's streaming CLI on the CPU: the reference's device flags
(`[--cpu|--cuda|--metal]`, src/transcribe_stream.cpp:27-36). `--cuda` asks
for the card, which is the default; `--metal` and `--tpu` warn and run on
the card, as the JAX CLI warns (cli/transcribe_stream.py:59-62); `--cpu`
with `--cuda` is refused. A missing model shows that the flags were taken
before any device was touched."""

import pytest

from nemotron_tpu_torch import cli


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
