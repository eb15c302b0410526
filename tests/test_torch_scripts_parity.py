"""The port's oracle tools and converters (`nemotron_tpu_torch/scripts/`:
compare_layers, debug_conv_layers, debug_joint_trace, run_parity,
convert_to_gguf, convert_weights) against the JAX scripts of the same
names, on the CPU, run in this process (tests/test_torch_scripts.py's
helpers).

  - the diff tools: the same lines, stage names and OK/DIFF flags, token
    ids and exit codes; every printed number within TOL_PRINTED of JAX's
    beyond its printed precision (both sides are held to one numpy oracle,
    so the numbers are the two models' distances from it). The port
    prints "torch" where the JAX scripts print "jax";
  - run_parity --quick: the same ladder (stage names, PASS/FAIL, details
    with the same numbers) and exit code, stage 7's and stage 8's skips
    included; the JAX script's sub-scripts run in this process too (its
    run_script replaced by an in-process call with the same streams and
    exit code), as the port's do;
  - the converters: byte-equal files and equal stdout and stderr (paths
    aside) on a tiny NeMo-style checkpoint (.nemo tar and bare .ckpt):
    convert_to_gguf unquantized, q8_0 and q4_0, --vocab; convert_weights
    ckpt -> bin, .nemo -> bin, gguf -> bin (f32 and --f16), bin -> gguf
    (--vocab), and --info.
"""

import contextlib
import io
import os
import re
import sys
import tarfile
import tempfile

import numpy as np
import pytest
import torch

from conftest import tiny_config, write_tiny_gguf
from nemotron_tpu import params as jparams
from nemotron_tpu.ops import quant as jquant
from test_torch_scripts import jax_script, port_script, run_jax, run_port

torch.set_num_threads(1)

# the printed numbers, port against JAX: both are distances from the same
# oracle, at the tiny model's f32 rounding (1e-7-1e-6)
TOL_PRINTED = 5e-5
FLOAT = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?")


def same_lines(got: str, want: str) -> None:
    """`got` line by line against `want`: equal but for their decimal
    numbers, each within TOL_PRINTED plus its printed resolution (a value
    that straddles a rounding point may print one digit apart)."""
    got = got.replace("torch", "jax").replace("|torch|", "|jax|")
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl), (got, want)
    for g, w in zip(gl, wl):
        assert FLOAT.sub("#", g) == FLOAT.sub("#", w), (g, w)
        for a, b in zip(FLOAT.findall(g), FLOAT.findall(w)):
            mant = b.split("e")[0]
            res = 10.0 ** -len(mant.split(".")[1]) * (
                10.0 ** int(b.split("e")[1]) if "e" in b else 1.0)
            assert abs(float(a) - float(b)) <= TOL_PRINTED + res, (g, w)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny random model with a joint bias on token 5, as f32 and Q8_0
    GGUFs, a 400-frame mel dump (three R = 13 chunks), and run_parity's
    synthetic 4 s PCM (the JAX script's own fixture, written here so that
    neither ladder writes one outside the test's directory)."""
    from nemotron_tpu_torch.utils.dump import append_dump

    cfg = tiny_config()
    arrays = jparams.random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    d = tmp_path_factory.mktemp("parity")
    f32, q8 = str(d / "tiny_f32.gguf"), str(d / "tiny_q8.gguf")
    write_tiny_gguf(f32, arrays, cfg)
    write_tiny_gguf(q8, arrays, cfg, quantize={
        n: 8 for n, a in arrays.items()
        if jquant.should_quantize(n, a if a.ndim != 3 else a.squeeze())})
    mel = str(d / "mel.bin")
    append_dump(mel, (np.random.default_rng(3).standard_normal(
        (400, cfg.n_mels)) * 2 - 8).astype(np.float32))
    pcm = str(d / "audio.pcm")
    t = np.arange(16000 * 4) / 16000.0
    ((0.3 * np.sin(2 * np.pi * 440 * t)
      + 0.05 * np.random.default_rng(0).standard_normal(t.size)) * 16000
     ).astype(np.int16).tofile(pcm)
    return {"f32": f32, "q8": q8, "mel": mel, "pcm": pcm, "dir": d,
            "arrays": arrays, "cfg": cfg}


# -- the diff tools -----------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "q8", "mel"])
def test_compare_layers_matches_jax(tiny, case, capsys, monkeypatch):
    args = [tiny["q8" if case == "q8" else "f32"]]
    if case == "mel":
        args += [tiny["mel"], "--chunks", "3"]
    want = run_jax("compare_layers", [*args, "--cpu"], capsys, monkeypatch)
    got = run_port("compare_layers", [*args, "--cpu"], capsys)
    same_lines(got, want)
    assert got.count("encoder out") == (3 if case == "mel" else 1)
    assert "DIFF" not in got


@pytest.mark.parametrize("case", ["layer0", "layer2", "mel"])
def test_debug_conv_layers_matches_jax(tiny, case, capsys, monkeypatch):
    args = [tiny["f32"], "--layer", "2" if case == "layer2" else "0"]
    if case == "mel":
        args += ["--mel", tiny["mel"]]
    want = run_jax("debug_conv_layers", [*args, "--cpu"], capsys,
                   monkeypatch)
    got = run_port("debug_conv_layers", [*args, "--cpu"], capsys)
    same_lines(got, want)
    assert "worst stage max_abs" in got and "DIFF" not in got


@pytest.mark.parametrize("seed", [1, 3])
def test_debug_joint_trace_matches_jax(tiny, seed, capsys, monkeypatch):
    args = [tiny["f32"], "--frames", "6", "--seed", str(seed), "--cpu"]
    want = run_jax("debug_joint_trace", args, capsys, monkeypatch)
    got = run_port("debug_joint_trace", args, capsys)
    same_lines(got, want)
    assert got.splitlines()[-1] == "no divergence over 6 frames"


def test_dense_model_shared_within_sharing_loads(tiny, tmp_path):
    """Inside sharing_loads a GGUF is loaded once for the tools that run
    in turn (nested blocks share it); a file rewritten in between, and
    every call outside the block, loads anew. The load holds the file's
    tensors as the oracle reads them."""
    from nemotron_tpu_torch import gguf
    from nemotron_tpu_torch.scripts import sharing_loads
    from nemotron_tpu_torch.scripts._common import dense_model

    cpu = torch.device("cpu")
    path = str(tmp_path / "m.gguf")
    write_tiny_gguf(path, tiny["arrays"], tiny["cfg"])
    assert dense_model(path, cpu) is not dense_model(path, cpu)
    with sharing_loads():
        first = dense_model(path, cpu)
        with sharing_loads():
            assert dense_model(path, cpu) is first
        assert dense_model(tiny["f32"], cpu) is not first
        write_tiny_gguf(path, tiny["arrays"], tiny["cfg"], quantize={
            "joint.enc.weight": gguf.GGML_Q8_0})
        os.utime(path, ns=(1, 1))
        again = dense_model(path, cpu)
        assert again is not first and dense_model(path, cpu) is again
    assert dense_model(path, cpu) is not again
    _p, cfg, _v, arrays, g = first
    assert cfg.n_layers == tiny["cfg"].n_layers and set(arrays) == set(
        g.tensors)
    np.testing.assert_array_equal(arrays["joint.enc.weight"],
                                  tiny["arrays"]["joint.enc.weight"])
    assert again[4].tensors["joint.enc.weight"].ggml_type == gguf.GGML_Q8_0


def test_oracle_tools_usage_exit_codes(capsys):
    """No model argument: the usage text on stderr and exit code 1, as
    the JAX scripts."""
    for name in ("compare_layers", "debug_conv_layers", "debug_joint_trace",
                 "run_parity", "convert_to_gguf"):
        assert port_script(name).main([name]) == 1
        assert port_script(name).__doc__.strip() in capsys.readouterr().err


# -- run_parity ---------------------------------------------------------------

def jax_in_process(name: str, args: list) -> tuple[int, str]:
    """The JAX run_parity's run_script, in this process: the sub-script's
    main with its stdout then its stderr written to stderr
    (ref_oracle_parity's main parses its argv without the program name)."""
    mod = jax_script(name.removesuffix(".py"))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(args if name == "ref_oracle_parity.py"
                      else [name, *args])
    text = out.getvalue() + err.getvalue()
    sys.stderr.write(text)
    return rc, text


def ladder(out: str) -> list:
    """The PASS/FAIL table of run_parity's stdout, one line a stage."""
    lines = out.splitlines()
    i = lines.index("==== parity ladder ====")
    return lines[i:]


def test_run_parity_quick_matches_jax(tiny, tmp_path, capsys, monkeypatch):
    """--quick on the f32 GGUF: load, stages, greedy, streaming R=13, the
    four quant tiers, stage 7's and stage 8's skips; the same table and
    exit code as the JAX ladder. Both take the fixture's PCM (without
    one the JAX script writes its synthetic audio to a fixed name under
    /tmp); other temporary files go to the test's own directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("NEMOTRON_REF_DIR", str(tiny["dir"] / "no_checkout"))
    args = [tiny["f32"], tiny["pcm"], "--quick", "--cpu", "--reference-dir",
            str(tiny["dir"] / "no_reference"), "--reference-oracle"]
    jrp = jax_script("run_parity")
    monkeypatch.setattr(jrp, "run_script", jax_in_process)
    capsys.readouterr()
    assert jrp.main(["run_parity.py", *args]) == 0
    want = capsys.readouterr().out
    got = run_port("run_parity", args, capsys)
    same_lines("\n".join(ladder(got)).replace("torch vs", "JAX vs"),
               "\n".join(ladder(want)))
    rows = ladder(got)
    assert len(rows) == 12 and rows[-1] == "==== ALL PASS ===="
    assert "skipped: g++ or reference checkout unavailable" in rows[-2]
    assert "skipped: nemotron-asr.cpp absent" in rows[-3]


def test_run_parity_q8_and_reference_oracle_not_run(tiny, capsys,
                                                    monkeypatch):
    """On a Q8_0 GGUF the ladder has no quant stage (exit 0); with a
    reference checkout present, stage 8 runs ref_oracle_parity, and an
    oracle that does not build there (an empty checkout) FAILs the stage
    as not run and the ladder exits 2: it never claims a PASS it did not
    run."""
    got = run_port("run_parity", [tiny["q8"], "--quick", "--cpu"], capsys)
    rows = ladder(got)
    assert [r.split()[0] for r in rows[1:-1]] == ["load", "stages", "greedy",
                                                  "streaming"]
    assert "quantized" in rows[1] and rows[-1] == "==== ALL PASS ===="
    checkout = tiny["dir"] / "checkout"
    (checkout / "src" / "reference").mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("NEMOTRON_REF_DIR", str(checkout))
    monkeypatch.setattr("shutil.which", lambda name: "/usr/bin/" + name)
    monkeypatch.setenv("CXX", str(tiny["dir"] / "no_compiler"))
    got = run_port("run_parity", [tiny["q8"], "--quick", "--cpu",
                                  "--reference-oracle"], capsys, rc=2)
    row = ladder(got)[-2]
    assert "reference oracle  FAIL" in row
    assert "ref_oracle_parity rc=3: not run, the oracle did not build" in row


# -- the converters -----------------------------------------------------------

@pytest.fixture(scope="module")
def nemo(tiny):
    """The tiny model as NeMo writes it: a .nemo tar (model_config.yaml,
    model_weights.ckpt, tokenizer.vocab without the blank), the bare
    checkpoint, and a vocab file."""
    d, cfg = tiny["dir"], tiny["cfg"]
    ckpt = str(d / "model_weights.ckpt")
    torch.save({n: torch.from_numpy(a) for n, a in tiny["arrays"].items()},
               ckpt)
    vocab = str(d / "tokenizer.vocab")
    with open(vocab, "w", encoding="utf-8") as f:
        f.writelines(f"▁t{i}\t-{i}.5\n" for i in range(cfg.vocab_size - 1))
    config = str(d / "model_config.yaml")
    with open(config, "w") as f:
        f.write(f"encoder:\n  d_model: {cfg.d_model}\n  n_heads: "
                f"{cfg.n_heads}\n")
    path = str(d / "model.nemo")
    with tarfile.open(path, "w") as tar:
        for p in (config, ckpt, vocab):
            tar.add(p, arcname="./" + os.path.basename(p))
    return {"nemo": path, "ckpt": ckpt, "vocab": vocab}


def convert_both(name, src, dst_name, flags, tmp_path, capsys, monkeypatch):
    """The JAX script and the port's entry point on the same source, each
    writing `dst_name` in a directory of its own: (the two files' bytes,
    the JAX script's stdout and stderr, the port's, with each directory
    written as DIR)."""
    out = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        args = [src, str(d / dst_name), *flags] if dst_name else [*flags,
                                                                  src]
        capsys.readouterr()
        if side == "jax":
            mod = jax_script(name)
            monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
            assert mod.main([f"{name}.py", *args]) == 0
        else:
            assert port_script(name).main([name, *args, "--cpu"]) == 0
        cap = capsys.readouterr()
        data = (d / dst_name).read_bytes() if dst_name else b""
        out[side] = (data, cap.out.replace(str(d), "DIR"),
                     cap.err.replace(str(d), "DIR"))
    return out["jax"], out["torch"]


@pytest.mark.parametrize("case", ["nemo", "nemo_q8_0", "ckpt_q4_0_vocab"])
def test_convert_to_gguf_matches_jax(nemo, case, tmp_path, capsys,
                                     monkeypatch):
    src = nemo["ckpt"] if case.startswith("ckpt") else nemo["nemo"]
    flags = {"nemo": [], "nemo_q8_0": ["--quantize", "q8_0"],
             "ckpt_q4_0_vocab": ["--quantize", "q4_0", "--vocab",
                                 nemo["vocab"]]}[case]
    want, got = convert_both("convert_to_gguf", src, "out.gguf", flags,
                             tmp_path, capsys, monkeypatch)
    assert got == want and got[0][:4] == b"GGUF" and "wrote DIR" in got[2]


def test_converted_gguf_loads_equal_in_both_packages(nemo, tiny, tmp_path,
                                                     capsys, monkeypatch):
    """The port's converted GGUF reads into the JAX package's params as it
    does into the port's, and both equal the source weights."""
    from nemotron_tpu.params import load_model as jload
    from nemotron_tpu_torch.params import load_model as tload

    path = str(tmp_path / "m.gguf")
    assert port_script("convert_to_gguf").main(
        ["convert_to_gguf", nemo["nemo"], path, "--cpu"]) == 0
    jp, jcfg, jvocab = jload(path)
    tp, tcfg, tvocab = tload(path, device="cpu")
    assert jcfg.n_layers == tcfg.n_layers == tiny["cfg"].n_layers
    assert jvocab == tvocab and tvocab[-1] == "<blank>" and tvocab[0] == "▁t0"
    np.testing.assert_array_equal(tp.layers.ffn1_w1.numpy(),
                                  np.asarray(jp.layers.ffn1_w1))
    np.testing.assert_array_equal(
        tp.layers.conv_dw_w[1].numpy(),
        tiny["arrays"]["encoder.layers.1.conv.depthwise_conv.weight"]
        .squeeze(1).T)


@pytest.mark.parametrize("case", ["ckpt_bin", "nemo_bin", "gguf_bin",
                                  "gguf_bin_f16", "bin_gguf_vocab",
                                  "info_bin", "info_ckpt"])
def test_convert_weights_matches_jax(nemo, tiny, case, tmp_path, capsys,
                                     monkeypatch):
    from nemotron_tpu_torch.utils.nemo_bin import write_nemo_bin

    bin_path = str(tmp_path / "src.bin")
    write_nemo_bin(bin_path, tiny["arrays"])
    src, dst, flags = {
        "ckpt_bin": (nemo["ckpt"], "out.bin", []),
        "nemo_bin": (nemo["nemo"], "out.bin", []),
        "gguf_bin": (tiny["f32"], "out.bin", []),
        "gguf_bin_f16": (tiny["q8"], "out.bin", ["--f16"]),
        "bin_gguf_vocab": (bin_path, "out.gguf", ["--vocab", nemo["vocab"]]),
        "info_bin": (bin_path, None, ["--info"]),
        "info_ckpt": (nemo["ckpt"], None, ["--info"]),
    }[case]
    want, got = convert_both("convert_weights", src, dst, flags, tmp_path,
                             capsys, monkeypatch)
    assert got == want
    if dst:
        assert got[0][:4] in (b"NEMO", b"GGUF") and "wrote DIR" in got[2]
    else:
        assert "total:" in got[1] and "encoder:" in got[1]


def test_convert_weights_bin_to_gguf_warns_without_vocab(tiny, tmp_path,
                                                         capsys,
                                                         monkeypatch):
    from nemotron_tpu_torch.utils.nemo_bin import write_nemo_bin

    bin_path = str(tmp_path / "src.bin")
    write_nemo_bin(bin_path, tiny["arrays"])
    want, got = convert_both("convert_weights", bin_path, "out.gguf", [],
                             tmp_path, capsys, monkeypatch)
    assert got == want and "warning: no vocab available" in got[2]
