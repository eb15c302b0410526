"""The PyTorch port stands alone: no module of `nemotron_tpu_torch` (nor
chip_smoke.py) imports JAX or the JAX package, every port subpackage is
declared for packaging, and the entry points run on CUDA unless asked for
the CPU -- without CUDA they raise instead of falling back."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nemotron_tpu_torch")


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "nemotron_tpu")


def test_no_jax_imports_in_port_sources():
    bad = []
    n_files = 0
    for path in _port_sources():
        n_files += 1
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if _forbidden(n)]
    assert n_files > 15
    assert not bad, bad


def test_importing_every_port_module_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nemotron_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'nemotron_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nemotron_tpu')]\n"
        "assert len(mods) > 15, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_port_subpackages_declared():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        declared = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    actual = {"nemotron_tpu_torch"} | {
        m.name for m in pkgutil.walk_packages([PKG], "nemotron_tpu_torch.")
        if m.ispkg}
    assert len(actual) >= 6
    missing = actual - declared
    assert not missing, f"port subpackages not declared: {missing}"


def test_cuda_marker_registered():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        markers = tomllib.load(f)["tool"]["pytest"]["ini_options"]["markers"]
    assert any(m.startswith("cuda:") for m in markers)


def test_load_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from nemotron_tpu_torch.params import load_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gguf = os.path.join(REPO, "weights", "tones_tiny.gguf")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(gguf)
    params, cfg, _ = load_model(gguf, device="cpu")
    assert params.device.type == "cpu"


def test_jax_params_and_preprocessor_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from nemotron_tpu_torch.config import ModelConfig, PreprocessorConfig
    from nemotron_tpu_torch.frontend.preprocessor import StreamingPreprocessor
    from nemotron_tpu_torch.params import params_from_jax_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax_arrays({}, ModelConfig())
    pc = PreprocessorConfig()
    fb = np.zeros((pc.n_mels, pc.n_freqs), np.float32)
    win = np.ones(pc.n_window_size, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingPreprocessor(fb, win)
    pre = StreamingPreprocessor(fb, win, device="cpu")
    assert pre.device.type == "cpu"


def test_cli_without_cpu_flag_refuses_when_cuda_is_absent(monkeypatch,
                                                          tmp_path, capsys):
    from nemotron_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcm = tmp_path / "a.pcm"
    pcm.write_bytes(b"\0\0" * 1600)
    gguf = os.path.join(REPO, "weights", "tones_tiny.gguf")
    assert cli.main(["cli", gguf, str(pcm)]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert cli.main(["cli", gguf, str(pcm), "--kv-int4"]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert cli.main(["cli", gguf, str(pcm), "--kv-int4", "--cpu"]) == 0
    assert "int4 K/V cache rings enabled" in capsys.readouterr().err


def test_kernel_wrappers_refuse_other_devices():
    from nemotron_tpu_torch.ops.quant_kernel import q8_matmul
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul

    x = torch.zeros((2, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        q8_matmul(x, torch.zeros((32, 4), dtype=torch.int8, device="meta"),
                  torch.zeros((1, 4), device="meta"))
    q = torch.zeros((1, 1, 1, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_ring_attention(0, q, q, q, q[None], q[None], q, q, q)
    with pytest.raises(ValueError, match="device"):
        w8a8_matmul(x, torch.zeros((32, 4), dtype=torch.int8, device="meta"),
                    torch.zeros((4,), device="meta"))
