"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under `nemotron_tpu_torch/csrc/` with a plain C
interface. It is compiled with nvcc for Hopper (`sm_90a`) into a shared
library under `build/kernels/` at the repository root, at first use, and
loaded with ctypes. The library name carries a hash of its source, so an
edited kernel is rebuilt and a stale library is never loaded. Nothing here
runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("ring_attn", "q8_matmul", "w8a8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME, else the toolkit's
    default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                           "the CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, str, Path] | None:
    """Start nvcc for one kernel unless its library is already built.
    The output goes to a temporary name and is renamed into place when the
    compile succeeds, so a cut build never leaves a library behind."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    output, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{output}")
    os.replace(tmp, target)


def build_all() -> None:
    """Compile every kernel, one nvcc process each, all at once."""
    started = {n: _start_build(n) for n in KERNELS}
    errors = []
    for n, s in started.items():
        try:
            _finish_build(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
