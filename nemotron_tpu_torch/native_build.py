"""Build and load the repository's native host libraries.

The C++ sources under `native/` (the mmap GGUF loader and the streaming
DSP frontend) are compiled with g++ and `native/Makefile`'s flags into a
shared library under `build/native/` at the repository root, at first
use, and loaded with ctypes; the JAX package's bindings run `make` in
`native/` instead, and nothing here writes there. The library name
carries a hash of its source, its flags and the host's CPU features
(`-march=native`), so an edited source is rebuilt and a library built for
another CPU is never loaded. A build goes to a temporary name under a
file lock and is renamed into place, so that processes building at once
never load a half-written library. Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# library stem -> source under native/ (native/Makefile's LIBS)
SOURCES = {"nemotron_frontend": "frontend.cpp",
           "nemotron_gguf": "gguf_loader.cpp"}
# native/Makefile's CXXFLAGS, and -shared as its rules add
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-march=native", "-funroll-loops", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def compiler() -> str:
    """The C++ compiler: $CXX, else g++ (the Makefile's `CXX ?= g++`)."""
    return os.environ.get("CXX", "g++")


def _host_signature() -> bytes:
    """What `-march=native` compiles for: the machine and its CPU flags."""
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    sig += line
                    break
    except OSError:
        pass
    return sig.encode()


def library_path(source: Path, stem: str, build_dir: Path = BUILD_DIR
                 ) -> Path:
    """Where the library of `source` lives: its name carries a hash of the
    source, the compiler, the flags and the host."""
    h = hashlib.sha1(source.read_bytes())
    h.update(" ".join((compiler(), *CXXFLAGS)).encode())
    h.update(_host_signature())
    return build_dir / f"lib{stem}-{h.hexdigest()[:12]}.so"


def build(source: Path, stem: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` into its library unless it is built already;
    returns the library's path. Raises RuntimeError with the compiler's
    output when the compile fails (or the compiler is missing)."""
    target = library_path(source, stem, build_dir)
    if target.exists():
        return target
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)       # one compile at a time
        if target.exists():                     # another process built it
            return target
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [compiler(), *CXXFLAGS, "-o", tmp, str(source)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            os.unlink(tmp)
            raise RuntimeError(f"building {source.name}: {e}") from e
        if r.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{compiler()} failed for {source.name} "
                               f"(exit {r.returncode}):\n{r.stderr}")
        os.replace(tmp, target)
    return target


def load(stem: str) -> ctypes.CDLL:
    """The loaded library `stem` (a key of SOURCES), built first if
    needed. Raises RuntimeError when it cannot be built, OSError when it
    cannot be loaded."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(NATIVE_DIR / SOURCES[stem], stem)))
            _loaded[stem] = lib
        return lib
