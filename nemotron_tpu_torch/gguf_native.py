"""ctypes binding for the native mmap GGUF loader (native/gguf_loader.cpp).

The port's counterpart of `nemotron_tpu/gguf_native.py`: replaces the
per-tensor `f.read` copies of the multi-GB weight payload with zero-copy
views into a single mmap (the reference loader freads every tensor into
backend buffers, src/nemo-ggml.cpp:221-247). The library is built from
`native/gguf_loader.cpp` into `build/native/` at first use
(`native_build`).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import native_build

_lib = None
_error: Exception | None = None   # why the library is unavailable
_lock = threading.Lock()


def _load():
    """The bound library, or None when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = native_build.load("nemotron_gguf")
        except (OSError, RuntimeError) as e:
            _error = e
            return None
        lib.nemo_gguf_open.restype = ctypes.c_void_p
        lib.nemo_gguf_open.argtypes = [ctypes.c_char_p]
        lib.nemo_gguf_error.restype = ctypes.c_char_p
        lib.nemo_gguf_error.argtypes = [ctypes.c_void_p]
        lib.nemo_gguf_n_tensors.restype = ctypes.c_int64
        lib.nemo_gguf_n_tensors.argtypes = [ctypes.c_void_p]
        lib.nemo_gguf_tensor_info.restype = ctypes.c_uint64
        lib.nemo_gguf_tensor_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64)]
        lib.nemo_gguf_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.nemo_gguf_base.argtypes = [ctypes.c_void_p]
        lib.nemo_gguf_size.restype = ctypes.c_uint64
        lib.nemo_gguf_size.argtypes = [ctypes.c_void_p]
        lib.nemo_gguf_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeGGUF:
    """mmap-backed tensor payload table. Keep this object alive while any
    returned views are in use (the views are read-only)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native gguf loader unavailable: {_error}")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.nemo_gguf_open(path.encode()))
        err = lib.nemo_gguf_error(self._handle)
        if err:
            msg = err.decode()
            lib.nemo_gguf_close(self._handle)
            self._handle = None
            raise ValueError(f"{path}: {msg}")
        size = lib.nemo_gguf_size(self._handle)
        base = lib.nemo_gguf_base(self._handle)
        self._mem = np.ctypeslib.as_array(base, shape=(size,))
        self._mem.flags.writeable = False       # mapped PROT_READ

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.nemo_gguf_close(self._handle)
            self._handle = None

    def tensors(self):
        """Yields (name, ggml_type, shape numpy-order, data offset)."""
        n = self._lib.nemo_gguf_n_tensors(self._handle)
        name_buf = ctypes.create_string_buffer(256)
        gtype = ctypes.c_int32()
        ndims = ctypes.c_uint32()
        ne = (ctypes.c_int64 * 4)()
        for i in range(n):
            off = self._lib.nemo_gguf_tensor_info(
                self._handle, i, name_buf, ctypes.byref(gtype),
                ctypes.byref(ndims), ne)
            shape = tuple(reversed([ne[d] for d in range(ndims.value)]))
            yield name_buf.value.decode(), int(gtype.value), shape, off

    def view(self, offset: int, nbytes: int) -> np.ndarray:
        """A zero-copy uint8 view of `nbytes` at file `offset`."""
        return self._mem[offset:offset + nbytes]
