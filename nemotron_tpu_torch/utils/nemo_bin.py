"""Reader/writer for the legacy "NEMO" v1 binary weight format.

This is the flat tensor container the reference's C++ oracle loads
(reference src/reference/ggml_weights.cpp:19-157, produced by reference
scripts/convert_weights.py:1-29). Layout (all little-endian):

    magic   "NEMO" (4 bytes)
    version uint32 == 1
    n       uint32 tensor count
    then n records of
        name_len uint32, name bytes (utf-8)
        n_dims   uint32, dims uint32[n_dims]
        dtype    uint32 (0 = f32, 1 = f16)
        data     raw row-major payload

The port's own copy of `nemotron_tpu/utils/nemo_bin.py` (numpy only), with
the same limits and errors. Tensor names are raw NeMo state-dict names —
the keying that the port's `params.params_from_arrays` consumes, so a file
read here feeds it directly. GGUF remains the framework's primary artifact;
this module exists for interop with reference-era tooling and as the last
inventory row of SURVEY.md §2.2/§2.3.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"NEMO"
VERSION = 1
DTYPE_F32 = 0
DTYPE_F16 = 1

_DTYPES = {DTYPE_F32: np.float32, DTYPE_F16: np.float16}

# Hard caps mirroring the GGUF reader's defensive posture (gguf.py):
# a malformed length field must fail loudly, not allocate garbage.
_MAX_TENSORS = 1 << 20
_MAX_NAME = 1 << 12
_MAX_DIMS = 8


class NemoBinError(ValueError):
    """Malformed NEMO binary file."""


def _take(buf: memoryview, ofs: int, n: int, what: str) -> tuple[memoryview, int]:
    if n < 0 or ofs + n > len(buf):
        raise NemoBinError(f"truncated file reading {what} "
                           f"(need {n} bytes at offset {ofs}, have {len(buf)})")
    return buf[ofs:ofs + n], ofs + n


def _u32(buf: memoryview, ofs: int, what: str) -> tuple[int, int]:
    raw, ofs = _take(buf, ofs, 4, what)
    return struct.unpack("<I", raw)[0], ofs


def read_nemo_bin(path: str, keep_f16: bool = False) -> dict[str, np.ndarray]:
    """Load a NEMO v1 file into {state-dict name: array}.

    f16 payloads are widened to f32 by default, matching the reference
    loader's behavior (src/reference/ggml_weights.cpp:108-157); pass
    keep_f16=True to keep the stored precision.
    """
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    ofs = 0
    magic, ofs = _take(buf, ofs, 4, "magic")
    if bytes(magic) != MAGIC:
        raise NemoBinError(f"bad magic {bytes(magic)!r}, expected {MAGIC!r}")
    version, ofs = _u32(buf, ofs, "version")
    if version != VERSION:
        raise NemoBinError(f"unsupported version {version}")
    n_tensors, ofs = _u32(buf, ofs, "tensor count")
    if n_tensors > _MAX_TENSORS:
        raise NemoBinError(f"implausible tensor count {n_tensors}")

    out: dict[str, np.ndarray] = {}
    for i in range(n_tensors):
        name_len, ofs = _u32(buf, ofs, f"name length of tensor {i}")
        if name_len > _MAX_NAME:
            raise NemoBinError(f"implausible name length {name_len}")
        raw, ofs = _take(buf, ofs, name_len, f"name of tensor {i}")
        name = bytes(raw).decode("utf-8")
        n_dims, ofs = _u32(buf, ofs, f"{name}: n_dims")
        if n_dims > _MAX_DIMS:
            raise NemoBinError(f"{name}: implausible n_dims {n_dims}")
        shape = []
        numel = 1
        for d in range(n_dims):
            dim, ofs = _u32(buf, ofs, f"{name}: dim {d}")
            shape.append(dim)
            numel *= dim
        dtype_id, ofs = _u32(buf, ofs, f"{name}: dtype")
        if dtype_id not in _DTYPES:
            raise NemoBinError(f"{name}: unknown dtype id {dtype_id}")
        np_dtype = _DTYPES[dtype_id]
        nbytes = numel * np.dtype(np_dtype).itemsize
        raw, ofs = _take(buf, ofs, nbytes, f"data of {name}")
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy()
        if dtype_id == DTYPE_F16 and not keep_f16:
            arr = arr.astype(np.float32)
        out[name] = arr
    return out


def write_nemo_bin(path: str, arrays: dict[str, np.ndarray],
                   f16: bool = False) -> None:
    """Write {name: array} as a NEMO v1 file the reference oracle can load."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION, len(arrays)))
        for name, arr in arrays.items():
            a = np.asarray(arr)
            name_b = name.encode("utf-8")
            f.write(struct.pack("<I", len(name_b)))
            f.write(name_b)
            f.write(struct.pack("<I", a.ndim))
            for dim in a.shape:
                f.write(struct.pack("<I", dim))
            if f16:
                f.write(struct.pack("<I", DTYPE_F16))
                f.write(np.ascontiguousarray(a, dtype=np.float16).tobytes())
            else:
                f.write(struct.pack("<I", DTYPE_F32))
                f.write(np.ascontiguousarray(a, dtype=np.float32).tobytes())
