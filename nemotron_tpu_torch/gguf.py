"""Minimal GGUF v3 reader/writer in pure numpy.

The port's own copy of `nemotron_tpu/gguf.py`, without the native mmap
loader: tensors are read with plain file reads.

Interoperates with files produced by the reference converter
(reference scripts/convert_to_gguf.py:404-452) and with the reference loader
(reference src/nemo-ggml.cpp:83-146). Supports the tensor dtypes the model
uses: F32, F16, Q8_0 and Q4_0 block quantization
(reference scripts/convert_to_gguf.py:93-179, docs/TENSOR_FORMAT.md:13-19).

Layout reminder: GGUF stores dimensions *reversed* relative to the
numpy/PyTorch shape (docs/TENSOR_FORMAT.md:5-11); the raw data bytes are the
original row-major buffer. `GGUFTensor.to_numpy()` therefore reshapes into the
original (PyTorch-order) shape.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import BinaryIO

import numpy as np

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
ALIGNMENT = 32

# GGUF metadata value types
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32, T_FLOAT32, T_BOOL, \
    T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = range(13)

# GGML tensor dtypes
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8

QK = 32  # block size for Q4_0 / Q8_0


def type_size(ggml_type: int, n_elements: int) -> int:
    if ggml_type == GGML_F32:
        return n_elements * 4
    if ggml_type == GGML_F16:
        return n_elements * 2
    if ggml_type == GGML_Q8_0:
        return (n_elements + QK - 1) // QK * (2 + QK)
    if ggml_type == GGML_Q4_0:
        return (n_elements + QK - 1) // QK * (2 + QK // 2)
    raise ValueError(f"unsupported ggml type {ggml_type}")


# ---------------------------------------------------------------------------
# Block quantization (Q8_0 / Q4_0), vectorized. Mirrors the reference
# quantizers bit-for-bit (scripts/convert_to_gguf.py:93-179).
# ---------------------------------------------------------------------------

def quantize_q8_0(data: np.ndarray) -> bytes:
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    n = data.size
    if n % QK:
        data = np.pad(data, (0, QK - n % QK))
    blocks = data.reshape(-1, QK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax != 0, amax / 127.0, 0.0).astype(np.float16)
    s32 = scales.astype(np.float32)[:, None]
    s_safe = np.where(s32 != 0, s32, 1.0)
    q = np.round(blocks / s_safe).astype(np.int8)
    q = np.where(s32 != 0, q, 0).astype(np.int8)
    out = np.empty(blocks.shape[0],
                   dtype=np.dtype([("scale", np.float16), ("q", np.int8, QK)]))
    out["scale"] = scales
    out["q"] = q
    return out.tobytes()


def dequantize_q8_0(raw: bytes, n_elements: int) -> np.ndarray:
    blocks = np.frombuffer(
        raw, dtype=np.dtype([("scale", np.float16), ("q", np.int8, QK)]))
    vals = blocks["q"].astype(np.float32) * blocks["scale"].astype(np.float32)[:, None]
    return vals.reshape(-1)[:n_elements]


def q8_0_to_int8(raw: bytes, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Split Q8_0 blocks into (int8 values [n], f32 per-block scales [n/32])."""
    blocks = np.frombuffer(
        raw, dtype=np.dtype([("scale", np.float16), ("q", np.int8, QK)]))
    return (blocks["q"].reshape(-1)[:n_elements].copy(),
            blocks["scale"].astype(np.float32).copy())


def q4_0_to_int8(raw: bytes, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Unpack Q4_0 blocks into (int8 values [n] in [-8, 7], f32 per-block
    scales [n/32]) -- 4-bit weights run through the same int8 QTensor path
    (the Q8 kernel takes them as int8; numerics match Q4_0 dequant
    exactly)."""
    blocks = np.frombuffer(
        raw, dtype=np.dtype([("scale", np.float16), ("q", np.uint8, QK // 2)]))
    packed = blocks["q"]
    low = (packed & 0x0F).astype(np.int8) - 8
    high = (packed >> 4).astype(np.int8) - 8
    q = np.concatenate([low, high], axis=1)
    return (q.reshape(-1)[:n_elements].copy(),
            blocks["scale"].astype(np.float32).copy())


def quantize_q4_0(data: np.ndarray) -> bytes:
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    n = data.size
    if n % QK:
        data = np.pad(data, (0, QK - n % QK))
    blocks = data.reshape(-1, QK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax != 0, amax / 7.0, 0.0).astype(np.float16)
    s32 = scales.astype(np.float32)[:, None]
    s_safe = np.where(s32 != 0, s32, 1.0)
    q = np.clip(np.round(blocks / s_safe), -8, 7).astype(np.int8)
    q = np.where(s32 != 0, q, 0)
    qu = (q + 8).astype(np.uint8)
    low = qu[:, : QK // 2] & 0x0F
    high = qu[:, QK // 2:] & 0x0F
    packed = (low | (high << 4)).astype(np.uint8)
    out = np.empty(blocks.shape[0],
                   dtype=np.dtype([("scale", np.float16), ("q", np.uint8, QK // 2)]))
    out["scale"] = scales
    out["q"] = packed
    return out.tobytes()


def dequantize_q4_0(raw: bytes, n_elements: int) -> np.ndarray:
    blocks = np.frombuffer(
        raw, dtype=np.dtype([("scale", np.float16), ("q", np.uint8, QK // 2)]))
    packed = blocks["q"]
    low = (packed & 0x0F).astype(np.int8) - 8
    high = (packed >> 4).astype(np.int8) - 8
    q = np.concatenate([low, high], axis=1).astype(np.float32)
    vals = q * blocks["scale"].astype(np.float32)[:, None]
    return vals.reshape(-1)[:n_elements]


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GGUFTensor:
    name: str
    shape: tuple[int, ...]      # original (PyTorch-order) shape
    ggml_type: int
    raw: bytes

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def to_numpy(self) -> np.ndarray:
        """Dequantize (if needed) and reshape into the original shape."""
        n = self.n_elements
        if self.ggml_type == GGML_F32:
            arr = np.frombuffer(self.raw, dtype=np.float32, count=n)
        elif self.ggml_type == GGML_F16:
            arr = np.frombuffer(self.raw, dtype=np.float16, count=n).astype(np.float32)
        elif self.ggml_type == GGML_Q8_0:
            arr = dequantize_q8_0(self.raw, n)
        elif self.ggml_type == GGML_Q4_0:
            arr = dequantize_q4_0(self.raw, n)
        else:
            raise ValueError(f"unsupported ggml type {self.ggml_type}")
        return arr.reshape(self.shape).copy()


@dataclasses.dataclass
class GGUFFile:
    metadata: dict[str, object]
    tensors: dict[str, GGUFTensor]
    # keeps the native mmap alive while zero-copy tensor views exist
    _native: object = None


def _read_string(f: BinaryIO) -> bytes:
    (n,) = struct.unpack("<Q", f.read(8))
    if n > 1 << 31:
        raise ValueError(f"implausible GGUF string length {n}")
    data = f.read(n)
    if len(data) != n:
        raise ValueError("truncated GGUF string")
    return data


def _read_value(f: BinaryIO, vtype: int) -> object:
    if vtype == T_UINT32:
        return struct.unpack("<I", f.read(4))[0]
    if vtype == T_INT32:
        return struct.unpack("<i", f.read(4))[0]
    if vtype == T_FLOAT32:
        return struct.unpack("<f", f.read(4))[0]
    if vtype == T_UINT64:
        return struct.unpack("<Q", f.read(8))[0]
    if vtype == T_INT64:
        return struct.unpack("<q", f.read(8))[0]
    if vtype == T_FLOAT64:
        return struct.unpack("<d", f.read(8))[0]
    if vtype == T_BOOL:
        return bool(f.read(1)[0])
    if vtype == T_UINT8:
        return f.read(1)[0]
    if vtype == T_INT8:
        return struct.unpack("<b", f.read(1))[0]
    if vtype == T_UINT16:
        return struct.unpack("<H", f.read(2))[0]
    if vtype == T_INT16:
        return struct.unpack("<h", f.read(2))[0]
    if vtype == T_STRING:
        return _read_string(f)
    if vtype == T_ARRAY:
        (etype,) = struct.unpack("<i", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        if count > 10_000_000:
            raise ValueError(f"implausible GGUF array length {count}")
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unsupported metadata type {vtype}")


def read_gguf(path: str, use_native: bool | str = "auto") -> GGUFFile:
    """Read a GGUF file (header, metadata, tensor payloads), as the JAX
    package's read_gguf (nemotron_tpu/gguf.py:224-292). With the native
    loader (native/gguf_loader.cpp, built at first use: gguf_native) the
    tensor payload is served as read-only zero-copy views into one mmap
    instead of per-tensor read() copies; use_native="auto" takes it when it
    builds and opens the file, True raises when it cannot, False never
    uses it. The bytes are the same either way."""
    native = None
    if use_native in ("auto", True):
        try:
            from .gguf_native import NativeGGUF

            native = NativeGGUF(path)
        except Exception:
            if use_native is True:
                raise
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version != GGUF_VERSION:
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        (n_tensors,) = struct.unpack("<q", f.read(8))
        (n_kv,) = struct.unpack("<q", f.read(8))
        file_size = os.fstat(f.fileno()).st_size
        if not (0 <= n_tensors < 1_000_000 and 0 <= n_kv < 1_000_000):
            raise ValueError(f"{path}: implausible header counts "
                             f"(tensors={n_tensors}, kv={n_kv})")

        metadata: dict[str, object] = {}
        for _ in range(n_kv):
            key = _read_string(f).decode("utf-8")
            (vtype,) = struct.unpack("<i", f.read(4))
            val = _read_value(f, vtype)
            if isinstance(val, bytes) and key != "tokenizer.vocab":
                try:
                    val = val.decode("utf-8")
                except UnicodeDecodeError:
                    pass
            metadata[key] = val

        infos = []
        for _ in range(n_tensors):
            name = _read_string(f).decode("utf-8")
            (n_dims,) = struct.unpack("<I", f.read(4))
            ne = struct.unpack(f"<{n_dims}q", f.read(8 * n_dims))
            (gtype,) = struct.unpack("<i", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            # GGUF ne is reversed vs the original shape
            shape = tuple(reversed(ne))
            infos.append((name, shape, gtype, offset))

        pos = f.tell()
        data_start = (pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT

        tensors: dict[str, GGUFTensor] = {}
        for name, shape, gtype, offset in infos:
            n = int(np.prod(shape)) if shape else 1
            size = type_size(gtype, n)
            if data_start + offset + size > file_size:
                raise ValueError(f"{path}: tensor {name!r} extends past "
                                 "end of file (truncated?)")
            if native is not None:
                raw = native.view(data_start + offset, size)
            else:
                f.seek(data_start + offset)
                raw = f.read(size)
            tensors[name] = GGUFTensor(name, shape, gtype, raw)

    return GGUFFile(metadata=metadata, tensors=tensors, _native=native)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _write_string(f: BinaryIO, s: str | bytes) -> None:
    data = s.encode("utf-8") if isinstance(s, str) else s
    f.write(struct.pack("<Q", len(data)))
    f.write(data)


def write_gguf(
    path: str,
    metadata: dict[str, object],
    tensors: dict[str, np.ndarray],
    quantize: dict[str, int] | None = None,
) -> None:
    """Write a GGUF v3 file the reference loader can read.

    `tensors` maps name -> numpy array in original (PyTorch-order) shape.
    `quantize` maps name -> GGML type for tensors to quantize (others F32).
    """
    quantize = quantize or {}

    infos = []
    offset = 0
    for name, arr in tensors.items():
        gtype = quantize.get(name, GGML_F32)
        if gtype == GGML_F32:
            raw = np.ascontiguousarray(arr, dtype=np.float32).tobytes()
        elif gtype == GGML_F16:
            raw = np.ascontiguousarray(arr, dtype=np.float16).tobytes()
        elif gtype == GGML_Q8_0:
            raw = quantize_q8_0(arr)
        elif gtype == GGML_Q4_0:
            raw = quantize_q4_0(arr)
        else:
            raise ValueError(f"unsupported ggml type {gtype}")
        aligned = (offset + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        infos.append((name, tuple(arr.shape), gtype, aligned, raw))
        offset = aligned + len(raw)

    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", GGUF_VERSION))
        f.write(struct.pack("<q", len(infos)))
        f.write(struct.pack("<q", len(metadata)))

        for key, val in metadata.items():
            _write_string(f, key)
            if isinstance(val, bool):
                f.write(struct.pack("<i", T_BOOL))
                f.write(struct.pack("<?", val))
            elif isinstance(val, int):
                f.write(struct.pack("<i", T_UINT32))
                f.write(struct.pack("<I", val))
            elif isinstance(val, float):
                f.write(struct.pack("<i", T_FLOAT32))
                f.write(struct.pack("<f", val))
            elif isinstance(val, (str, bytes)):
                f.write(struct.pack("<i", T_STRING))
                _write_string(f, val)
            elif (isinstance(val, (list, tuple))
                  and all(isinstance(x, int) for x in val)):
                f.write(struct.pack("<i", T_ARRAY))
                f.write(struct.pack("<i", T_INT32))
                f.write(struct.pack("<Q", len(val)))
                for x in val:
                    f.write(struct.pack("<i", x))
            else:
                raise ValueError(f"unsupported metadata value for {key}")

        for name, shape, gtype, toffset, _raw in infos:
            _write_string(f, name)
            ne = tuple(reversed(shape)) if shape else (1,)
            f.write(struct.pack("<I", len(ne)))
            for dim in ne:
                f.write(struct.pack("<q", dim))
            f.write(struct.pack("<i", gtype))
            f.write(struct.pack("<Q", toffset))

        pos = f.tell()
        f.write(b"\x00" * ((pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT - pos))
        data_start = f.tell()

        for _name, _shape, _gtype, toffset, raw in infos:
            target = data_start + toffset
            cur = f.tell()
            if target > cur:
                f.write(b"\x00" * (target - cur))
            f.write(raw)


# ---------------------------------------------------------------------------
# Vocab blob helpers (fixed 8-byte NUL-padded entries,
# reference scripts/convert_to_gguf.py:252-260, src/nemo-ggml.cpp:137-146)
# ---------------------------------------------------------------------------

VOCAB_ENTRY_SIZE = 8


def fit_vocab_token(tok: str) -> str:
    """Fit a token into the fixed 8-byte vocab slot (7 content bytes + NUL,
    reference scripts/convert_to_gguf.py:252-260): truncate by encoded UTF-8
    byte length, never mid-codepoint, warning when lossy."""
    enc = tok.encode("utf-8")
    if len(enc) <= VOCAB_ENTRY_SIZE - 1:
        return tok
    cut = enc[: VOCAB_ENTRY_SIZE - 1]
    short = ""
    while cut:
        try:
            short = cut.decode("utf-8")
            break
        except UnicodeDecodeError:
            cut = cut[:-1]
    import warnings

    warnings.warn(f"vocab token {tok!r} exceeds the "
                  f"{VOCAB_ENTRY_SIZE - 1}-byte GGUF entry; "
                  f"truncated to {short!r}")
    return short


def encode_vocab(vocab: list[str]) -> bytes:
    blob = bytearray(len(vocab) * VOCAB_ENTRY_SIZE)
    for i, tok in enumerate(vocab):
        enc = tok.encode("utf-8") + b"\0"
        if len(enc) > VOCAB_ENTRY_SIZE:
            raise ValueError(f"token too long: {tok!r}")
        blob[i * VOCAB_ENTRY_SIZE : i * VOCAB_ENTRY_SIZE + len(enc)] = enc
    return bytes(blob)


def decode_vocab(blob: bytes, vocab_size: int) -> list[str]:
    out = []
    for i in range(vocab_size):
        entry = blob[i * VOCAB_ENTRY_SIZE : (i + 1) * VOCAB_ENTRY_SIZE]
        out.append(entry.split(b"\0", 1)[0].decode("utf-8", errors="replace"))
    return out
