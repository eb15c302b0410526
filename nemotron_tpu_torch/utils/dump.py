"""Binary tensor-dump tracing, wire-compatible with the reference.

The port's own copy of `nemotron_tpu/utils/dump.py` (numpy only): a file
written here is byte-identical to the JAX package's for the same arrays.

Format (reference src/nemo-stream.cpp:886-928 `append_dump_array` and
scripts/my_streaming.py:240-259 `dump_append_data`, read by
scripts/compare_tensors.py:20-30): a 32-byte header of 4 little-endian int64s
holding the REVERSED shape (ggml ne order, unused dims = 1), followed by f32
data, row-major in the original (numpy) order. Appending to an existing dump
grows the leading (time/step) axis; the trailing shape must stay stable --
the same shape-stability assertion the reference enforces.

This lets the reference repo's compare_tensors.py-style differs consume dumps
produced by this framework unchanged, and vice versa (our
scripts/compare_tensors.py reads dumps produced by the reference).
"""

from __future__ import annotations

import os
import struct

import numpy as np

HEADER_BYTES = 32


def _header(shape: tuple[int, ...]) -> bytes:
    ne = list(reversed(shape)) + [1] * (4 - len(shape))
    return struct.pack("<4q", *ne[:4])


def append_dump(path: str, arr: np.ndarray) -> None:
    """Append `arr` to the dump at `path` (creating it with a header).

    The header records the shape of the FIRST append; later appends must
    match its trailing dims and extend the leading axis."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    # canonicalize: leading singleton dims are indistinguishable in the
    # 4x-int64 header (padded with 1s), so strip them; appends then grow the
    # leading (time/step) axis, matching the reference's accumulation
    while arr.ndim > 1 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim > 4:
        raise ValueError(f"dump supports <=4 dims, got {arr.shape}")
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        with open(path, "wb") as f:
            f.write(_header(arr.shape))
            f.write(arr.tobytes())
        return
    with open(path, "rb+") as f:
        ne = struct.unpack("<4q", f.read(HEADER_BYTES))
        shape = tuple(d for d in reversed(ne) if d != 1) or (1,)
        # shape-stability: trailing dims must match
        trailing = arr.shape[1:] if arr.ndim > 1 else ()
        want_trailing = shape[1:] if len(shape) > 1 else ()
        if trailing != want_trailing and arr.shape != shape:
            raise ValueError(
                f"{path}: append shape {arr.shape} incompatible with {shape}")
        f.seek(0, os.SEEK_END)
        f.write(arr.tobytes())


def read_dump(path: str) -> np.ndarray:
    """Read a dump; the leading axis absorbs any appended records."""
    with open(path, "rb") as f:
        ne = struct.unpack("<4q", f.read(HEADER_BYTES))
        data = np.frombuffer(f.read(), dtype=np.float32)
    shape = tuple(d for d in reversed(ne) if d != 1) or (1,)
    trailing = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    if trailing == 0 or data.size % trailing:
        raise ValueError(f"{path}: {data.size} elements not divisible by "
                         f"trailing shape {shape[1:]}")
    return data.reshape((-1,) + shape[1:])


class DumpTracer:
    """Named-tensor capture directory (the reference's my_bin/ convention).

    Enable on a session (`StreamSession(trace_dir=)`) to dump intermediate
    activations per chunk; diff two runs with scripts/compare_tensors.py.
    A tensor is brought to the host as f32 first (bf16 upcast)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def __call__(self, name: str, arr) -> None:
        if hasattr(arr, "detach"):      # a torch tensor, on any device
            arr = arr.detach().float().cpu().numpy()
        append_dump(os.path.join(self.directory, f"{name}.bin"),
                    np.asarray(arr, dtype=np.float32))


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    """Statistics the reference differ prints
    (scripts/compare_tensors.py, docs/STREAMING-v2.md:185-199)."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    n = min(a.size, b.size)
    a, b = a[:n], b[:n]
    d = np.abs(a - b)
    denom = np.maximum(np.abs(a), np.abs(b))
    rel = np.where(denom > 0, d / np.maximum(denom, 1e-30), 0.0)
    corr = float(np.corrcoef(a, b)[0, 1]) if n > 1 and a.std() > 0 and b.std() > 0 else 1.0
    return {
        "n": int(n),
        "max_abs": float(d.max(initial=0.0)),
        "mean_abs": float(d.mean()) if n else 0.0,
        "median_abs": float(np.median(d)) if n else 0.0,
        "max_rel": float(rel.max(initial=0.0)),
        "mean_rel": float(rel.mean()) if n else 0.0,
        "p99_abs": float(np.percentile(d, 99)) if n else 0.0,
        "exact_frac": float((d == 0).mean()) if n else 1.0,
        "corr": corr,
    }
