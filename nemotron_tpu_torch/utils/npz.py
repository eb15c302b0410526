"""Snapshot leaves in `.npz` files, in the JAX package's format
(`nemotron_tpu/utils/npz.py`), so that snapshots interchange both ways.

numpy has no bfloat16, so a bf16 leaf is written upcast to float32, which
is exact (bf16 values are a subset of f32) and is what the JAX package
writes. Legacy JAX snapshots that stored bf16 as raw 2-byte void ('|V2')
leaves are read back by viewing those bytes as bf16. The reader restores
each leaf in the dtype its state wants, so an f32 leaf becomes bf16 again
without rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(t) -> np.ndarray:
    """A leaf for a snapshot: a tensor as a numpy copy on the host (bf16
    upcast to f32; never a view of a tensor that is written in place), or
    an array as it is."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.asarray(t)


def npz_decode(a) -> np.ndarray | torch.Tensor:
    """A leaf as read from a snapshot: a legacy '|V2' bf16 leaf as a bf16
    tensor, anything else unchanged."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return a


def to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A snapshot leaf as a fresh tensor of `dtype` on `device` (never a
    view of the array it came from: the rings are written in place)."""
    if not isinstance(a, torch.Tensor):
        a = npz_decode(a)
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).clone()
    return torch.tensor(np.ascontiguousarray(a)).to(device=device,
                                                    dtype=dtype)


def savez(path: str, flat: dict) -> None:
    """Write a flat {key: leaf} snapshot (tensors through to_numpy)."""
    np.savez(path, **{k: to_numpy(v) for k, v in flat.items()})


class NpzView:
    """An np.load result with npz_decode applied on every read."""

    def __init__(self, z):
        self._z = z

    @property
    def files(self):
        return self._z.files

    def __getitem__(self, k):
        return npz_decode(self._z[k])

    def __contains__(self, k):
        return k in self._z.files
