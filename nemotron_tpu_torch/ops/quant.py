"""Int8 encoder weights: weight-only Q8_0, and W8A8 with dynamic or static
activation scales.

The port's counterpart of `nemotron_tpu/ops/quant.py`:

  - A `QTensor` holds int8 values [.., in, out] plus per-block f32 scales
    [.., in//32, out] -- the 32-element blocking of Q8_0 along the
    contraction dim, transposed into x @ w orientation. Numerics match
    round-tripping through the reference's Q8_0 exactly.
  - A `QTensorW8A8` holds int8 values [.., in, out] plus one f32 scale per
    output column; activations are quantized per row on the fly, or with a
    static per-tensor scale from SmoothQuant calibration
    (ops/smoothquant.py) when `act_scale` is set.
  - `qmm` sends a QTensor through the Q8 matmul kernel (ops/quant_kernel.py),
    a QTensorW8A8 through the W8A8 kernel (ops/w8a8_kernel.py) and a dense
    weight through torch.matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .quant_kernel import q8_matmul
from .w8a8_kernel import w8a8_matmul

QK = 32  # Q8_0 block size (elements per scale)


@dataclasses.dataclass
class QTensor:
    """Blockwise-quantized weight in x @ w orientation.

    q:     int8  [..., in, out]
    scale: f32   [..., in // QK, out]   (per 32-row block, per column)
    """

    q: Any
    scale: Any

    def __getitem__(self, i) -> "QTensor":
        """Index the leading (layer) axis of a stacked weight."""
        return QTensor(q=self.q[i], scale=self.scale[i])


def quantize_tensor(w: np.ndarray) -> QTensor:
    """Quantize a [in, out] (or [L, in, out]) f32 weight to Q8_0 blocks along
    the contraction (in) dim, as numpy arrays. Same scale/rounding rule as
    the reference quantizer (scripts/convert_to_gguf.py:93-139): scale =
    amax/127 stored as f16, q = round(w / scale)."""
    w = np.asarray(w, dtype=np.float32)
    *lead, n_in, n_out = w.shape
    if n_in % QK:
        raise ValueError(f"in dim {n_in} not divisible by {QK}")
    blocks = w.reshape(*lead, n_in // QK, QK, n_out)
    amax = np.max(np.abs(blocks), axis=-2)                     # [.., nb, out]
    scale = np.where(amax != 0, amax / 127.0, 0.0).astype(np.float16)
    s32 = scale.astype(np.float32)
    s_safe = np.where(s32 != 0, s32, 1.0)
    q = np.round(blocks / s_safe[..., None, :]).astype(np.int8)
    q = np.where(s32[..., None, :] != 0, q, 0).astype(np.int8)
    return QTensor(q=q.reshape(w.shape), scale=s32)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Expand a QTensor of tensors to a dense tensor in `dtype` (the
    q * scale product is taken in `dtype`, as the JAX package does)."""
    q, scale = qt.q, qt.scale
    *lead, n_in, n_out = q.shape
    w = q.to(dtype).reshape(*lead, n_in // QK, QK, n_out)
    w = w * scale.to(dtype)[..., :, None, :]
    return w.reshape(*lead, n_in, n_out)


@dataclasses.dataclass
class QTensorW8A8:
    """Weight of the dynamic W8A8 path in x @ w orientation.

    q:         int8 [..., in, out]
    col_scale: f32  [..., out]   (one scale per output column)
    act_scale: None, or f32 [...] matching the leading (layer) dims: the
               static activation scale from SmoothQuant calibration; then
               x is quantized as clip(round(x / s), -127, 127), activations
               beyond the calibration range saturating."""

    q: Any
    col_scale: Any
    act_scale: Any = None

    def __getitem__(self, i) -> "QTensorW8A8":
        """Index the leading (layer) axis of a stacked weight."""
        return QTensorW8A8(q=self.q[i], col_scale=self.col_scale[i],
                           act_scale=None if self.act_scale is None
                           else self.act_scale[i])


def quantize_tensor_w8a8(w: np.ndarray) -> QTensorW8A8:
    """Per-output-column symmetric int8 quantization of a [in, out] (or
    [L, in, out]) weight, as numpy arrays (the JAX package's rule)."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.max(np.abs(w), axis=-2)                       # [.., out]
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[..., None, :]), -127, 127).astype(np.int8)
    return QTensorW8A8(q=q, col_scale=scale)


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """x [.., in] @ w [in, out], w a dense tensor, a 2-D QTensor or a 2-D
    QTensorW8A8."""
    if isinstance(w, QTensorW8A8):
        lead = x.shape[:-1]
        out = w8a8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q,
                          w.col_scale, w.act_scale)
        return out.reshape(*lead, w.q.shape[-1])
    if not isinstance(w, QTensor):
        return x @ w.to(x.dtype)
    lead = x.shape[:-1]
    out = q8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q, w.scale)
    return out.reshape(*lead, w.q.shape[-1])


def qmm_shared(x: torch.Tensor, ws: list) -> list:
    """Several matmuls over the same input (the attention q/k/v
    projections). The JAX package quantizes x once for W8A8 weights; here
    each qmm quantizes it again (per row with one group of K = d_model
    columns, or with the static scale SmoothQuant gives all three), which
    gives the same values. Fusing the three products into one kernel is
    later work."""
    return [qmm(x, w) for w in ws]


_ENCODER_MATMUL_SUFFIXES = (
    "feed_forward1.linear1.weight", "feed_forward1.linear2.weight",
    "feed_forward2.linear1.weight", "feed_forward2.linear2.weight",
    "self_attn.linear_q.weight", "self_attn.linear_k.weight",
    "self_attn.linear_v.weight", "self_attn.linear_pos.weight",
    "self_attn.linear_out.weight",
    "conv.pointwise_conv1.weight", "conv.pointwise_conv2.weight",
)


def should_quantize(name: str, arr: np.ndarray) -> bool:
    """The reference's default quant selection
    (scripts/convert_to_gguf.py:212-238)."""
    if not name.startswith("encoder.layers."):
        return False
    if arr.ndim < 2:
        return False
    return name.endswith(_ENCODER_MATMUL_SUFFIXES)
