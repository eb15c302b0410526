"""Elementwise / normalization building blocks.

The port's counterpart of `nemotron_tpu/ops/basic.py`. Semantics match the
reference graph builders (layer_norm: src/nemo-ggml.cpp:470-480; FFN
Linear->SiLU->Linear: :484-500; GLU: src/nemo-stream.cpp:620-636). All
functions are batched over arbitrary leading axes.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import model_copy, model_sum
from .quant import qmm


def layer_norm(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with statistics in f32 whatever the compute dtype, from one
    pass (E[x^2] - mu^2), as the JAX package computes them."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(ms - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor) -> torch.Tensor:
    """[..., 2C] -> [..., C]: first half gated by sigmoid of second half."""
    c = x.shape[-1] // 2
    return x[..., :c] * torch.sigmoid(x[..., c:])


def ffn(x: torch.Tensor, w1, w2, group=None) -> torch.Tensor:
    """Linear -> SiLU -> Linear (no biases in this model). Weights may be
    dense tensors or int8 QTensors. `group`: the model axis over which w1's
    columns and w2's rows are split (the partial products are summed after
    w2; nemotron_tpu/ops/basic.py:37-40 under GSPMD)."""
    return model_sum(qmm(silu(qmm(model_copy(x, group), w1)), w2), group)
