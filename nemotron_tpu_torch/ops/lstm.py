"""Batched 2-layer LSTM step for the RNN-T prediction network.

The port's counterpart of `nemotron_tpu/ops/lstm.py`. Gate order [i, f, g, o]
matches PyTorch / the reference (reference src/nemo-ggml.cpp:503-542,
docs/TENSOR_SHAPES.md:112-129).
"""

from __future__ import annotations

import torch


def lstm_step(dp, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One step through all LSTM layers of DecoderParams `dp`.

    x: [B, in]; h, c: [B, L, H]. Returns (top hidden [B, H], h', c').
    The weights are stacked [L, ...] tensors or sequences of L tensors
    (unbound once by a caller that steps many times under autograd)."""
    n_layers = len(dp.w_ih)
    H = h.shape[-1]
    dt = x.dtype
    hs, cs = [], []
    for l in range(n_layers):
        gates = (x @ dp.w_ih[l].to(dt) + h[:, l] @ dp.w_hh[l].to(dt)
                 + dp.b_ih[l].to(dt) + dp.b_hh[l].to(dt))
        i = torch.sigmoid(gates[:, 0 * H:1 * H])
        f = torch.sigmoid(gates[:, 1 * H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c_l = f * c[:, l] + i * g
        h_l = o * torch.tanh(c_l)
        hs.append(h_l)
        cs.append(c_l)
        x = h_l
    return x, torch.stack(hs, dim=1), torch.stack(cs, dim=1)
