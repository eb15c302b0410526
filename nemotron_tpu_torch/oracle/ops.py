"""Naive numpy ops for the test oracle (the port's own copy of
`nemotron_tpu/oracle/ops.py`: numpy only, sharing no code with the torch
model it checks).

Mirrors reference src/reference/ops.cpp semantics (linear, layer_norm, convs,
glu, lstm_cell, softmax) with numpy loops replaced by the obvious vectorized
equivalents. Shapes are single-sequence: [T, D] (batch=1 implicit).
"""

from __future__ import annotations

import numpy as np


def linear(x: np.ndarray, w_out_in: np.ndarray, b: np.ndarray | None = None) -> np.ndarray:
    """x: [..., in]; w: [out, in] (PyTorch order)."""
    y = x @ w_out_in.T
    if b is not None:
        y = y + b
    return y


def layer_norm(x: np.ndarray, w: np.ndarray, b: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * w + b


def silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def glu(x: np.ndarray) -> np.ndarray:
    """[..., 2C] -> [..., C]: a * sigmoid(b) with a first half, b second half
    (reference src/nemo-stream.cpp:620-636)."""
    c = x.shape[-1] // 2
    return x[..., :c] * sigmoid(x[..., c:])


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def causal_conv2d(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                  stride: int, groups: int = 1) -> np.ndarray:
    """Causal 2D conv, naive implementation.

    x: [T, F, Cin]; w: [O, Cin/groups, kT, kF] (PyTorch OIHW); stride applies
    to both dims. Padding: left/top = k-1, right/bottom = stride-1
    (reference src/nemo-ggml.cpp:828-835).
    """
    O, Ig, kT, kF = w.shape
    T, F, Cin = x.shape
    pt, pb = kT - 1, stride - 1
    pl, pr = kF - 1, stride - 1
    xp = np.pad(x, ((pt, pb), (pl, pr), (0, 0)))
    Tp, Fp = xp.shape[:2]
    To = (Tp - kT) // stride + 1
    Fo = (Fp - kF) // stride + 1
    out = np.zeros((To, Fo, O), dtype=np.float64)
    in_per_group = Cin // groups
    out_per_group = O // groups
    for o in range(O):
        g = o // out_per_group
        for dt in range(kT):
            for df in range(kF):
                patch = xp[dt : dt + To * stride : stride,
                           df : df + Fo * stride : stride,
                           g * in_per_group : (g + 1) * in_per_group]
                out[:, :, o] += patch @ w[o, :, dt, df]
    return (out + b).astype(np.float32)


def causal_conv1d_depthwise(x: np.ndarray, w_kd: np.ndarray,
                            cache: np.ndarray | None = None) -> np.ndarray:
    """Depthwise causal conv1d. x: [T, D]; w: [K, D].

    If `cache` [K-1, D] is given it is prepended instead of zero padding
    (reference src/nemo-stream.cpp:308-384)."""
    K, D = w_kd.shape
    pad = cache if cache is not None else np.zeros((K - 1, D), dtype=x.dtype)
    xp = np.concatenate([pad, x], axis=0)
    T = x.shape[0]
    out = np.zeros((T, D), dtype=np.float64)
    for k in range(K):
        out += xp[k : k + T] * w_kd[k]
    return out.astype(np.float32)


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """PyTorch LSTM cell with [i, f, g, o] gate order
    (docs/TENSOR_SHAPES.md:112-129). w_*: [4H, in]."""
    H = h.shape[-1]
    gates = x @ w_ih.T + h @ w_hh.T + b_ih + b_hh
    i = sigmoid(gates[..., 0 * H : 1 * H])
    f = sigmoid(gates[..., 1 * H : 2 * H])
    g = np.tanh(gates[..., 2 * H : 3 * H])
    o = sigmoid(gates[..., 3 * H : 4 * H])
    c_new = f * c + i * g
    h_new = o * np.tanh(c_new)
    return h_new, c_new


def pos_emb_descending(length_each_side: int, d_model: int) -> np.ndarray:
    """Sinusoidal relative positions in NeMo's descending order:
    row p holds position value (length_each_side-1) - p, for
    p in [0, 2*length_each_side-1)
    (reference src/nemo-ggml.cpp:17-32)."""
    total = 2 * length_each_side - 1
    out = np.zeros((total, d_model), dtype=np.float32)
    positions = (length_each_side - 1) - np.arange(total, dtype=np.float32)
    i = np.arange(0, d_model, 2, dtype=np.float32)
    div = np.exp(-i * np.log(10000.0) / d_model)  # [d/2]
    ang = positions[:, None] * div[None, :]
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def rel_shift(x: np.ndarray) -> np.ndarray:
    """Batch rel-shift: x [H, Q, 2Q-1] -> out [H, Q, Q];
    out[h,i,j] = x[h, i, j + Q - 1 - i]
    (reference src/reference/conformer_modules.cpp:188-240)."""
    Hh, Q, P = x.shape
    out = np.zeros((Hh, Q, Q), dtype=x.dtype)
    for i in range(Q):
        out[:, i, :] = x[:, i, Q - 1 - i : 2 * Q - 1 - i]
    return out


def rel_shift_cached(x: np.ndarray, klen: int) -> np.ndarray:
    """Cached rel-shift: x [H, Q, P] with P = 2*(cache+Q)-1 -> out [H, Q, klen];
    out[h,i,j] = x[h, i, j + Q - 1 - i]
    (reference src/nemo-stream.cpp:391-433; see derivation in the module doc
    of nemotron_tpu_torch.ops.rel_attention)."""
    Hh, Q, P = x.shape
    out = np.zeros((Hh, Q, klen), dtype=x.dtype)
    for i in range(Q):
        out[:, i, :] = x[:, i, Q - 1 - i : Q - 1 - i + klen]
    return out
