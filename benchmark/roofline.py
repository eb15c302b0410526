"""The yardstick's arithmetic: the card's peaks, the least time a call's
work could take on it, and the model's FLOPs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense): HBM 3.35 TB/s,
989 TFLOP/s bf16 on the tensor cores, 1979 TOP/s int8, 67 TFLOP/s f32
outside them. They assume the card's full 700 W; a run states its card's
power limit beside every share. A bound is max(bytes / bandwidth,
operations / peak), with each input byte read once and each output byte
written once, counted from the call's shapes, never from the kernel.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def matmul_bound_s(M: int, K: int, N: int, x_dtype: str,
                   w_dtype: str) -> float:
    """One x [M, K] @ w [K, N] -> [M, N] in x's dtype. An int8 weight
    carries one f32 scale a column and runs at the int8 peak."""
    xb, wb = BYTES[x_dtype], BYTES[w_dtype]
    nbytes = M * K * xb + K * N * wb + M * N * xb
    if w_dtype == "int8":
        nbytes += N * 4
    return bound_s(2.0 * M * K * N, nbytes, PEAK[w_dtype])


def attention_bound_s(B: int, H: int, Q: int, KV: int, Dh: int,
                      dtype: str, ring_dtype: str) -> float:
    """One fused ring-attention call: q_u, k_new, v_new [B, H, Q, Dh] and
    the layer's two rings [B, H, KV, Dh] read, the bias a [B, H, Q, KV+Q],
    the per-slot scale columns [B, H, KV] f32 of both rings, the context
    [B, H, Q, Dh] written; scores and context over all KV + Q keys, at the
    compute dtype's peak."""
    db, rb = BYTES[dtype], BYTES[ring_dtype]
    S = KV + Q
    nbytes = (3 * B * H * Q * Dh * db + 2 * B * H * KV * Dh * rb
              + B * H * Q * S * db + 2 * B * H * KV * 4
              + B * H * Q * Dh * db)
    return bound_s(4.0 * B * H * Q * S * Dh, nbytes, PEAK[dtype])


def subsampled(n: int) -> int:
    for _ in range(3):
        n = n // 2 + 1
    return n


def encoder_flops_per_chunk(m: dict, streams: int, R: int) -> float:
    """Model FLOPs of one streaming chunk of the encoder for `streams`
    streams: the subsampling convs and Linear over the chunk's 9 + 8Q mel
    frames, then per kept frame and layer the ten matmuls, the attention
    over the 70 cached frames and the chunk (content, position and context
    products), and the depthwise conv."""
    Q = 1 + R
    D, FF, H, Dh = m["d_model"], m["d_ff"], m["n_heads"], m["d_head"]
    C, L, K = m["subsampling_channels"], m["n_layers"], m["kernel_size"]
    T, F = 9 + 8 * Q, m["n_mels"]
    T1, F1 = T // 2 + 1, F // 2 + 1
    T2, F2 = T1 // 2 + 1, F1 // 2 + 1
    T3, F3 = T2 // 2 + 1, F2 // 2 + 1
    sub = 2 * (9 * C * T1 * F1 + 9 * C * T2 * F2 + C * C * T2 * F2
               + 9 * C * T3 * F3 + C * C * T3 * F3 + T3 * C * F3 * D)
    matmul = 2 * (4 * D * FF + 4 * D * D + 2 * D * D + D * D)
    attn = 6 * H * Dh * (70 + Q)
    conv = 2 * K * D
    return streams * (sub + Q * L * (matmul + attn + conv))


def decoder_flops(m: dict, frames: int, tokens: int) -> float:
    """Model FLOPs of greedy decode over `frames` encoder frames that
    emitted `tokens` labels: a joint encoder projection a frame, an LSTM
    step and a prediction projection a label, and the joint's output
    layer once a decision (each label, and the blank that ends a frame)."""
    D, DD, J, V = m["d_model"], m["decoder_dim"], m["joint_dim"], \
        m["vocab_size"]
    lstm = 2 * m["decoder_layers"] * 2 * DD * 4 * DD
    return (frames * 2 * D * J + tokens * (lstm + 2 * DD * J)
            + (frames + tokens) * 2 * J * V)
