"""Relative-position multi-head attention (Transformer-XL style): over the
streaming encoder's ring-buffered K/V cache, and over a whole utterance
(`rel_pos_mha`, the full-utterance encoder's attention).

The port's counterpart of `nemotron_tpu/ops/rel_attention.py`. The rel-shift
(reference src/nemo-ggml.cpp:548-585, src/nemo-stream.cpp:391-433) selects

    out[i, j] = raw[i, j + Q - 1 - i]

i.e. relative distance (cache + i) - j, because the position table is in
NeMo's descending order. The position bias is computed in time order and
then moved into ring-slot order; the JAX package does that with a one-hot
matmul (a TPU gather is slow), here it is an index gather, with the stale
ring segment's columns set to 0 (the mask hides them).
"""

from __future__ import annotations

import numpy as np
import torch

from .quant import QTensor, QTensorW8A8, dequantize, qmm, qmm_shared
from .ring_attn_kernel import fused_ring_attention


def pos_emb_descending(length_each_side: int, d_model: int) -> np.ndarray:
    """Sinusoidal relative-position table in NeMo's descending order
    (reference src/nemo-ggml.cpp:17-32): row p holds the embedding of
    position value (length_each_side-1) - p."""
    total = 2 * length_each_side - 1
    out = np.zeros((total, d_model), dtype=np.float32)
    positions = (length_each_side - 1) - np.arange(total, dtype=np.float32)
    i = np.arange(0, d_model, 2, dtype=np.float32)
    div = np.exp(-i * np.log(10000.0) / d_model)
    ang = positions[:, None] * div[None, :]
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def rel_shift(pos_raw: torch.Tensor, klen: int) -> torch.Tensor:
    """pos_raw: [..., Q, P] -> [..., Q, klen] with
    out[..., i, j] = pos_raw[..., i, j + Q - 1 - i].

    The Transformer-XL pad -> reshape -> drop -> slice skew (requires
    P >= Q - 1 + klen, which P = 2*klen-1 satisfies since klen >= Q)."""
    *lead, Q, P = pos_raw.shape
    padded = torch.nn.functional.pad(pos_raw, (1, 0))
    skewed = padded.reshape(*lead, P + 1, Q)[..., 1:, :]
    return skewed.reshape(*lead, Q, P)[..., :klen]


def chron_to_slot(pos_chron: torch.Tensor, chron: torch.Tensor) -> torch.Tensor:
    """Move the time-ordered bias [..., kv] into ring-slot order
    [..., kv+Q]: column j takes time index chron[j], or 0 where chron[j]
    falls outside [0, kv) (the stale segment). The gather takes the place of
    the JAX package's one-hot `pos_perm` matmul and gives the same values."""
    kv = pos_chron.shape[-1]
    valid = (chron >= 0) & (chron < kv)
    g = pos_chron.index_select(-1, chron.clamp(0, kv - 1))
    return torch.where(valid, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))


def _heads(t: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    """[B, Q, D] -> [B, H, Q, Dh] (head-major), contiguous."""
    B, Q, _ = t.shape
    return t.reshape(B, Q, n_heads, d_head).transpose(1, 2).contiguous()


def _pos_raw(q_v: torch.Tensor, pos_heads: torch.Tensor) -> torch.Tensor:
    """q_v [B, H, Q, Dh] against the projected position table [P, H, Dh]:
    [B, H, Q, P], summed in f32 and rounded to the compute dtype, as the
    JAX package rounds it (nemotron_tpu/ops/rel_attention.py:124-126,
    285-294)."""
    dt = q_v.dtype
    f32 = torch.float32
    return torch.einsum("bhid,phd->bhip", q_v.to(f32),
                        pos_heads.to(dt).to(f32)).to(dt)


def _pos_attn(q_v, pos_heads, kv: int, chron):
    """Position bias in ring-slot order [B, H, Q, kv+Q], f32."""
    pos_chron = rel_shift(_pos_raw(q_v, pos_heads), kv)
    return chron_to_slot(pos_chron, chron).to(torch.float32)


def _softmax(content: torch.Tensor, pos_attn: torch.Tensor, mask,
             d_head: int) -> torch.Tensor:
    """Attention weights from the content and position scores (both in the
    compute dtype): f32 math inside compute-dtype storage at the JAX
    package's rounding points (nemotron_tpu/ops/rel_attention.py:64-77):
    the scaled scores and the additive mask in the compute dtype, exp in
    f32, the row sum with an f32 accumulator."""
    dt = content.dtype
    f32 = torch.float32
    scale = torch.tensor(1.0 / np.sqrt(d_head), dtype=f32,
                         device=content.device).to(dt)
    scores = (content + pos_attn) * scale
    if mask is not None:
        scores = scores + mask.to(dt)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp((scores - m).to(f32)).to(dt)
    s = e.to(f32).sum(dim=-1, keepdim=True)
    return (e.to(f32) / s).to(dt)


def rel_pos_mha(lp, x, pos_heads, n_heads: int, d_head: int,
                kv_cache=None, mask=None):
    """Relative-position MHA in batch mode, or over the legacy shift cache
    (nemotron_tpu/ops/rel_attention.py:80-132). Plain tensor code: the JAX
    package leaves this attention to XLA too.

    x: [B, Q, D] (the attention's post-norm input).
    pos_heads: [P, H, Dh], the position table already projected through
        linear_pos; P = 2 * (cache + Q) - 1, cache being 0 in batch mode.
    kv_cache: optional (k_cache, v_cache), each [B, C, D]: keys and values
        become concat(cache, new), and the last C frames are returned as the
        new caches (reference src/nemo-stream.cpp:457-484).
    mask: optional additive mask broadcastable to [B, 1, Q, kv]
        (0 = valid, -1e9 = masked).

    Returns (out [B, Q, D], new_k_cache, new_v_cache)."""
    B, Q, D = x.shape
    dt = x.dtype
    f32 = torch.float32
    q, k_full, v_full = qmm_shared(x, [lp.attn_q_w, lp.attn_k_w,
                                       lp.attn_v_w])
    new_k_cache = new_v_cache = None
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        C = k_cache.shape[1]
        k_full = torch.cat([k_cache.to(dt), k_full], dim=1)
        v_full = torch.cat([v_cache.to(dt), v_full], dim=1)
        new_k_cache, new_v_cache = k_full[:, -C:, :], v_full[:, -C:, :]
    kv = k_full.shape[1]
    q, k, v = (_heads(t, n_heads, d_head) for t in (q, k_full, v_full))
    q_u = q + lp.pos_bias_u.to(dt)[None, :, None, :]
    q_v = q + lp.pos_bias_v.to(dt)[None, :, None, :]

    content = torch.einsum("bhid,bhjd->bhij", q_u.to(f32), k.to(f32)).to(dt)
    pos_attn = rel_shift(_pos_raw(q_v, pos_heads), kv)
    w = _softmax(content, pos_attn, mask, d_head)
    ctx = torch.einsum("bhij,bhjd->bhid", w.to(f32), v.to(f32)).to(dt)
    ctx = ctx.transpose(1, 2).reshape(B, Q, D)
    return qmm(ctx, lp.attn_out_w), new_k_cache, new_v_cache


def rel_pos_mha_ring(lp, x, pos_heads, n_heads: int, d_head: int,
                     k_ring, v_ring, chron, mask,
                     k_scale_cols=None, v_scale_cols=None):
    """Relative-position MHA over ONE layer's ring [B, H, KV, Dh]: the plain
    path (nemotron_tpu/ops/rel_attention.py:148-251), with the current
    chunk's keys/values attended as Q extra slots after the ring.

    chron [KV+Q] int64: the time index of each slot (see chron_to_slot).
    mask [B|1, 1, 1|Q, KV+Q]: additive validity mask in slot order.
    Returns (out [B, Q, D], k_new [B, H, Q, Dh], v_new [B, H, Q, Dh])."""
    B, Q, D = x.shape
    dt = x.dtype
    f32 = torch.float32
    q, k_new, v_new = (_heads(t, n_heads, d_head) for t in qmm_shared(
        x, [lp.attn_q_w, lp.attn_k_w, lp.attn_v_w]))
    kv = k_ring.shape[2]
    k_r, v_r = k_ring.to(dt), v_ring.to(dt)
    q_u = q + lp.pos_bias_u.to(dt)[None, :, None, :]
    q_v = q + lp.pos_bias_v.to(dt)[None, :, None, :]

    content_r = torch.einsum("bhid,bhjd->bhij", q_u.to(f32), k_r.to(f32))
    if k_scale_cols is not None:
        content_r = content_r * k_scale_cols[:, :, None, :]
    content = torch.cat([
        content_r.to(dt),
        torch.einsum("bhid,bhjd->bhij", q_u.to(f32), k_new.to(f32)).to(dt),
    ], dim=-1)
    pos_attn = _pos_attn(q_v, pos_heads, kv, chron).to(dt)
    w = _softmax(content, pos_attn, mask, d_head)

    w_r = w[..., :kv]
    if v_scale_cols is not None:
        w_r = (w_r.to(f32) * v_scale_cols[:, :, None, :]).to(dt)
    ctx = (torch.einsum("bhij,bhjd->bhid", w_r.to(f32), v_r.to(f32))
           + torch.einsum("bhij,bhjd->bhid", w[..., kv:].to(f32),
                          v_new.to(f32))).to(dt)
    ctx = ctx.transpose(1, 2).reshape(B, Q, D)
    return qmm(ctx, lp.attn_out_w), k_new, v_new


def rel_pos_mha_ring_fused(lp, x, pos_heads, n_heads: int, d_head: int,
                           layer_idx: int, k_ring_all, v_ring_all, chron,
                           mask, k_cols, v_cols):
    """rel_pos_mha_ring with ring reads, scores, softmax and context fused
    into one kernel (ops/ring_attn_kernel.py). The rings are the FULL
    stacked [L, B, H, KV, Dh] tensors; the kernel reads layer `layer_idx`
    in place. a = pos_bias / sqrt(Dh) + mask is built here, in f32, and
    handed over in the compute dtype.

    k_cols/v_cols [B, H, KV] f32: per-slot dequant columns (ones if dense).
    Returns (out [B, Q, D], k_new [B, H, Q, Dh], v_new [B, H, Q, Dh])."""
    B, Q, D = x.shape
    dt = x.dtype
    q, k_new, v_new = (_heads(t, n_heads, d_head) for t in qmm_shared(
        x, [lp.attn_q_w, lp.attn_k_w, lp.attn_v_w]))
    kv = k_ring_all.shape[3]
    q_u = (q + lp.pos_bias_u.to(dt)[None, :, None, :]).contiguous()
    q_v = q + lp.pos_bias_v.to(dt)[None, :, None, :]

    pos_attn = _pos_attn(q_v, pos_heads, kv, chron)
    scale = np.float32(1.0 / np.sqrt(d_head)).item()
    a = (pos_attn * scale + mask.to(torch.float32)).to(dt)
    a = a.expand(B, n_heads, Q, kv + Q).contiguous()

    ctx = fused_ring_attention(layer_idx, q_u, k_new, v_new, k_ring_all,
                               v_ring_all, a, k_cols, v_cols)
    ctx = ctx.transpose(1, 2).reshape(B, Q, D)
    return qmm(ctx, lp.attn_out_w), k_new, v_new


def project_pos(lp_pos_w, pos_emb: torch.Tensor, n_heads: int,
                d_head: int) -> torch.Tensor:
    """pos_emb [P, D] @ linear_pos -> [P, H, Dh], dequantizing a quantized
    weight first, in pos_emb's dtype. Precomputed once per session, not
    once per chunk."""
    if isinstance(lp_pos_w, QTensor):
        lp_pos_w = dequantize(lp_pos_w, pos_emb.dtype)
    elif isinstance(lp_pos_w, QTensorW8A8):
        lp_pos_w = (lp_pos_w.q.to(pos_emb.dtype)
                    * lp_pos_w.col_scale.to(pos_emb.dtype))
    P = pos_emb.shape[0]
    return (pos_emb @ lp_pos_w.to(pos_emb.dtype)).reshape(P, n_heads, d_head)
