"""FastConformer encoder: full utterance (`encode_batch`) and the
cache-aware streaming step (`encode_chunk`).

The port's counterpart of `nemotron_tpu/models/encoder.py`. The
full-utterance encoder attends over the whole utterance, masked by
per-utterance lengths and, for streaming-equivalent visibility, by chunks;
for training it can recompute each layer in the backward pass (`remat`).
The streaming step:

  - All streaming state is an explicit `EncoderState` of fixed-shape
    tensors. The K/V attention window is a head-major RING buffer
    [L, B, H, KV, Dh]; one segment is rewritten per chunk (the reference's
    concat+keep-last-70 graph rewrites the full window every chunk,
    src/nemo-stream.cpp:465-484).
  - The rings are dense in the compute dtype, or int8 or int4 (packed two
    a byte) with one scale per (layer, stream, head, segment)
    (`cc.kv_cache_int8`, `cc.kv_cache_int4`), or one shared x-ring of
    post-norm activations from which each layer recomputes its K/V
    (`cc.shared_cache`, dense or int8).
  - Per-layer right context (`cc.att_right_context_by_layer`) and the
    strict intra-chunk lookahead limit (`cc.strict_right_context`) are
    additive masks on the attention's bias, so the kernel is unchanged.
  - Cold-cache validity masking is data (an additive mask computed from
    `valid_len`), not shape.
  - Position embeddings are projected through linear_pos once per session.
  - Attention goes through the fused ring-attention kernel, which reads each
    layer's ring slice in place from the stacked rings (the recomputed K/V
    of the shared x-ring as a one-layer stack).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from ..config import CacheConfig, ModelConfig
from ..ops.basic import ffn, layer_norm
from ..ops.conv import conformer_conv_module, conv_subsampling
from ..ops.quant import qmm
from ..ops.rel_attention import (pos_emb_descending, project_pos,
                                 rel_pos_mha, rel_pos_mha_ring_fused)
from ..ops.ring_attn_kernel import pack_int4


def _conformer_block(lp, x, attention, conv_cache, ln_capture=None):
    """The residual structure of one conformer layer (reference
    src/nemo-ggml.cpp:768-813) around `attention(norm_attn) -> (out, new_k,
    new_v)`. Returns (y, new_k, new_v, new_conv_cache, norm_attn).
    ln_capture: a dict that receives the four LayerNorm outputs that feed
    quantized matmuls, by site name (what SmoothQuant calibrates on)."""
    cap = {} if ln_capture is None else ln_capture
    r = x
    cur = cap["norm_ff1"] = layer_norm(r, lp.norm_ff1_w, lp.norm_ff1_b)
    r = r + 0.5 * ffn(cur, lp.ffn1_w1, lp.ffn1_w2)

    norm_attn = cap["norm_attn"] = layer_norm(r, lp.norm_attn_w,
                                              lp.norm_attn_b)
    attn, new_k, new_v = attention(norm_attn)
    r = r + attn

    cur = cap["norm_conv"] = layer_norm(r, lp.norm_conv_w, lp.norm_conv_b)
    conv, new_conv = conformer_conv_module(lp, cur, conv_cache)
    r = r + conv

    cur = cap["norm_ff2"] = layer_norm(r, lp.norm_ff2_w, lp.norm_ff2_b)
    r = r + 0.5 * ffn(cur, lp.ffn2_w1, lp.ffn2_w2)
    return (layer_norm(r, lp.norm_final_w, lp.norm_final_b), new_k, new_v,
            new_conv, norm_attn)


def conformer_layer(lp, x, pos_heads, mask, conv_cache, layer_idx: int,
                    k_ring_all, v_ring_all, chron, k_cols, v_cols, *,
                    n_heads: int, d_head: int, packed_int4: bool = False):
    """One conformer layer over the ring cache (packed_int4: nibble-pair
    rings). Returns
    (y, new_k [B, H, Q, Dh], new_v, new_conv_cache, norm_attn [B, Q, D]),
    norm_attn being the attention's input (what the shared x-ring keeps)."""
    return _conformer_block(lp, x, lambda a: rel_pos_mha_ring_fused(
        lp, a, pos_heads, n_heads, d_head, layer_idx, k_ring_all,
        v_ring_all, chron, mask, k_cols, v_cols, packed_int4), conv_cache)


def conformer_layer_batch(lp, x, pos_heads, mask=None, *, n_heads: int,
                          d_head: int, ln_capture=None) -> torch.Tensor:
    """One conformer layer over whole utterances (no caches; the depthwise
    conv zero-pads its causal history): x [B, T', D] -> [B, T', D].
    ln_capture: see _conformer_block."""
    return _conformer_block(lp, x, lambda a: rel_pos_mha(
        lp, a, pos_heads, n_heads, d_head, mask=mask), None, ln_capture)[0]


def encode_batch(params, cfg: ModelConfig, mel: torch.Tensor,
                 enc_lengths=None, att_chunk: int | None = None,
                 att_left: int = 70, ln_capture: list | None = None,
                 remat: bool = False) -> torch.Tensor:
    """Full-utterance encoder (nemotron_tpu/models/encoder.py:105-156):
    mel [B, T, n_mels] -> [B, T', d_model], in mel's dtype.

    The position table is sized per call (no length cap) and projected
    through linear_pos in every layer, dequantizing a quantized weight.

    enc_lengths [B] int (encoder frames): keys at or beyond an utterance's
    length are masked out of every query's attention. As in the JAX
    package nothing else is masked: the subsampling and the depthwise conv
    are causal (the last real frame's subsampling window still takes in
    the first padded mel frame, a zero in transcribe_batch's batches).

    att_chunk (encoder frames): streaming-equivalent visibility -- frame i
    attends to its own chunk [c*C, (c+1)*C) and the `att_left` frames
    before the chunk's start, as the cache-aware streaming step sees it.

    ln_capture: a list that receives one dict a layer of the LayerNorm
    outputs that feed quantized matmuls (see _conformer_block).

    remat: with gradients on, each layer (its position projection
    included, as the JAX package's checkpointed scan body) runs under
    torch.utils.checkpoint and is recomputed in the backward pass, so the
    activations kept for it are one layer's input, not all its
    intermediates."""
    dev = mel.device
    x = conv_subsampling(params.subsampling, mel)
    Tp = x.shape[1]
    pos = torch.from_numpy(pos_emb_descending(Tp, cfg.d_model)).to(
        device=dev, dtype=x.dtype)

    f32 = torch.float32
    mask = None
    j = torch.arange(Tp, dtype=torch.int32, device=dev)
    if enc_lengths is not None:
        invalid = j[None, :] >= enc_lengths.to(dev)[:, None]       # [B, T']
        mask = torch.where(invalid, -1e9, 0.0).to(f32)[:, None, None, :]
    if att_chunk is not None:
        start = (j // att_chunk) * att_chunk                       # [T']
        vis = ((j[None, :] < start[:, None] + att_chunk)
               & (j[None, :] >= start[:, None] - att_left))        # [T', T']
        cmask = torch.where(vis, 0.0, -1e9).to(f32)[None, None]
        mask = cmask if mask is None else mask + cmask

    lps = params.layers.unstack(cfg.n_layers)

    def layer(x, l, cap=None):
        lp = lps[l]
        pos_heads = project_pos(lp.attn_pos_w, pos, cfg.n_heads, cfg.d_head)
        return conformer_layer_batch(lp, x, pos_heads, mask,
                                     n_heads=cfg.n_heads, d_head=cfg.d_head,
                                     ln_capture=cap)

    checkpointed = remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(layer, x, l,
                                                  use_reentrant=False)
            continue
        cap = None if ln_capture is None else {}
        x = layer(x, l, cap)
        if cap is not None:
            ln_capture.append(cap)
    return x


@dataclasses.dataclass
class EncoderState:
    """Per-stream encoder caches, batched over the stream axis (the second
    dim of each [L, B, ...] leaf).

    The K/V caches are RING buffers of kv_len = C + chunk slots holding the
    last n_seg = kv_len/chunk chunks per layer; `phase` [B] is the next
    segment each stream will overwrite. `valid_len` mirrors the reference's
    host-side cache_valid_len (src/nemo-stream.h:239)."""

    k_cache: Any      # [L, B, H, KV, Dh] ring (head-major), compute dtype,
    v_cache: Any      #   or int8 (cc.kv_cache_int8); [L, B, H, KV, Dh/2]
    #                     int8 nibble pairs (cc.kv_cache_int4, element 2i
    #                     in the low nibble). cc.shared_cache:
    #                     k_cache is the x-ring [L, B, 1, KV, D] of the
    #                     attention's post-norm inputs and v_cache an empty
    #                     [L, B, 1, KV, 0] placeholder (the JAX layout).
    k_scale: Any      # [L, B, H|1, n_seg] f32 per-segment dequant scales
    v_scale: Any      #   (ones where the ring is not quantized)
    conv_cache: Any   # [L, B, K-1, D]
    valid_len: Any    # [B] int32 (valid cached frames, capped at C)
    phase: Any        # [B] int32 (next ring segment to write)


def init_encoder_state(cfg: ModelConfig, cc: CacheConfig, batch: int,
                       dtype: torch.dtype, device) -> EncoderState:
    """Zeroed caches for `batch` streams on `device`: the split ring in the
    compute dtype (f32 or bf16), in int8 or in packed int4 (Dh/2 bytes a
    row), or the shared x-ring."""
    kv = cc.kv_len
    if kv % cc.chunk_enc_len:
        raise ValueError(f"kv_len {kv} must be a multiple of chunk_enc_len "
                         f"{cc.chunk_enc_len} for the ring cache")
    L, D, H, DH = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head
    n_seg = kv // cc.chunk_enc_len
    ring_dtype = torch.int8 if cc.kv_quant_max is not None else dtype
    if cc.shared_cache:
        k_shape, v_shape, heads = (L, batch, 1, kv, D), (L, batch, 1, kv, 0), 1
    else:
        d_ring = DH // 2 if cc.kv_cache_int4 else DH
        k_shape = v_shape = (L, batch, H, kv, d_ring)
        heads = H
    kw = dict(device=device)
    return EncoderState(
        k_cache=torch.zeros(k_shape, dtype=ring_dtype, **kw),
        v_cache=torch.zeros(v_shape, dtype=ring_dtype, **kw),
        k_scale=torch.ones((L, batch, heads, n_seg), dtype=torch.float32,
                           **kw),
        v_scale=torch.ones((L, batch, heads, n_seg), dtype=torch.float32,
                           **kw),
        conv_cache=torch.zeros((L, batch, cc.conv_cache_size, D), dtype=dtype,
                               **kw),
        valid_len=torch.zeros((batch,), dtype=torch.int32, **kw),
        phase=torch.zeros((batch,), dtype=torch.int32, **kw),
    )


def precompute_pos_heads(params, cfg: ModelConfig, cc: CacheConfig,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[L, P, H, Dh] in `dtype`: per-layer linear_pos projection of the
    streaming pos-emb slice, hoisted out of the chunk step."""
    pos = torch.from_numpy(pos_emb_descending(cc.kv_len, cfg.d_model)).to(
        device=params.device, dtype=dtype)
    w = params.layers.attn_pos_w
    return torch.stack([project_pos(w[l], pos, cfg.n_heads, cfg.d_head)
                        for l in range(cfg.n_layers)])


def _quantize_segment(seg: torch.Tensor, qmax: int, int4: bool):
    """One new ring segment [L, B, H, Q, Dh] -> (int8 values, or int4 pairs
    packed into [L, B, H, Q, Dh/2] bytes; f32 scales [L, B, H]): one scale
    per (layer, stream, head), amax / qmax with a divide, as the JAX
    package's quant_seg (encoder.py:478-494)."""
    f32 = seg.to(torch.float32)
    amax = f32.abs().amax(dim=(-2, -1))
    sc = torch.clamp_min(amax, 1e-12) / qmax
    q = torch.clamp(torch.round(f32 / sc[..., None, None]), -qmax,
                    qmax).to(torch.int8)
    return (pack_int4(q) if int4 else q), sc


def encode_chunk(params, cfg: ModelConfig, cc: CacheConfig,
                 mel_chunk: torch.Tensor, state: EncoderState,
                 pos_heads: torch.Tensor, step_mask=None):
    """One streaming encoder step (reference src/nemo-stream.cpp:961-1030):
    subsampling, dropping drop_extra_pre_encoded overlap frames,
    validity-masked cached layers, valid_len bump, valid_out truncation.

    mel_chunk: [B, chunk_mel_frames, n_mels]; pos_heads [L, P, H, Dh].
    Returns (enc_out [B, valid_out_len, d_model], new EncoderState).

    The rings are written IN PLACE: `state.k_cache`/`v_cache` are the same
    tensors in the returned state, with this chunk's segment overwritten
    (the JAX package donates the buffers to XLA instead), and so are the
    per-segment scales of quantized rings.

    step_mask [B] bool (continuous batching): streams marked False do not
    advance. Their segment bytes, scales, conv cache, valid_len and phase
    come out bit-equal to what went in, and their rows of enc_out are to
    be discarded (the layers still run over every row).

    Right context: cc.strict_right_context masks keys more than R frames
    ahead of each query inside the chunk, and cc.att_right_context_by_layer
    gives each layer its own limit (NeMo's per-layer-group lookahead), both
    as the JAX package builds them (encoder.py:335-339, 383-386); the
    masks ride the attention's additive bias into the kernel."""
    dev = mel_chunk.device
    x = conv_subsampling(params.subsampling, mel_chunk)
    x = x[:, cc.drop_extra_pre_encoded:, :]
    B, Q, _ = x.shape

    C = cc.att_left_context
    kv = C + Q
    n_seg = kv // Q

    # Ring geometry (slot order): segment s = slots [s*Q, (s+1)*Q) holds the
    # chunk written a = ((phase-1-s) mod n_seg) + 1 chunks ago (a = n_seg:
    # the stale segment about to be overwritten, outside the window). The
    # CURRENT chunk occupies Q virtual slots appended after the ring.
    # All advancing streams share one phase (the serving engine realigns a
    # lagging stream's ring before it advances again); a caller that passes
    # mixed phases gets NaN output (loud instead of wrong). Frozen streams
    # keep stale phases and take no part in either.
    if step_mask is None:
        phase_s = state.phase[0].to(torch.int64)
        phase_uniform = (state.phase == state.phase[0]).all()
    else:
        step_mask = step_mask.to(dev, torch.bool)
        phase_s = torch.where(step_mask, state.phase, -1).amax().to(
            torch.int64)
        phase_uniform = torch.where(step_mask, state.phase == phase_s,
                                    True).all()
        # no stream advances: write segment 0 back unchanged (as the JAX
        # package's clamped slice does)
        phase_s = phase_s.clamp_min(0)
    j = torch.arange(kv, device=dev)
    s_j, o_j = j // Q, j % Q
    age = torch.remainder(phase_s - 1 - s_j, n_seg) + 1            # [kv]

    # time index of each slot, for moving the position bias into slot
    # order (the stale segment maps below 0 -> a zero column, masked)
    chron_ring = (n_seg - 1 - age) * Q + o_j
    chron_new = (n_seg - 1) * Q + torch.arange(Q, device=dev)
    chron = torch.cat([chron_ring, chron_new])                      # [kv+Q]

    # validity: a ring slot is valid iff its whole segment is within the
    # cached window; the appended current chunk is always valid
    ring_valid = (age[None, :] * Q) <= state.valid_len[:, None]     # [B, kv]
    valid = torch.cat([ring_valid,
                       torch.ones((B, Q), dtype=torch.bool, device=dev)], -1)
    mask = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None, :]

    # distance from query i to each key: i - o_j + Q * age for ring slots,
    # i - i' for the current chunk; a key more than R ahead is at d < -R
    i = torch.arange(Q, device=dev)
    d = torch.cat([i[:, None] - o_j[None, :] + Q * age[None, :],
                   i[:, None] - i[None, :]], dim=-1)              # [Q, kv+Q]

    def lookahead(r: int) -> torch.Tensor:
        return torch.where(d < -r, -1e9, 0.0).to(torch.float32)[None, None]

    if cc.strict_right_context:
        mask = mask + lookahead(cc.att_right_context)
    rcs = cc.rc_schedule(cfg.n_layers)
    layer_masks = ([mask] * cfg.n_layers if rcs is None else
                   [mask + lookahead(r) for r in rcs])

    H, Dh = cfg.n_heads, cfg.d_head
    quant = cc.kv_quant_max is not None
    shared = cc.shared_cache
    if quant:
        # per-segment dequant scales expanded to per-slot columns
        k_cols_all = state.k_scale.repeat_interleave(Q, -1)      # [L,B,H,kv]
        v_cols_all = state.v_scale.repeat_interleave(Q, -1)
    ones = torch.ones((B, H, kv), dtype=torch.float32, device=dev)
    new_k, new_v, new_conv = [], [], []
    for l in range(cfg.n_layers):
        lp = params.layers.layer(l)
        if shared:
            # shared x-ring: dequantize the cached activations and recompute
            # this layer's K/V from them (encoder.py:396-424 of the JAX
            # package); the kernel reads them as a one-layer stack with ones
            # columns, the dequant having happened before the projection
            x_r = state.k_cache[l][:, 0]                            # [B,kv,D]
            if quant:
                x_r = x_r.to(torch.float32) * k_cols_all[l][:, 0, :, None]
            x_r = x_r.to(x.dtype)
            k_r, v_r = (t.reshape(B, kv, H, Dh).transpose(1, 2)
                        .contiguous()[None]
                        for t in (qmm(x_r, lp.attn_k_w), qmm(x_r, lp.attn_v_w)))
            rings, ring_l, k_cols, v_cols = (k_r, v_r), 0, ones, ones
        else:
            rings, ring_l = (state.k_cache, state.v_cache), l
            k_cols, v_cols = ((k_cols_all[l], v_cols_all[l]) if quant
                              else (ones, ones))
        x, nk, nv, ncv, norm_attn = conformer_layer(
            lp, x, pos_heads[l], layer_masks[l], state.conv_cache[l], ring_l,
            *rings, chron, k_cols, v_cols, n_heads=H, d_head=Dh,
            packed_int4=cc.kv_cache_int4)
        if shared:
            new_k.append(norm_attn[:, None])                        # [B,1,Q,D]
        else:
            new_k.append(nk)
            new_v.append(nv)
        new_conv.append(ncv)

    # one segment write per step, after all layers (the rings are read-only
    # inside the layer loop); quantized rings take the new segment per
    # (layer, stream, head) with its scale, while the current chunk above
    # attended at full precision. Frozen streams write back the segment
    # and scale they had, read before the write.
    seg = phase_s * Q + torch.arange(Q, device=dev)
    for ring, scales, new in ((state.k_cache, state.k_scale, new_k),
                              (state.v_cache, state.v_scale, new_v)):
        if not new:             # the shared x-ring has no V ring
            continue
        new = torch.stack(new)                              # [L,B,H,Q,Dh]
        if quant:
            new, sc = _quantize_segment(new, cc.kv_quant_max,
                                        cc.kv_cache_int4)
        new = new.to(ring.dtype)
        if step_mask is not None:
            new = torch.where(step_mask[None, :, None, None, None], new,
                              ring.index_select(3, seg))
            if quant:
                sc = torch.where(step_mask[None, :, None], sc,
                                 scales.index_select(3, phase_s[None])[..., 0])
        if quant:
            scales.index_copy_(3, phase_s[None], sc[..., None])
        ring.index_copy_(3, seg, new)

    conv = torch.stack(new_conv).to(state.conv_cache.dtype)
    valid_len = torch.clamp(state.valid_len + Q, max=C)
    phase = torch.remainder(state.phase + 1, n_seg)
    if step_mask is not None:
        conv = torch.where(step_mask[None, :, None, None], conv,
                           state.conv_cache)
        valid_len = torch.where(step_mask, valid_len, state.valid_len)
        phase = torch.where(step_mask, phase, state.phase)
    new_state = EncoderState(
        k_cache=state.k_cache,
        v_cache=state.v_cache,
        k_scale=state.k_scale,
        v_scale=state.v_scale,
        conv_cache=conv,
        valid_len=valid_len,
        phase=phase,
    )
    enc_out = x[:, :cc.valid_out_len, :]
    enc_out = torch.where(phase_uniform, enc_out,
                          torch.full((), float("nan"), dtype=enc_out.dtype,
                                     device=dev))
    return enc_out, new_state


def realign_ring(state: EncoderState, slot: int, delta: int,
                 chunk_len: int) -> EncoderState:
    """Roll one stream's K/V ring and scales forward by `delta` segments and
    bump its phase, IN PLACE, so a stream that skipped engine steps
    re-enters the engine's lockstep write phase with its content-to-age
    mapping kept exactly (nemotron_tpu/models/encoder.py:558-579; the JAX
    package donates the buffers instead). Returns `state`."""
    n_seg = state.k_cache.shape[-2] // chunk_len
    for ring in (state.k_cache, state.v_cache):
        ring[:, slot] = torch.roll(ring[:, slot], delta * chunk_len, dims=-2)
    for scales in (state.k_scale, state.v_scale):
        scales[:, slot] = torch.roll(scales[:, slot], delta, dims=-1)
    state.phase[slot] = torch.remainder(state.phase[slot] + delta, n_seg)
    return state


def realign_rings(state: EncoderState, deltas: torch.Tensor,
                  chunk_len: int) -> EncoderState:
    """Batched `realign_ring`: roll EVERY stream's rings by its own
    deltas[b] segments (0 = unchanged) into a new state
    (nemotron_tpu/models/encoder.py:582-628). The gather takes per-stream
    [B, KV] slot indices; indices broadcast to the ring's shape would be 4x
    the int8 ring's bytes."""
    KV = state.k_cache.shape[-2]
    n_seg = KV // chunk_len
    B = state.k_cache.shape[1]
    dev = state.k_cache.device
    deltas = deltas.to(dev, torch.int64)
    b = torch.arange(B, device=dev)[:, None]                       # [B, 1]
    idx = torch.remainder(torch.arange(KV, device=dev)[None, :]
                          - deltas[:, None] * chunk_len, KV)        # [B, KV]
    sidx = torch.remainder(torch.arange(n_seg, device=dev)[None, :]
                           - deltas[:, None], n_seg)             # [B, n_seg]

    def roll(x, i):   # [L, B, H, N, ...] by per-stream indices i [B, N]
        return x.permute(1, 3, 0, 2, *range(4, x.dim()))[b, i].permute(
            2, 0, 3, 1, *range(4, x.dim()))

    return EncoderState(
        k_cache=roll(state.k_cache, idx).contiguous(),
        v_cache=roll(state.v_cache, idx).contiguous(),
        k_scale=roll(state.k_scale, sidx).contiguous(),
        v_scale=roll(state.v_scale, sidx).contiguous(),
        conv_cache=state.conv_cache,
        valid_len=state.valid_len,
        phase=torch.remainder(state.phase + deltas, n_seg).to(
            state.phase.dtype),
    )
