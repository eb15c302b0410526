"""RNN-T prediction network + joint + batched greedy decode.

The port's counterpart of `nemotron_tpu/models/decoder.py` (greedy path).
Semantics preserved exactly:
  - blank emission freezes the LSTM state and prev_token and advances to the
    next frame (reference src/nemo-ggml.cpp:1234-1245);
  - up to MAX_SYMBOLS_PER_STEP=10 non-blank symbols per frame
    (reference src/nemo-ggml.cpp:1134).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import MAX_SYMBOLS_PER_STEP, ModelConfig
from ..ops.lstm import lstm_step


@dataclasses.dataclass
class DecoderState:
    """Per-stream decode state (the reference's nemo_decoder_state POD,
    src/nemo-ggml.h:358-398)."""

    h: Any            # [B, L, H]
    c: Any            # [B, L, H]
    prev_token: Any   # [B] int32


def init_decoder_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                       device) -> DecoderState:
    """Blank-primed state on `device`: h/c in the compute dtype, as the JAX
    package keeps them, prev_token int32."""
    L, H = cfg.decoder_layers, cfg.decoder_dim
    return DecoderState(
        h=torch.zeros((batch, L, H), dtype=dtype, device=device),
        c=torch.zeros((batch, L, H), dtype=dtype, device=device),
        prev_token=torch.full((batch,), cfg.blank_token, dtype=torch.int32,
                              device=device),
    )


def joint_project_enc(jp, enc: torch.Tensor) -> torch.Tensor:
    """Encoder-side joint projection [.., D] -> [.., joint_dim], hoisted out
    of the symbol loop."""
    return enc @ jp.enc_w.to(enc.dtype) + jp.enc_b.to(enc.dtype)


def joint_logits(jp, enc_proj: torch.Tensor, dec_out: torch.Tensor):
    """relu(enc_proj + dec_proj) @ out (reference src/nemo-ggml.cpp:1062-1100).
    The vocab projection accumulates and returns f32 (no low-precision
    rounding before the argmax)."""
    dt = dec_out.dtype
    d = dec_out @ jp.dec_w.to(dt) + jp.dec_b.to(dt)
    h = torch.relu(enc_proj + d)
    logits = h.to(torch.float32) @ jp.out_w.to(dt).to(torch.float32)
    return logits + jp.out_b.to(torch.float32)


def decode_frame(params, cfg: ModelConfig, state: DecoderState,
                 enc_proj_t: torch.Tensor):
    """Greedy label loop for ONE encoder frame across all B streams
    (nemotron_tpu/models/decoder.py:81-117): the reference's per-frame loop
    (src/nemo-ggml.cpp:1138-1246), run on the host until every stream has
    emitted blank or MAX_SYMBOLS_PER_STEP symbols.

    enc_proj_t: [B, joint_dim] (already through the joint enc projection).
    Returns (new state, tokens [MAX_SYMBOLS_PER_STEP, B] int32
    blank-padded)."""
    dp = params.decoder
    blank = cfg.blank_token
    B = enc_proj_t.shape[0]
    emb_table = dp.embedding.to(enc_proj_t.dtype)
    tokens = torch.full((MAX_SYMBOLS_PER_STEP, B), blank, dtype=torch.int32,
                        device=enc_proj_t.device)
    h, c, prev = state.h, state.c, state.prev_token
    active = torch.ones((B,), dtype=torch.bool, device=enc_proj_t.device)
    sym = 0
    while sym < MAX_SYMBOLS_PER_STEP and bool(active.any()):
        dec_out, h2, c2 = lstm_step(dp, emb_table[prev.long()], h, c)
        logits = joint_logits(params.joint, enc_proj_t, dec_out)
        tok = logits.argmax(dim=-1).to(torch.int32)                 # [B]
        emit = active & (tok != blank)
        h = torch.where(emit[:, None, None], h2, h)
        c = torch.where(emit[:, None, None], c2, c)
        prev = torch.where(emit, tok, prev)
        tokens[sym] = torch.where(emit, tok, blank)
        active = emit
        sym += 1
    return DecoderState(h, c, prev), tokens


def greedy_decode_by_frame(params, cfg: ModelConfig, enc: torch.Tensor,
                           state: DecoderState):
    """Greedy RNN-T frame by frame (nemotron_tpu/models/decoder.py:120-133):
    the semantics oracle of greedy_decode, O(T) sequential frames.
    Returns (tokens [B, T, MAX_SYMBOLS_PER_STEP] int32, new state)."""
    enc_proj = joint_project_enc(params.joint, enc)                 # [B, T, J]
    frames = []
    for t in range(enc_proj.shape[1]):
        state, toks = decode_frame(params, cfg, state, enc_proj[:, t])
        frames.append(toks)
    return torch.stack(frames).permute(2, 0, 1), state


def greedy_decode(params, cfg: ModelConfig, enc: torch.Tensor,
                  state: DecoderState, step_mask=None, enc_lengths=None):
    """Frame-skipping batched greedy RNN-T (nemotron_tpu/models/decoder.py:
    136-256, without its confidence option).

    The LSTM state only changes on non-blank emissions, so for a fixed state
    the joint is evaluated against ALL remaining frames in one matmul and
    each stream jumps to its first non-blank frame: O(emitted tokens)
    iterations instead of O(T). The loop runs on the host; its exit test is
    one device->host sync per iteration.

    enc: [B, T, d_model]; step_mask [B] bool (optional): streams marked
    False are skipped -- no tokens, state unchanged (continuous batching);
    enc_lengths [B] int (optional): each stream's valid frames in a padded
    batch -- frames at or beyond it emit nothing.
    Returns (tokens [B, T, MAX_SYMBOLS_PER_STEP] int32 blank-padded, new
    DecoderState)."""
    dp = params.decoder
    blank = cfg.blank_token
    B, T, _ = enc.shape
    MAX = MAX_SYMBOLS_PER_STEP
    dev = enc.device
    i32 = torch.int32

    enc_proj = joint_project_enc(params.joint, enc)        # [B, T, J]
    emb_table = dp.embedding.to(enc_proj.dtype)
    tokens = torch.full((B, T * MAX), blank, dtype=i32, device=dev)
    ptr = torch.zeros((B,), dtype=i32, device=dev)         # current frame
    if step_mask is not None:                              # skip masked ones
        ptr = torch.where(step_mask.to(dev, torch.bool), ptr, T).to(i32)
    t_limit = torch.full((B,), T, dtype=i32, device=dev)
    if enc_lengths is not None:
        t_limit = torch.clamp(enc_lengths.to(dev, i32), max=T)
    sym = torch.zeros((B,), dtype=i32, device=dev)         # symbols this frame
    bidx = torch.arange(B, device=dev)
    t_idx = torch.arange(T, dtype=i32, device=dev)[None, :]
    if state.h.dtype != enc.dtype or state.c.dtype != enc.dtype:
        # the where() below would promote the state to the wider dtype
        raise TypeError(f"decoder state {state.h.dtype} does not match the "
                        f"compute dtype {enc.dtype}")
    h, c, prev = state.h, state.c, state.prev_token

    it = 0
    while it < T * MAX + T and bool((ptr < t_limit).any()):
        emb = emb_table[prev.long()]
        dec_out, h2, c2 = lstm_step(dp, emb, h, c)            # [B, H]
        logits = joint_logits(params.joint, enc_proj, dec_out[:, None, :])
        best = logits.argmax(dim=-1).to(i32)                  # [B, T]

        # first valid frame >= ptr whose argmax is non-blank (current state)
        cand = (best != blank) & (t_idx >= ptr[:, None]) \
            & (t_idx < t_limit[:, None])
        has = cand.any(dim=1)
        first = cand.to(i32).argmax(dim=1).to(i32)            # first True

        active = ptr < t_limit
        emit = active & has
        new_ptr = torch.where(active & ~has, t_limit, ptr)
        jumped = first != ptr
        new_ptr = torch.where(emit, first, new_ptr)
        new_sym = torch.where(emit, torch.where(jumped, 0, sym), sym)

        tok = best[bidx, first.long()]
        cslot = torch.clamp(new_ptr * MAX + new_sym, 0, T * MAX - 1).long()
        tokens[bidx, cslot] = torch.where(emit, tok, tokens[bidx, cslot])

        h = torch.where(emit[:, None, None], h2, h)
        c = torch.where(emit[:, None, None], c2, c)
        prev = torch.where(emit, tok, prev)

        new_sym = torch.where(emit, new_sym + 1, new_sym)
        hit_max = new_sym >= MAX            # MAX symbols on a frame: advance
        ptr = torch.where(hit_max, new_ptr + 1, new_ptr).to(i32)
        sym = torch.where(hit_max, 0, new_sym).to(i32)
        it += 1

    return tokens.reshape(B, T, MAX), DecoderState(h, c, prev)


def extract_emitted(tokens, blank: int, frame_offsets=None):
    """Host-side token extraction: [B, T, MAX] int32 -> {stream: [(token,
    abs_frame), ...]} in emission order. Only streams that emitted appear;
    `frame_offsets` [B] offsets each stream's frame indices."""
    arr = np.asarray(tokens)
    nz = np.argwhere(arr != blank)
    out: dict[int, list[tuple]] = {}
    if nz.size == 0:
        return out
    vals = arr[nz[:, 0], nz[:, 1], nz[:, 2]]
    b = nz[:, 0]
    # argwhere is lexicographic in (stream, frame, symbol) == emission order
    starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    ends = np.r_[starts[1:], len(b)]
    for s0, e0 in zip(starts, ends):
        stream = int(b[s0])
        off = int(frame_offsets[stream]) if frame_offsets is not None else 0
        out[stream] = [(int(v), off + int(t))
                       for v, t in zip(vals[s0:e0], nz[s0:e0, 1])]
    return out


def tokens_to_list(tokens, blank: int):
    """Host-side: [T, MAX] or [B, T, MAX] int32 -> list of (token, frame)
    (a list of such lists for [B, T, MAX]), in emission order."""
    arr = np.asarray(tokens)
    if arr.ndim == 3:
        return [tokens_to_list(a, blank) for a in arr]
    return [(int(arr[t, s]), t) for t, s in np.argwhere(arr != blank)]
