"""CTC decoding for hybrid RNNT-CTC checkpoints.

The port's counterpart of `nemotron_tpu/models/ctc.py`. NeMo's
cache-aware FastConformer checkpoints often ship an auxiliary CTC head
(`ctc_decoder.decoder_layers.0`, a Linear d_model -> vocab with blank).
CTC decoding is stateless over frames: no prediction network, no label
loop.

Greedy CTC: per-frame argmax -> collapse consecutive repeats -> drop
blanks. The product and the argmax run on the params' device; the
collapse runs on the host over the int32 argmax download. Ties in the
argmax go to the lower index, in `torch.argmax` as in `jnp.argmax`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig


def ctc_logits(params, enc: torch.Tensor) -> torch.Tensor:
    """Encoder output [B, T, D] -> CTC logits [B, T, V] f32: the weight
    rounded to the activations' dtype, the product accumulated in f32 (the
    JAX package's preferred_element_type), plus the f32 bias."""
    if params.ctc is None:
        raise ValueError("model has no CTC head (ctc_decoder.* tensors)")
    w = params.ctc.out_w.to(enc.dtype).to(torch.float32)
    return enc.to(torch.float32) @ w + params.ctc.out_b.to(torch.float32)


def frame_ids(params, enc: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax of the CTC head, [B, T] int32."""
    return ctc_logits(params, enc).argmax(dim=-1).to(torch.int32)


def frame_log_posteriors(params, enc: torch.Tensor):
    """Per-frame (argmax ids [B, T] int32, log-posterior of the argmax
    [B, T] f32): the device half of confident CTC decoding, the log-softmax
    over the whole vocab in f32 (max + log-sum-exp, as jax.scipy's
    logsumexp computes it)."""
    logits = ctc_logits(params, enc)                     # [B, T, V] f32
    best = logits.argmax(dim=-1)
    m = logits.max(dim=-1).values
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    top = torch.gather(logits, -1, best[..., None])[..., 0]
    return best.to(torch.int32), top - lse


def collapse(frame_ids: np.ndarray, blank: int,
             length: int | None = None) -> list[int]:
    """The CTC greedy rule for ONE stream: collapse consecutive repeats,
    then remove blanks. frame_ids: [T] int per-frame argmax."""
    t_end = frame_ids.shape[0] if length is None else int(length)
    ids = frame_ids[:t_end]
    if ids.size == 0:
        return []
    keep = np.ones(ids.shape, bool)
    keep[1:] = ids[1:] != ids[:-1]          # collapse repeats
    ids = ids[keep]
    return [int(i) for i in ids[ids != blank]]


def collapse_with_confidence(frame_ids: np.ndarray, frame_logp: np.ndarray,
                             blank: int, length: int | None = None,
                             frame_offset: int = 0
                             ) -> list[tuple[int, int, float]]:
    """collapse() with each token's emitting frame (the first of its run)
    and its confidence, the argmax log-posterior there: [(token_id, frame,
    logp), ...], the RNN-T confidence token format."""
    t_end = frame_ids.shape[0] if length is None else int(length)
    ids, lps = frame_ids[:t_end], frame_logp[:t_end]
    if ids.size == 0:
        return []
    keep = np.ones(ids.shape, bool)
    keep[1:] = ids[1:] != ids[:-1]
    frames = np.nonzero(keep)[0]
    ids, lps = ids[keep], lps[keep]
    nb = ids != blank
    return [(int(i), frame_offset + int(f), float(lp))
            for i, f, lp in zip(ids[nb], frames[nb], lps[nb])]


def collapse_chunk(ids: np.ndarray, prev: np.ndarray, rows, blank: int,
                   frame_base, logp: np.ndarray | None = None) -> dict:
    """The streaming collapse of one chunk's ids [S, T] for the streams in
    `rows`, continuing each one's carry `prev` [S] (the raw last frame id
    of its previous chunk, -1 at the start of a stream; updated in place),
    so that a repeat spanning two chunks is emitted once. `frame_base` is
    each row's absolute frame of column 0 (an int or an [S] array). Returns
    {row: [(id, frame), ...]} for the rows that emitted, with logp [S, T]
    (id, frame, log_posterior) triples."""
    base = np.broadcast_to(np.asarray(frame_base, np.int64), prev.shape)
    out: dict[int, list] = {}
    for s in rows:
        s = int(s)
        last, toks = int(prev[s]), []
        for t in range(ids.shape[1]):
            i = int(ids[s, t])
            if i != last and i != blank:
                if logp is None:
                    toks.append((i, int(base[s]) + t))
                else:
                    toks.append((i, int(base[s]) + t, float(logp[s, t])))
            last = i
        prev[s] = last
        if toks:
            out[s] = toks
    return out


def ctc_greedy_decode(params, cfg: ModelConfig, enc: torch.Tensor,
                      enc_lengths=None) -> list[list[int]]:
    """Greedy CTC over encoder outputs: each stream's token list.
    enc_lengths [B] (optional): frames past a stream's valid length are
    ignored (padded multi-utterance batches)."""
    best = frame_ids(params, enc).cpu().numpy().astype(np.int64)   # [B, T]
    if enc_lengths is None:
        return [collapse(best[b], cfg.blank_token)
                for b in range(best.shape[0])]
    lens = np.asarray(torch.as_tensor(enc_lengths).cpu(), np.int64)
    return [collapse(best[b], cfg.blank_token, int(lens[b]))
            for b in range(best.shape[0])]
