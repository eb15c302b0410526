"""The comparison that decides `correct`: what the timed path produced,
against the plain reference run over the same PCM with the same weights.

Once the window has closed, the engine runs one more tick, untimed,
through the same `tick` at the same batch, with the decoder's first
joint call of that tick captured: the prediction network's outputs and
the joint's logits over the tick's frames, from which the engine made
its first decision for every stream. A sample of streams drawn from the
seed (with the stream that emitted most among them) is then taken from
the engine: every token `tick` emitted to it, its encoder state as that
tick left it, and the captured rows. The program's state is then freed,
and the reference (`reference/model.py`) recomputes, in f32, each
sampled stream from its first sample: the log-mel frames, every chunk of
the encoder, and the prediction network over the served tokens.

The numbers a cell's file may compare, each with its limit:

  logit_gap    the widest gap, over every greedy decision the engine made
               for the sampled streams (each emitted token, and the blank
               that ended each frame's label loop), by which the
               reference's logit of the decision lies below the
               reference's best logit for that frame and prefix;
  rows_missing the sampled streams that the captured joint call left out
               (exact: a decode that skips streams);
  pred_rel     the relative error (Frobenius norm of the difference over
               that of the reference) of the captured prediction outputs
               (the 2-layer LSTM over each stream's served tokens);
  joint_rel    the same of the captured logits over the tick's frames
               (the encoder's last chunk through the joint);
  state_rel    the worst relative error, over the layers, of the keys and
               values the engine's rings hold for the last 70 frames
               (dequantized with their scales) and of its conv caches;
  state_first  the same of the first layer alone.

A row that is missing counts as zeros in `pred_rel` and `joint_rel`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import traffic as traffic_mod
from .reference import model as ref

MAX_SYMBOLS = 10
# the numbers a cell's file may name, each with its limit
NUMBERS = ("logit_gap", "rows_missing", "pred_rel", "joint_rel",
           "state_first", "state_rel")


def sample_streams(tokens: list[list], n: int, seed: int) -> list[int]:
    """n streams drawn from the seed, the one that emitted most among
    them."""
    S = len(tokens)
    busiest = int(np.argmax([len(t) for t in tokens]))
    rng = np.random.default_rng(int(seed) + 17)
    others = [int(s) for s in rng.permutation(S) if s != busiest]
    return sorted([busiest] + others[:max(0, n - 1)])


def served_tick(engine, pcm: np.ndarray) -> dict:
    """One more `tick` of the engine over `pcm`, with the first call of the
    decoder's joint captured: {"pred": [B, H], "logits": [B, T, V]} (f32),
    the tokens each stream held before the tick (`u0`) and the chunk the
    tick encoded (`chunk`)."""
    from nemotron_tpu_torch.models import decoder as dec_mod

    real = dec_mod.joint_logits
    seen = {}

    def capture(jp, enc_proj, dec_out):
        out = real(jp, enc_proj, dec_out)
        if not seen:
            seen.update(pred=dec_out[:, 0].float(), logits=out.float())
        return out

    u0 = [len(t) for t in engine.tokens]
    chunk = engine.total_chunks
    dec_mod.joint_logits = capture
    try:
        engine.tick(pcm)
    finally:
        dec_mod.joint_logits = real
    return dict(seen, u0=u0, chunk=chunk)


def snapshot(engine, streams: list[int], served: dict) -> dict:
    """What the check reads of the engine once the window has closed:
    the served tokens, the encoder state and the captured decoder rows of
    the sampled streams (None where the capture lacks a stream's row)."""
    idx = torch.tensor(streams, device=engine.device)
    st = engine.enc_state
    rows = {k: [served[k][s].clone() if k in served
                and s < served[k].shape[0] else None for s in streams]
            for k in ("pred", "logits")}
    return {
        "streams": streams,
        "u0": [served["u0"][s] for s in streams],
        "chunk": served["chunk"],
        "pred": rows["pred"], "logits": rows["logits"],
        "tokens": [list(engine.tokens[s]) for s in streams],
        "chunks": engine.total_chunks,
        "k": st.k_cache.index_select(1, idx).clone(),
        "v": st.v_cache.index_select(1, idx).clone(),
        "k_scale": st.k_scale.index_select(1, idx).clone(),
        "v_scale": st.v_scale.index_select(1, idx).clone(),
        "conv": st.conv_cache.index_select(1, idx).clone(),
    }


def decisions(tokens: list[tuple], n_frames: int, blank: int):
    """(frame, prefix length, chosen id) of every greedy decision that
    emitted `tokens` [(id, frame), ...] over n_frames frames."""
    by_frame: dict[int, list[int]] = {}
    for tok, frame in tokens:
        by_frame.setdefault(int(frame), []).append(int(tok))
    out, u = [], 0
    for t in range(n_frames):
        emitted = by_frame.get(t, [])
        for tok in emitted:
            out.append((t, u, tok))
            u += 1
        if len(emitted) < MAX_SYMBOLS:
            out.append((t, u, blank))
    return out


def _ring_frames(ring: torch.Tensor, scale: torch.Tensor, chunks: int,
                 Q: int, C: int, Dh: int) -> torch.Tensor:
    """The last C frames a ring [L, B, H, KV, Dh] (or packed int4 pairs
    [L, B, H, KV, Dh / 2]) holds, oldest first, dequantized by its
    per-segment scales [L, B, H, n_seg]: chunk c sits in segment
    c mod n_seg."""
    if chunks < C // Q:
        raise ValueError(f"{chunks} chunks do not fill the {C}-frame cache")
    n_seg = ring.shape[3] // Q
    segs = [c % n_seg for c in range(chunks - C // Q, chunks)]
    x = ring.to(torch.float32)
    if ring.shape[-1] * 2 == Dh:
        # int4 pairs, element 2i in the low nibble, sign-extended
        b = ring.to(torch.int32)
        x = torch.stack([(b << 28) >> 28, b >> 4], dim=-1).reshape(
            *ring.shape[:-1], Dh).to(torch.float32)
    parts = [x[:, :, :, s * Q:(s + 1) * Q] * scale[:, :, :, s, None, None]
             for s in segs]
    return torch.cat(parts, dim=3)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _rel_rows(got: list, want: list) -> float:
    """Relative error of the stacked rows, a row that is missing or of
    another shape counted as zeros."""
    got = [g if g is not None and g.shape == w.shape else torch.zeros_like(w)
           for g, w in zip(got, want)]
    return _rel(torch.stack(got), torch.stack(want))


def compare(snap: dict, weights: dict, config: dict, traffic: dict,
            bank: np.ndarray, n_ticks: int, device) -> dict:
    """The numbers of NUMBERS for a snapshot, and what they were read
    over, the reference in the configuration's precision."""
    ref.no_tf32()
    m = config["model"]
    R = traffic["latency_mode"]
    Q = 1 + R
    streams = snap["streams"]
    W = ref.Weights(weights, config["matmul"])
    pcm = torch.from_numpy(traffic_mod.stream_pcm(bank, streams, n_ticks)).to(
        device)
    mel = ref.log_mel(pcm, W.w["pre.window"], W.w["pre.filterbank"])
    model = ref.StreamingModel(W, m, R, config["kv_cache"], len(streams),
                               device)
    with torch.no_grad():
        enc = model.encode(mel, snap["chunks"])                 # [B, T, D]
        T = enc.shape[1]
        blank = m["vocab_size"] - 1
        gaps, flips, n_dec = [], 0, 0
        want_pred, want_logits = [], []
        frames = slice(snap["chunk"] * Q, (snap["chunk"] + 1) * Q)
        for b, toks in enumerate(snap["tokens"]):
            dec = decisions(toks, T, blank)
            prefix = torch.tensor([[blank] + [t for t, _ in toks]],
                                  device=device)
            pred = ref.lstm(W.w, prefix)[0]                     # [U+1, H]
            u0 = snap["u0"][b]
            want_pred.append(pred[u0])
            want_logits.append(ref.joint(W.w, enc[b, frames], pred[u0]))
            f = torch.tensor([d[0] for d in dec], device=device)
            u = torch.tensor([d[1] for d in dec], device=device)
            chosen = torch.tensor([d[2] for d in dec], device=device)
            logits = ref.joint(W.w, enc[b, f], pred[u])
            best = logits.max(dim=-1).values
            gap = best - logits.gather(1, chosen[:, None])[:, 0]
            gaps.append(gap)
            flips += int((logits.argmax(dim=-1) != chosen).sum())
            n_dec += len(dec)
        C = model.C
        layers = []
        for l in range(m["n_layers"]):
            errs = [_rel(snap["conv"][l].to(torch.float32), model.conv[l])]
            for ring, sc, mine in (("k", "k_scale", model.k[l]),
                                   ("v", "v_scale", model.v[l])):
                got = _ring_frames(snap[ring][l:l + 1], snap[sc][l:l + 1],
                                   snap["chunks"], Q, C, m["d_head"])[0]
                errs.append(_rel(got, mine))
            layers.append(max(errs))
    return {"logit_gap": float(torch.cat(gaps).max()),
            "rows_missing": sum(g is None or g.shape != w.shape for g, w in
                                zip(snap["logits"], want_logits)),
            "pred_rel": _rel_rows(snap["pred"], want_pred),
            "joint_rel": _rel_rows(snap["logits"], want_logits),
            "state_rel": max(layers),
            "state_first": layers[0], "state_layers": layers,
            "decisions": n_dec, "flips": flips,
            "tokens": sum(len(t) for t in snap["tokens"]),
            "frames": T, "streams": len(streams)}
