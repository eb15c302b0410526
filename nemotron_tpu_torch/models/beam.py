"""Batched RNN-T beam search on the params' device.

The port's counterpart of `nemotron_tpu/models/beam.py`. Per encoder frame,
up to `expansions` label-expansion rounds: each round evaluates the joint
for every live hypothesis (one [B*K] LSTM step and joint), splits the
candidates into blank (the hypothesis finishes the frame with its
prediction-network state frozen, reference src/nemo-ggml.cpp:1234-1245)
and non-blank (the hypothesis extends), and keeps the best K of each
pool. After the last round the still-live hypotheses are force-finished
with their blank log-prob. Identical prefixes reached in different orders
are not merged.

Shapes are fixed ([B, K] hypotheses, U token slots) and the expansion
count is a Python loop of fixed length, so `beam_decode` makes no
device-to-host sync: the host only queues work.

Ties decide the state, not only the text: an empty slot holds NEG_INF, and
NEG_INF plus any log-prob is NEG_INF again in f32, so empty slots tie all
the time. The JAX package ranks with a stable argsort and `lax.top_k`,
both of which put the lower index first among equals; `_rank` does the
same with a stable descending sort (`torch.topk` leaves the order of ties
unspecified).

beam_size=1 is not greedy decode: greedy commits to each step's argmax
label, the K = 1 beam keeps the best finished hypothesis, so it takes blank
wherever an emission costs more than the blank that would end the frame.
Its log-prob is at least the greedy path's (the JAX package's gate,
tests/test_beam.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import MAX_SYMBOLS_PER_STEP, ModelConfig
from ..ops.lstm import lstm_step
from .decoder import joint_logits, joint_project_enc

NEG_INF = -1e30


@dataclasses.dataclass
class BeamState:
    """Per-stream beam of K hypotheses (carried across chunks). lm_h/lm_c
    are set only with LM shallow fusion (models/lm.py): each hypothesis
    then also carries its LM state, advanced on non-blank emissions like
    the prediction network's."""

    h: Any           # [B, K, L, H] compute dtype
    c: Any           # [B, K, L, H]
    prev_token: Any  # [B, K] int32
    scores: Any      # [B, K] f32 total log-prob (NEG_INF = empty slot)
    tokens: Any      # [B, K, U] int32 emitted labels (blank-padded)
    lengths: Any     # [B, K] int32
    lm_h: Any = None  # [B, K, L_lm, H_lm] | None
    lm_c: Any = None


def leaves(st) -> dict:
    """The state's set fields (lm_h/lm_c only with an LM), of a BeamState
    or of a models/tdt.TdtBeamState (which adds t and sym)."""
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if getattr(st, f.name) is not None}


def init_beam_state(cfg: ModelConfig, batch: int, beam_size: int,
                    max_tokens: int, dtype: torch.dtype, device,
                    lm=None) -> BeamState:
    """Hypothesis 0 live at score 0, the other K - 1 empty; h/c (and the
    LM state) zero in the compute dtype."""
    L, H = cfg.decoder_layers, cfg.decoder_dim
    scores = torch.full((batch, beam_size), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    lm_h = lm_c = None
    if lm is not None:
        from .lm import init_lm_state

        lm_h, lm_c = init_lm_state(lm, (batch, beam_size), dtype, device)
    return BeamState(
        h=torch.zeros((batch, beam_size, L, H), dtype=dtype, device=device),
        c=torch.zeros((batch, beam_size, L, H), dtype=dtype, device=device),
        prev_token=torch.full((batch, beam_size), cfg.blank_token,
                              dtype=torch.int32, device=device),
        scores=scores,
        tokens=torch.full((batch, beam_size, max_tokens), cfg.blank_token,
                          dtype=torch.int32, device=device),
        lengths=torch.zeros((batch, beam_size), dtype=torch.int32,
                            device=device),
        lm_h=lm_h, lm_c=lm_c)


def _gather_k(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Select hypotheses: leaf [B, K, ...] reindexed by idx [B, Knew]."""
    idx = idx.long().reshape(idx.shape + (1,) * (leaf.ndim - 2))
    return torch.gather(leaf, 1, idx.expand(idx.shape[:2] + leaf.shape[2:]))


def _rank(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along dim 1, best first; ties go
    to the lower index (jnp.argsort(-x) and jax.lax.top_k)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _merge(fin: BeamState, live: BeamState, live_scores: torch.Tensor,
           K: int) -> BeamState:
    """Top K of (fin ∪ live) by score: fin with its own scores, live with
    `live_scores`; every other leaf follows its hypothesis."""
    m_scores = torch.cat([fin.scores, live_scores], dim=1)       # [B, 2K]
    scores, m_idx = _rank(m_scores, K)
    out = {k: _gather_k(torch.cat([a, getattr(live, k)], dim=1), m_idx)
           for k, a in leaves(fin).items() if k != "scores"}
    return BeamState(scores=scores, **out)


def beam_decode(params, cfg: ModelConfig, enc: torch.Tensor,
                state: BeamState, beam_size: int,
                expansions: int = MAX_SYMBOLS_PER_STEP,
                enc_lengths: torch.Tensor | None = None, lm=None,
                lm_weight: float = 0.3,
                lm_bonus: float = 0.0) -> BeamState:
    """enc [B, T, D] -> the new BeamState (nemotron_tpu/models/beam.py:
    104-251); `best_hypothesis` reads the tokens.

    enc_lengths [B] (optional): frames at or past a stream's length leave
    its beam untouched, every leaf included, so ragged batches decode as
    solo runs do (a 0 freezes the stream: continuous batching).

    lm (LMParams, optional): shallow fusion. Label candidates score
    log P_rnnt + lm_weight * log P_lm + lm_bonus; blank keeps the pure
    transducer score. The state must come from init_beam_state(lm=lm)."""
    dp = params.decoder
    blank = cfg.blank_token
    B, T, _ = enc.shape
    K = beam_size
    U = state.tokens.shape[-1]
    V = cfg.vocab_size
    dev = enc.device

    enc_proj = joint_project_enc(params.joint, enc)           # [B, T, J]
    emb_table = dp.embedding.to(enc_proj.dtype)
    t_limit = (None if enc_lengths is None
               else torch.clamp(enc_lengths.to(dev, torch.int32), max=T))

    def flat(x):
        return x.reshape((B * K,) + x.shape[2:])

    def unflat(x):
        return x.reshape((B, K) + x.shape[1:])

    def joint_for_beam(st: BeamState, ep_t: torch.Tensor):
        """One prediction + joint evaluation for all B*K hypotheses:
        log-probs [B, K, V] f32 and the advanced LSTM states."""
        emb = emb_table[st.prev_token.long()]                  # [B, K, H]
        dec_out, h2, c2 = lstm_step(dp, flat(emb), flat(st.h), flat(st.c))
        logits = joint_logits(params.joint, ep_t[:, None, :],
                              unflat(dec_out))
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return logp, unflat(h2), unflat(c2)

    def expand(live: BeamState, fin: BeamState, ep_t: torch.Tensor):
        logp, h2, c2 = joint_for_beam(live, ep_t)              # [B, K, V]
        cand = live.scores[..., None] + logp                   # [B, K, V]

        # blank: the hypothesis finishes the frame, its state frozen (pure
        # transducer score: blank is never LM-scored)
        new_fin = _merge(fin, live, cand[..., blank], K)

        # non-blank: extend; top K over the K*V candidates
        lmh2 = lmc2 = None
        if lm is not None:
            from .lm import lm_logp

            lm_lp, lmh2, lmc2 = lm_logp(lm, flat(live.prev_token),
                                        flat(live.lm_h), flat(live.lm_c),
                                        blank)
            lm_lp, lmh2, lmc2 = unflat(lm_lp), unflat(lmh2), unflat(lmc2)
            cand = cand + lm_weight * lm_lp + lm_bonus
        nb = cand.clone()
        nb[..., blank] = NEG_INF
        # a full hypothesis buffer cannot extend further
        nb = torch.where((live.lengths >= U)[..., None], NEG_INF, nb)
        top_scores, top_flat = _rank(nb.reshape(B, K * V), K)  # [B, K]
        parent = torch.div(top_flat, V, rounding_mode="floor")
        label = (top_flat % V).to(torch.int32)
        new_len = torch.clamp(_gather_k(live.lengths, parent) + 1, max=U)
        new_tokens = _gather_k(live.tokens, parent)           # a fresh copy
        pos = torch.clamp(new_len - 1, 0, U - 1).long()
        new_tokens.scatter_(2, pos[..., None], label[..., None])
        new_live = BeamState(
            h=_gather_k(h2, parent), c=_gather_k(c2, parent),
            prev_token=label, scores=top_scores, tokens=new_tokens,
            lengths=new_len,
            lm_h=None if lm is None else _gather_k(lmh2, parent),
            lm_c=None if lm is None else _gather_k(lmc2, parent))
        return new_live, new_fin

    for t in range(T):
        ep_t = enc_proj[:, t]
        # finished pool: starts empty; live pool: the incoming beam
        fin = dataclasses.replace(
            state, scores=torch.full((B, K), NEG_INF, dtype=torch.float32,
                                     device=dev))
        live = state
        for _ in range(expansions):
            live, fin = expand(live, fin, ep_t)
        # force-finish the surviving live hypotheses with their blank
        # log-prob
        logp, _h2, _c2 = joint_for_beam(live, ep_t)
        out = _merge(fin, live, live.scores + logp[..., blank], K)
        if t_limit is not None:
            # frames past a stream's enc_length leave its beam untouched
            active = t < t_limit                                # [B]
            out = BeamState(**{
                k: torch.where(active.reshape((B,) + (1,) * (v.ndim - 1)),
                               v, getattr(state, k))
                for k, v in leaves(out).items()})
        state = out
    return state


def best_hypothesis(state: BeamState, length_norm: bool = False):
    """(tokens [B, U] int32 blank-padded, lengths [B], raw score [B]) of
    each stream's best hypothesis (nemotron_tpu/models/beam.py:254-269).
    length_norm=True selects by score / max(len, 1), NeMo's score_norm and
    the serving default; the score returned is the raw total log-prob."""
    sel = state.scores
    if length_norm:
        sel = sel / torch.clamp(state.lengths, min=1).to(sel.dtype)
    k = torch.argmax(sel, dim=1)[:, None]                     # [B, 1]
    return (_gather_k(state.tokens, k)[:, 0],
            _gather_k(state.lengths, k)[:, 0],
            torch.gather(state.scores, 1, k)[:, 0])


def n_best(state: BeamState, n: int | None = None,
           length_norm: bool = False):
    """The top n hypotheses per stream, best first: (tokens [B, N, U],
    lengths [B, N], raw scores [B, N]) (nemotron_tpu/models/beam.py:
    272-290). `length_norm` ranks by score / max(len, 1)."""
    k_total = state.scores.shape[1]
    n = k_total if n is None else min(n, k_total)
    sel = state.scores
    if length_norm:
        sel = sel / torch.clamp(state.lengths, min=1).to(sel.dtype)
    _, order = _rank(sel, n)
    return (_gather_k(state.tokens, order), _gather_k(state.lengths, order),
            torch.gather(state.scores, 1, order))
