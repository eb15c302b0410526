"""TDT (Token-and-Duration Transducer) greedy walk and beam search.

The port's counterpart of `nemotron_tpu/models/tdt.py`. A TDT joint emits
a token AND a duration each step: its logit row is [V + D], the first V
the token head and the last D the duration head over `cfg.tdt_durations`.
A blank jumps `duration` frames at once instead of one, so decoding
visits far fewer frames on sparse speech.

Greedy semantics (one stream):

    t = 0
    while t < T:
        tok, d = argmax token / duration heads of joint(enc[t], pred_state)
        if tok == blank:  t += max(d, 1)          # blank d=0 would stall
        else:             emit tok; update state; t += d
                          (MAX_SYMBOLS_PER_STEP emissions at one frame
                           force t += 1)

The prediction-network state changes only on non-blank emissions, so for
a fixed state the joint runs against all frames in one product; the
blank-jump chain through those argmaxes is then a pure pointer chase over
[B] integers, solved on the device by pointer doubling (no host sync),
and the outer loop runs once an emission, testing its exit on the host
(one sync an iteration). Pointers may overshoot the chunk's end; the
overshoot is returned as `skip` and carried into the next chunk.

Ties: argmaxes take the lower index (torch.argmax as jnp.argmax), and the
beam ranks with models/beam._rank, a stable descending sort (lower index
first, as lax.top_k).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import MAX_SYMBOLS_PER_STEP, ModelConfig
from ..ops.lstm import lstm_step
from .beam import NEG_INF, _gather_k, _rank
from .decoder import DecoderState, joint_logits, joint_project_enc


def _durations(cfg: ModelConfig, device) -> torch.Tensor:
    """The durations as an int32 tensor on `device`, built by fill kernels
    (a host list copied to the card would cost a host sync a call)."""
    if not cfg.tdt_durations:
        raise ValueError("model has no TDT duration head "
                         "(cfg.tdt_durations is unset)")
    return torch.stack([torch.full((), int(d), dtype=torch.int32,
                                   device=device)
                        for d in cfg.tdt_durations])


def _chase(ptr: torch.Tensor, best: torch.Tensor, djump: torch.Tensor,
           t_limit: torch.Tensor, blank: int, reach: int) -> torch.Tensor:
    """The blank-jump chain from `ptr` [B]: while a stream's pointer is
    below its t_limit on a frame whose argmax is blank, it jumps
    max(duration, 1) frames; returns where each chain stops (a non-blank
    frame, or at or past t_limit with its exact overshoot).

    Pointer doubling over the next-frame table nxt [B, T + reach] (reach =
    the longest jump): a stop is its own successor, so after k squarings
    nxt is the 2^k-fold step, and 2^k > T steps reach every chain's end
    (each step moves at least one frame). The JAX package runs the chain
    one step at a time; both stop on the same frame."""
    B, T = best.shape
    dev = best.device
    size = T + reach
    frames = torch.arange(size, dtype=torch.int32, device=dev)[None, :]
    frames = frames.expand(B, size)
    pad = torch.zeros((B, reach), dtype=torch.int32, device=dev)
    blank_at = torch.cat([best == blank, pad.bool()], dim=1)
    step = torch.cat([torch.clamp(djump, min=1), pad], dim=1)
    jump = blank_at & (frames < t_limit[:, None])
    nxt = torch.where(jump, frames + step, frames)
    for _ in range(max(1, T.bit_length())):
        nxt = torch.gather(nxt, 1, nxt.long())
    start = torch.clamp(ptr, 0, size - 1).long()[:, None]
    return torch.where(ptr < t_limit, torch.gather(nxt, 1, start)[:, 0], ptr)


def tdt_greedy_decode(params, cfg: ModelConfig, enc: torch.Tensor,
                      state: DecoderState, skip_in=None, step_mask=None,
                      enc_lengths=None, with_iters: bool = False,
                      with_confidence: bool = False):
    """Batched greedy TDT walk (nemotron_tpu/models/tdt.py:50-181).

    enc: [B, T, d_model]; state: DecoderState (the RNN-T carry: TDT
    changes the walk over time, not the prediction network).
    skip_in [B] int (optional): frames to skip at the start of this chunk
    (a previous chunk's jump overshoot). step_mask [B] bool (optional):
    False streams are untouched, their skip_in passed through. enc_lengths
    [B] (optional): each stream's valid frames. with_confidence also
    returns each emission's log-posterior under the TOKEN head (durations
    excluded) at its frame, confs [B, T, MAX] f32 (0 in blank slots);
    with_iters also the loop's iteration count (a Python int).

    Returns (tokens [B, T, MAX_SYMBOLS_PER_STEP] int32 blank-padded,
    [confs,] new DecoderState, skip_out [B] int32[, iters])."""
    dev = enc.device
    dur_tab = _durations(cfg, dev)
    D = dur_tab.shape[0]
    reach = max(1, max(int(d) for d in cfg.tdt_durations))
    blank = cfg.blank_token
    dp = params.decoder
    B, T, _ = enc.shape
    MAX = MAX_SYMBOLS_PER_STEP
    i32 = torch.int32

    enc_proj = joint_project_enc(params.joint, enc)          # [B, T, J]
    emb_table = dp.embedding.to(enc_proj.dtype)
    tokens = torch.full((B, T * MAX), blank, dtype=i32, device=dev)
    confs = (torch.zeros((B, T * MAX), dtype=torch.float32, device=dev)
             if with_confidence else None)
    t_limit = torch.full((B,), T, dtype=i32, device=dev)
    if enc_lengths is not None:
        t_limit = torch.clamp(torch.as_tensor(enc_lengths).to(dev, i32),
                              max=T)
    skip = (None if skip_in is None
            else torch.as_tensor(skip_in).to(dev, i32))
    ptr = torch.zeros((B,), dtype=i32, device=dev) if skip is None else skip
    if step_mask is not None:
        # masked streams: the pointer parks at t_limit (no frames visited);
        # their skip carry is restored after the loop
        step_mask = torch.as_tensor(step_mask).to(dev, torch.bool)
        ptr = torch.where(step_mask, ptr, t_limit)
    sym = torch.zeros((B,), dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)
    if state.h.dtype != enc.dtype or state.c.dtype != enc.dtype:
        raise TypeError(f"decoder state {state.h.dtype} does not match the "
                        f"compute dtype {enc.dtype}")
    h, c, prev = state.h, state.c, state.prev_token

    it = 0
    while it < T * MAX + T and bool((ptr < t_limit).any()):
        dec_out, h2, c2 = lstm_step(dp, emb_table[prev.long()], h, c)
        logits = joint_logits(params.joint, enc_proj,
                              dec_out[:, None, :])           # [B, T, V+D]
        best = logits[..., :-D].argmax(dim=-1).to(i32)       # [B, T]
        djump = dur_tab[logits[..., -D:].argmax(dim=-1)]     # [B, T]

        ptr2 = _chase(ptr, best, djump, t_limit, blank, reach)
        sym2 = torch.where(ptr2 != ptr, 0, sym)    # a blank ends the run

        emit = ptr2 < t_limit                      # non-blank here
        cp = torch.clamp(ptr2, 0, T - 1).long()
        tok = best[bidx, cp]
        d_emit = djump[bidx, cp]
        slot = torch.clamp(ptr2 * MAX + sym2, 0, T * MAX - 1).long()
        tokens[bidx, slot] = torch.where(emit, tok, tokens[bidx, slot])
        if confs is not None:
            rows = logits[bidx, cp, :-D]                     # [B, V] f32
            m = rows.max(dim=-1).values
            lse = m + torch.log(torch.exp(rows - m[:, None]).sum(dim=-1))
            logp = rows[bidx, tok.long()] - lse
            confs[bidx, slot] = torch.where(emit, logp, confs[bidx, slot])

        h = torch.where(emit[:, None, None], h2, h)
        c = torch.where(emit[:, None, None], c2, c)
        prev = torch.where(emit, tok, prev)

        stay = d_emit == 0
        new_sym = torch.where(stay, sym2 + 1, 0)
        hit_max = new_sym >= MAX
        advance = torch.where(stay, hit_max.to(i32), d_emit)
        new_sym = torch.where(hit_max, 0, new_sym)
        ptr = torch.where(emit, ptr2 + advance, ptr2).to(i32)
        sym = torch.where(emit, new_sym, sym2).to(i32)
        it += 1

    skip_out = torch.clamp(ptr - t_limit, min=0).to(i32)
    if step_mask is not None and skip is not None:
        skip_out = torch.where(step_mask, skip_out, skip)
    res: tuple = (tokens.reshape(B, T, MAX),)
    if confs is not None:
        res = res + (confs.reshape(B, T, MAX),)
    res = res + (DecoderState(h, c, prev), skip_out)
    if with_iters:
        res = res + (it,)
    return res


# ---------------------------------------------------------------------------
# Duration-aware beam search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TdtBeamState:
    """Per-stream beam of K TDT hypotheses, carried across chunks.

    The field names of models/beam.BeamState, so that `best_hypothesis` /
    `n_best` read either; the TDT extras: `t`, each hypothesis's own time
    pointer (duration jumps advance hypotheses unequally, so the search is
    a loop of rounds over live hypotheses at their own frames; between
    chunks it holds the overshoot past the previous chunk's last valid
    frame), and `sym`, the symbols a hypothesis emitted at its current
    frame (the MAX_SYMBOLS_PER_STEP forced advance). lm_h/lm_c: the LM
    state of shallow fusion, advanced on labels."""

    h: Any           # [B, K, L, H] compute dtype
    c: Any           # [B, K, L, H]
    prev_token: Any  # [B, K] int32
    scores: Any      # [B, K] f32 total log-prob (NEG_INF = empty slot)
    tokens: Any      # [B, K, U] int32 emitted labels (blank-padded)
    lengths: Any     # [B, K] int32
    t: Any           # [B, K] int32 time pointer / overshoot
    sym: Any         # [B, K] int32 symbols emitted at the current frame
    lm_h: Any = None
    lm_c: Any = None


def init_tdt_beam_state(cfg: ModelConfig, batch: int, beam_size: int,
                        max_tokens: int, dtype: torch.dtype, device,
                        lm=None) -> TdtBeamState:
    """Hypothesis 0 live at score 0, the other K - 1 empty; every pointer
    at frame 0; h/c (and the LM state) zero in the compute dtype."""
    L, H = cfg.decoder_layers, cfg.decoder_dim
    scores = torch.full((batch, beam_size), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    lm_h = lm_c = None
    if lm is not None:
        from .lm import init_lm_state

        lm_h, lm_c = init_lm_state(lm, (batch, beam_size), dtype, device)

    def zeros_i32():
        return torch.zeros((batch, beam_size), dtype=torch.int32,
                           device=device)

    return TdtBeamState(
        h=torch.zeros((batch, beam_size, L, H), dtype=dtype, device=device),
        c=torch.zeros((batch, beam_size, L, H), dtype=dtype, device=device),
        prev_token=torch.full((batch, beam_size), cfg.blank_token,
                              dtype=torch.int32, device=device),
        scores=scores,
        tokens=torch.full((batch, beam_size, max_tokens), cfg.blank_token,
                          dtype=torch.int32, device=device),
        lengths=zeros_i32(), t=zeros_i32(), sym=zeros_i32(),
        lm_h=lm_h, lm_c=lm_c)


def tdt_beam_decode(params, cfg: ModelConfig, enc: torch.Tensor,
                    state: TdtBeamState, beam_size: int, enc_lengths=None,
                    step_mask=None, lm=None, lm_weight: float = 0.3,
                    lm_bonus: float = 0.0) -> TdtBeamState:
    """Batched TDT beam search over one chunk of encoder frames
    (nemotron_tpu/models/tdt.py:254-441).

    Candidates are (token, duration) pairs scored log P(token) +
    log P(duration) (+ the LM fusion terms on labels). Each round, only
    the live hypotheses at their stream's lowest live frame (the frontier)
    expand; the best K of {expansions} U {the other hypotheses, kept as
    they are} survive. The rounds end when every hypothesis has crossed
    the chunk's end (one host sync a round for that test, so the search
    runs exactly the JAX package's rounds: a round past the end is not a
    no-op, it refills the empty slots); the overshoot stays in `t` for the
    next chunk. With beam_size=1 the search is the greedy walk exactly.

    step_mask [B] bool (optional): False streams keep their entire beam.
    enc_lengths [B] (optional): each stream's valid frames (default T).
    Returns the new TdtBeamState (models/beam.best_hypothesis reads it)."""
    dev = enc.device
    dur_tab = _durations(cfg, dev)
    D = dur_tab.shape[0]
    blank = cfg.blank_token
    dp = params.decoder
    B, T, _ = enc.shape
    K = beam_size
    U = state.tokens.shape[-1]
    V = cfg.vocab_size
    MAX = MAX_SYMBOLS_PER_STEP
    i32 = torch.int32

    enc_proj = joint_project_enc(params.joint, enc)          # [B, T, J]
    emb_table = dp.embedding.to(enc_proj.dtype)
    t_limit = (torch.full((B,), T, dtype=i32, device=dev)
               if enc_lengths is None
               else torch.clamp(torch.as_tensor(enc_lengths).to(dev, i32),
                                max=T))
    if step_mask is not None:
        # frozen streams: no live hypotheses this call
        step_mask = torch.as_tensor(step_mask).to(dev, torch.bool)
        t_limit = torch.where(step_mask, t_limit, 0)
    t_lim = t_limit[:, None]
    bidx = torch.arange(B, device=dev)[:, None]              # [B, 1]
    kidx = torch.arange(K, device=dev)[None, :]
    nonblank = (torch.arange(V, device=dev) != blank)[None, None, :, None]
    n_exp = K * V * D

    def flat(x):
        return x.reshape((B * K,) + x.shape[2:])

    def unflat(x):
        return x.reshape((B, K) + x.shape[1:])

    st = state
    it = 0
    while it < T * (MAX + 1) + 8 and bool((st.t < t_lim).any()):
        live = st.t < t_lim                                  # [B, K]
        # frontier synchronization: only hypotheses at the stream's lowest
        # live frame expand; those that jumped ahead wait as keep-candidates
        frontier = torch.where(live, st.t, 1 << 30).min(dim=1).values
        expand = live & (st.t == frontier[:, None])
        cp = torch.clamp(st.t, 0, T - 1).long()
        ep = enc_proj[bidx, cp]                              # [B, K, J]
        dec_out, h2, c2 = lstm_step(dp, flat(emb_table[st.prev_token.long()]),
                                    flat(st.h), flat(st.c))
        h2, c2 = unflat(h2), unflat(c2)
        logits = joint_logits(params.joint, ep, unflat(dec_out))  # [B,K,V+D]
        logp_tok = torch.log_softmax(logits[..., :-D].float(), dim=-1)
        logp_dur = torch.log_softmax(logits[..., -D:].float(), dim=-1)

        lmh2 = lmc2 = None
        if lm is not None:
            from .lm import lm_logp

            lm_lp, lmh2, lmc2 = lm_logp(lm, flat(st.prev_token),
                                        flat(st.lm_h), flat(st.lm_c), blank)
            lm_lp, lmh2, lmc2 = unflat(lm_lp), unflat(lmh2), unflat(lmc2)
            # labels get the fusion terms; blank keeps the pure TDT score
            fuse = lm_weight * lm_lp + lm_bonus
            fuse[..., blank] = 0.0
            logp_tok = logp_tok + fuse

        # candidate scores [B, K, V, D] and the K keep-candidates
        cand = (st.scores[:, :, None, None] + logp_tok[..., None]
                + logp_dur[:, :, None, :])
        cand = torch.where(expand[:, :, None, None], cand, NEG_INF)
        # a full token buffer takes no more labels (blank still)
        full = (st.lengths >= U)[:, :, None, None]
        cand = torch.where(full & nonblank, NEG_INF, cand)
        keep_scores = torch.where(expand, NEG_INF, st.scores)
        top_scores, top_idx = _rank(
            torch.cat([cand.reshape(B, n_exp), keep_scores], dim=1), K)
        is_keep = top_idx >= n_exp
        parent = torch.where(is_keep, torch.clamp(top_idx - n_exp, 0, K - 1),
                             torch.div(top_idx, V * D, rounding_mode="floor"))
        vd = torch.clamp(top_idx, 0, n_exp - 1) % (V * D)
        v = torch.div(vd, D, rounding_mode="floor").to(i32)
        d_sel = dur_tab[vd % D]                              # [B, K] frames

        def g(leaf):
            return _gather_k(leaf, parent)

        is_label = ~is_keep & (v != blank)
        is_blank = ~is_keep & (v == blank)
        # blank jumps max(d, 1); a label jumps d (0 = stay, with the
        # MAX_SYMBOLS forced advance); a keep stays put
        new_sym = torch.where(is_label & (d_sel == 0), g(st.sym) + 1, 0)
        hit_max = new_sym >= MAX
        adv = torch.where(
            is_blank, torch.clamp(d_sel, min=1),
            torch.where(is_label,
                        torch.where(d_sel == 0, hit_max.to(i32), d_sel), 0))
        new_t = (g(st.t) + adv).to(i32)
        new_sym = torch.where(hit_max, 0, new_sym).to(i32)

        lab4 = is_label[..., None, None]
        plen = g(st.lengths)
        new_len = torch.where(is_label, torch.clamp(plen + 1, max=U),
                              plen).to(i32)
        new_tokens = g(st.tokens)                            # a fresh copy
        pos = torch.clamp(new_len - 1, 0, U - 1).long()
        new_tokens[bidx, kidx, pos] = torch.where(
            is_label, v, new_tokens[bidx, kidx, pos])
        st = TdtBeamState(
            h=torch.where(lab4, g(h2), g(st.h)),
            c=torch.where(lab4, g(c2), g(st.c)),
            prev_token=torch.where(is_label, v, g(st.prev_token)),
            scores=top_scores, tokens=new_tokens, lengths=new_len,
            t=new_t, sym=new_sym,
            lm_h=None if lm is None
            else torch.where(lab4, g(lmh2), g(st.lm_h)),
            lm_c=None if lm is None
            else torch.where(lab4, g(lmc2), g(st.lm_c)))
        it += 1

    # the overshoot carry for the next chunk
    st = dataclasses.replace(st, t=torch.clamp(st.t - t_lim, min=0).to(i32))
    if step_mask is not None:
        # frozen streams keep their entire incoming beam (t carries too)
        def keep(new, old):
            if new is None:
                return old
            m = step_mask.reshape((B,) + (1,) * (new.ndim - 1))
            return torch.where(m, new, old)

        st = TdtBeamState(**{
            f.name: keep(getattr(st, f.name), getattr(state, f.name))
            for f in dataclasses.fields(TdtBeamState)})
    return st
