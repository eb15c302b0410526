"""TDT (Token-and-Duration Transducer) loss: the duration-aware lattice
forward recursion, differentiable through autograd.

The port's counterpart of `nemotron_tpu/losses/tdt.py` (Xu et al., ICML
2023). The joint emits [vocab + n_durations] logits: the first V are
token logits (blank = V-1), the trailing D a distribution over the static
duration set. Lattice moves:

  - a TOKEN at node (t, u) emits label u+1 and advances time by any d in
    durations:        (t, u) -> (t + d, u + 1)
  - a BLANK advances time by d >= 1:   (t, u) -> (t + d, u)
  - every prediction is conditioned on a real frame: t <= T_b - 1;
  - a path ends at (T_b, U_b), with no final blank.

  loss_b = -alpha(T_b, U_b)

Every dependency of node (t, u) lies on an earlier anti-diagonal k = t + u:
(t-d, u) on k-d and (t-d, u-1) on k-d-1 for d >= 1, and (t, u-1) on k-1
for d = 0. So the recursion runs over the T + U + 1 diagonals, each one a
vectorized step, and each node accumulates in the JAX package's order:
durations ascending, blank before token, then the d = 0 move.

`sigma` is the paper's logit under-normalization: sigma is subtracted from
every token log-prob during training.
"""

from __future__ import annotations

import torch

from .rnnt import NEG_INF, skew


def split_tdt_logits(logits, n_durations: int):
    """[..., V + D] joint outputs -> (token logits [..., V],
    duration logits [..., D])."""
    return logits[..., :-n_durations], logits[..., -n_durations:]


def tdt_loss(logits, labels, logit_lengths, label_lengths,
             durations, blank: int | None = None, sigma: float = 0.0):
    """Negative log-likelihood of the TDT lattice, per sequence
    (nemotron_tpu/losses/tdt.py:51-195).

    logits: [B, T, U+1, V + D] joint outputs; the trailing
        D = len(durations) slots are the duration head.
    labels: [B, U] int (padding past label_lengths is ignored).
    logit_lengths: [B] valid encoder frames (<= T).
    label_lengths: [B] valid labels (<= U).
    durations: the duration set, sorted, unique, non-negative, with at
        least one d >= 1 (ValueError otherwise).
    blank: blank token id within the V token logits (default V-1).
    sigma: logit under-normalization.

    Returns loss [B] f32."""
    durations = tuple(int(d) for d in durations)
    if sorted(set(durations)) != list(durations) or durations[0] < 0:
        raise ValueError(f"durations must be sorted unique >= 0: {durations}")
    D = len(durations)
    B, T, U1, VD = logits.shape
    U = U1 - 1
    V = VD - D
    if blank is None:
        blank = V - 1
    has_zero = durations[0] == 0
    pos_durs = [d for d in durations if d >= 1]
    if not pos_durs:
        raise ValueError("durations must contain at least one d >= 1")
    dur_index = {d: i for i, d in enumerate(durations)}
    dev = logits.device
    f32 = torch.float32
    logit_lengths = torch.as_tensor(logit_lengths, device=dev).long()
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()

    tok_logits, dur_logits = split_tdt_logits(logits.to(f32), D)
    lp_tok = (torch.log_softmax(tok_logits, dim=-1)
              - torch.tensor(sigma, dtype=f32, device=dev))
    lp_dur = torch.log_softmax(dur_logits, dim=-1)          # [B, T, U+1, D]

    lp_blank = lp_tok[..., blank]                            # [B, T, U+1]
    lab = labels.to(dev).long().clamp(0, V - 1)[:, None, :, None]
    lp_emit = torch.gather(lp_tok[:, :, :U, :], -1,
                           lab.expand(B, T, U, 1))[..., 0]   # [B, T, U]

    # a prediction conditioned on frame t >= T_b contributes nothing
    t_valid = (torch.arange(T, device=dev)[None, :]
               < logit_lengths[:, None])                     # [B, T]
    frame_mask = torch.where(t_valid, 0.0, NEG_INF).to(f32)
    lp_blank = lp_blank + frame_mask[:, :, None]
    lp_emit = lp_emit + frame_mask[:, :, None]
    # emitting label u (0-based) requires u < U_b
    u_ok = torch.arange(U, device=dev)[None, :] < label_lengths[:, None]
    lp_emit = lp_emit + torch.where(u_ok, 0.0, NEG_INF).to(f32)[:, None, :]

    # one masked row at t = T, where the paths end (the JAX package's pad
    # row: blank and emit NEG_INF, durations 0)
    lpb_p = torch.cat([lp_blank, torch.full((B, 1, U1), NEG_INF, dtype=f32,
                                            device=dev)], dim=1)
    lpe_p = torch.cat([lp_emit, torch.full((B, 1, U), NEG_INF, dtype=f32,
                                           device=dev)], dim=1)
    lpd_p = torch.cat([lp_dur, torch.zeros((B, 1, U1, D), dtype=f32,
                                           device=dev)], dim=1)
    # emit log-probs by the node that receives them: column u holds label
    # u-1's (NEG_INF at u = 0)
    lpe_in = torch.cat([torch.full((B, T + 1, 1), NEG_INF, dtype=f32,
                                   device=dev), lpe_p], dim=2)
    lpd_in = torch.cat([torch.zeros((B, T + 1, 1, D), dtype=f32, device=dev),
                        lpd_p[:, :, :U]], dim=2)

    n_diag = T + U + 1                   # k = t + u over t <= T, u <= U
    # read along diagonal k at index u, from row t - d (window rows before
    # t = 0 hold NEG_INF log-probs and zero duration log-probs, as JAX's)
    src = {}
    for d in pos_durs:
        def t_of(k, u, d=d):
            return k - u - d
        j = dur_index[d]
        src[d] = (skew(lpb_p, n_diag, t_of, NEG_INF),
                  skew(lpd_p[..., j], n_diag, t_of, 0.0),
                  skew(lpe_in, n_diag, t_of, NEG_INF),
                  skew(lpd_in[..., j], n_diag, t_of, 0.0))
    if has_zero:
        j0 = dur_index[0]
        # the d = 0 move into (t, u) from (t, u-1): e0 = emit + dur0 there
        e0 = skew(lpe_in, n_diag, lambda k, u: k - u, NEG_INF) + skew(
            lpd_in[..., j0], n_diag, lambda k, u: k - u, 0.0)

    u_idx = torch.arange(U1, device=dev)
    k_idx = torch.arange(n_diag, device=dev)[:, None]
    t_ok = (k_idx - u_idx[None, :] >= 0) & (k_idx - u_idx[None, :] <= T)
    neg = torch.full((B, 1), NEG_INF, dtype=f32, device=dev)
    alphas = [torch.cat([torch.zeros((B, 1), dtype=f32, device=dev),
                         neg.expand(B, U)], dim=1)]          # diagonal 0

    def at(k: int) -> torch.Tensor:
        """Diagonal k of alpha (all NEG_INF before diagonal 0)."""
        return alphas[k] if k >= 0 else neg.expand(B, U1)

    for k in range(1, n_diag):
        base = neg.expand(B, U1)
        for d in pos_durs:
            lpb, ld, lpe, ld_tok = (s[:, k] for s in src[d])
            base = torch.logaddexp(base, at(k - d) + lpb + ld)
            prev = torch.cat([neg, at(k - d - 1)[:, :U]], dim=1)
            tok = prev + lpe + ld_tok
            base = torch.logaddexp(
                base, torch.cat([neg, tok[:, 1:]], dim=1))
        if has_zero:
            vert = torch.cat([neg, alphas[k - 1][:, :U]], dim=1) + e0[:, k]
            alpha = torch.cat([base[:, :1],
                               torch.logaddexp(base[:, 1:], vert[:, 1:])],
                              dim=1)
        else:
            alpha = base
        alphas.append(torch.where(t_ok[k][None, :], alpha, NEG_INF))
    all_alphas = torch.stack(alphas)                         # [K, B, U+1]

    bidx = torch.arange(B, device=dev)
    t_term = logit_lengths.clamp(0, T)
    u_term = label_lengths.clamp(0, U)
    return -all_alphas[t_term + u_term, bidx, u_term]
