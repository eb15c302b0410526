"""RNN-T (transducer) loss: the forward-variable recursion on the (T, U)
lattice, differentiable through autograd.

The port's counterpart of `nemotron_tpu/losses/rnnt.py` (Graves 2012):

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])
    loss = -(alpha[T_b-1, U_b] + blank[T_b-1, U_b])

The JAX package scans rows of t and, inside each, the in-row emit prefix
over u. Here the recursion runs over anti-diagonals k = t + u instead:
every node of diagonal k depends only on diagonal k-1, so the lattice is
T + U vectorized steps rather than a T x U Python loop. Each node takes
the same two operands as in the row scan, so only the rounding inside
logaddexp can differ. Masking uses the finite NEG_INF (never -inf, whose
logaddexp has a NaN gradient), so a padded frame or label gets a gradient
of exactly 0.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def skew(x: torch.Tensor, n_diag: int, t_of, fill: float) -> torch.Tensor:
    """Lattice values [B, T, W, ...] read along anti-diagonals: out[b, k, u]
    = x[b, t_of(k, u), u] for k < n_diag, `fill` where that t is outside
    [0, T)."""
    B, T, W = x.shape[:3]
    k = torch.arange(n_diag, device=x.device)[:, None]
    u = torch.arange(W, device=x.device)[None, :]
    t = t_of(k, u)                                           # [K, W]
    ok = (t >= 0) & (t < T)
    out = x[:, t.clamp(0, T - 1), u.expand_as(t)]            # [B, K, W, ...]
    ok = ok.reshape(ok.shape + (1,) * (x.dim() - 3))
    return torch.where(ok, out, torch.full((), fill, dtype=x.dtype,
                                           device=x.device))


def rnnt_loss(logits, labels, logit_lengths, label_lengths,
              blank: int | None = None, delay_penalty: float = 0.0):
    """Negative log-likelihood of the RNN-T lattice, per sequence
    (nemotron_tpu/losses/rnnt.py:27-107).

    logits: [B, T, U+1, V] joint outputs (unnormalized).
    labels: [B, U] int (padded with anything past label_lengths).
    logit_lengths: [B] valid encoder frames (<= T).
    label_lengths: [B] valid labels (<= U).
    blank: blank token id (default V-1).
    delay_penalty: lambda > 0 subtracts lambda * t from every label
        emission (the delay-penalized transducer); the returned value is
        the penalized objective.

    Returns loss [B] f32."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    if blank is None:
        blank = V - 1
    dev = logits.device
    logit_lengths = torch.as_tensor(logit_lengths, device=dev).long()
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()

    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    lp_blank = logp[..., blank]                              # [B, T, U+1]
    lab = labels.to(dev).long().clamp(0, V - 1)[:, None, :, None]
    lp_emit = torch.gather(logp[:, :, :U, :], -1,
                           lab.expand(B, T, U, 1))[..., 0]   # [B, T, U]
    if delay_penalty:
        lp_emit = lp_emit - (
            torch.tensor(delay_penalty, dtype=torch.float32, device=dev)
            * torch.arange(T, dtype=torch.float32, device=dev)[None, :, None])

    n_diag = T + U                       # k = t + u over t < T, u <= U
    # node (t, u) on diagonal k sits at index u, t = k - u: its blank
    # operand is row t-1's blank at u, its emit operand row t's emit at u-1
    lpb = skew(lp_blank, n_diag, lambda k, u: k - u - 1, NEG_INF)
    pad = torch.full((B, T, 1), NEG_INF, dtype=torch.float32, device=dev)
    lpe = skew(torch.cat([pad, lp_emit], dim=2), n_diag,
               lambda k, u: k - u, NEG_INF)
    u_idx = torch.arange(U1, device=dev)
    valid_u = u_idx[None, :] <= label_lengths[:, None]       # [B, U+1]
    k_idx = torch.arange(n_diag, device=dev)[:, None]
    t_ok = (k_idx - u_idx[None, :] >= 0) & (k_idx - u_idx[None, :] < T)

    neg = torch.full((B, 1), NEG_INF, dtype=torch.float32, device=dev)
    alpha = torch.cat([torch.zeros((B, 1), dtype=torch.float32, device=dev),
                       neg.expand(B, U)], dim=1)             # diagonal 0
    alphas = [alpha]
    for k in range(1, n_diag):
        from_blank = alpha + lpb[:, k]
        from_emit = torch.cat([neg, alpha[:, :-1]], dim=1) + lpe[:, k]
        alpha = torch.where(valid_u & t_ok[k][None, :],
                            torch.logaddexp(from_blank, from_emit), NEG_INF)
        alphas.append(alpha)
    all_alphas = torch.stack(alphas)                         # [K, B, U+1]

    bidx = torch.arange(B, device=dev)
    t_last = (logit_lengths - 1).clamp(0, T - 1)
    u_last = label_lengths.clamp(0, U)
    alpha_term = all_alphas[t_last + u_last, bidx, u_last]
    return -(alpha_term + lp_blank[bidx, t_last, u_last])
