"""The lattice losses of the training slice, PyTorch port against the JAX
package on the CPU: the RNN-T loss (with and without the delay penalty)
against JAX and a brute-force numpy DP, its padding independence and its
gradients against jax.grad; the TDT loss over three duration sets
against JAX and the JAX tests' own numpy oracles, its gradients, the zero
gradient on padded frames, and its refusals.

The port walks the lattices over anti-diagonals (t + u) where the JAX
package scans rows of t; each node takes the same operands, so the two
agree to the rounding of logaddexp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemotron_tpu.losses.rnnt import rnnt_loss as jrnnt
from nemotron_tpu.losses.tdt import tdt_loss as jtdt
from nemotron_tpu_torch.losses import rnnt_loss as trnnt
from nemotron_tpu_torch.losses.tdt import split_tdt_logits, tdt_loss as ttdt
from test_tdt import brute_tdt_loss, np_tdt_loss

torch.set_num_threads(1)

DURATION_SETS = [(0, 1, 2, 3), (0, 1, 2, 3, 4), (1, 2)]


def numpy_rnnt_loss(logits, labels, T, U, blank, delay_penalty=0.0):
    """Brute-force forward DP for one sequence, float64; the delay penalty
    subtracts delay_penalty * t from an emission at frame t."""
    x = logits.astype(np.float64)
    m = x.max(axis=-1, keepdims=True)
    logp = x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U + 1):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + logp[t - 1, u, blank])
            if u > 0:
                cands.append(alpha[t, u - 1] + logp[t, u - 1, labels[u - 1]]
                             - delay_penalty * t)
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[T - 1, U] + logp[T - 1, U, blank])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("delay_penalty", [0.0, 0.05])
@pytest.mark.parametrize("seed,T,U", [(0, 5, 3), (1, 8, 1), (2, 4, 0),
                                      (3, 6, 6)])
def test_rnnt_loss_matches_jax_and_numpy_dp(seed, T, U, delay_penalty):
    """The four (seed, T, U) cases of tests/test_training.py, padded past
    the valid lengths: the port equals JAX and the numpy DP within rtol
    1e-5 and atol 1e-5."""
    r = np.random.default_rng(seed)
    V, blank = 11, 10
    Tmax, Umax = T + 2, max(U + 2, 1)
    logits = r.standard_normal((1, Tmax, Umax + 1, V)).astype(np.float32)
    labels = r.integers(0, V - 1, size=(1, Umax)).astype(np.int32)
    got = trnnt(_t(logits), _t(labels), torch.tensor([T]), torch.tensor([U]),
                blank=blank, delay_penalty=delay_penalty)
    want = jrnnt(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray([T]),
                 jnp.asarray([U]), blank=blank, delay_penalty=delay_penalty)
    dp = numpy_rnnt_loss(logits[0], labels[0], T, U, blank, delay_penalty)
    assert got.dtype == torch.float32 and got.shape == (1,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got[0]), dp, rtol=1e-5, atol=1e-5)


def test_rnnt_loss_batch_padding_independence():
    """Padding beyond the valid lengths does not change the loss (the JAX
    test's corruption: +100 on padded frames, relabelled padded labels)."""
    r = np.random.default_rng(7)
    V, blank = 9, 8
    logits = r.standard_normal((2, 7, 5, V)).astype(np.float32)
    labels = r.integers(0, V - 1, size=(2, 4)).astype(np.int32)
    lens, ulens = torch.tensor([5, 7]), torch.tensor([2, 4])
    base = trnnt(_t(logits), _t(labels), lens, ulens, blank=blank)
    logits2 = logits.copy()
    logits2[0, 5:] += 100.0
    labels2 = labels.copy()
    labels2[0, 2:] = 0
    pert = trnnt(_t(logits2), _t(labels2), lens, ulens, blank=blank)
    np.testing.assert_allclose(base.numpy(), pert.numpy(), rtol=1e-5,
                               atol=1e-4)
    want = jrnnt(jnp.asarray(logits), jnp.asarray(labels),
                 jnp.asarray([5, 7]), jnp.asarray([2, 4]), blank=blank)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("delay_penalty", [0.0, 0.05])
def test_rnnt_loss_grad_matches_jax(delay_penalty):
    """d mean(loss) / d logits equals jax.grad within 1e-5 of the largest
    |g|, on a ragged batch; padded frames and lattice rows past a
    sequence's labels get exactly 0."""
    r = np.random.default_rng(11)
    B, T, U, V = 3, 9, 4, 13
    logits = r.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = r.integers(0, V - 1, size=(B, U)).astype(np.int32)
    tl, ul = np.array([9, 6, 4]), np.array([4, 2, 0])

    def jloss(lg):
        return jnp.mean(jrnnt(lg, jnp.asarray(labels), jnp.asarray(tl),
                              jnp.asarray(ul), blank=V - 1,
                              delay_penalty=delay_penalty))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = _t(logits).requires_grad_(True)
    trnnt(x, _t(labels), _t(tl), _t(ul), blank=V - 1,
          delay_penalty=delay_penalty).mean().backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(g[1, 6:]).max() == 0.0 and np.abs(g[2, 4:]).max() == 0.0
    assert np.abs(g[1, :, 3:]).max() == 0.0


@pytest.mark.parametrize("durations", DURATION_SETS)
def test_tdt_loss_matches_jax_and_oracles(durations):
    """The ragged batch of tests/test_tdt.py (sigma 0.05): within 1e-5
    relative of JAX, and of the numpy DP and the path enumeration."""
    rng = np.random.default_rng(1234)
    B, T, U, V = 3, 7, 4, 11
    D = len(durations)
    logits = rng.standard_normal((B, T, U + 1, V + D)).astype(np.float32)
    labels = rng.integers(0, V - 1, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, 5, 6], np.int32)
    u_lens = np.array([U, 2, 0], np.int32)
    got = ttdt(_t(logits), _t(labels), _t(t_lens), _t(u_lens), durations,
               blank=V - 1, sigma=0.05).numpy()
    want = np.asarray(jtdt(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(t_lens), jnp.asarray(u_lens),
                           durations, blank=V - 1, sigma=0.05))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for b in range(B):
        dp = np_tdt_loss(logits[b], labels[b], int(t_lens[b]),
                         int(u_lens[b]), durations, V - 1, sigma=0.05)
        brute = brute_tdt_loss(logits[b, :t_lens[b]], labels[b],
                               int(t_lens[b]), int(u_lens[b]), durations,
                               V - 1, sigma=0.05)
        np.testing.assert_allclose(got[b], dp, rtol=2e-5)
        np.testing.assert_allclose(got[b], brute, rtol=2e-5)


@pytest.mark.parametrize("durations", DURATION_SETS)
def test_tdt_loss_grad_matches_jax_and_zero_on_padding(durations):
    """Gradients within 1e-5 of the largest |g| of jax.grad's, finite, and
    exactly 0 on padded frames (tests/test_tdt.py::test_tdt_loss_grad_
    finite's rule)."""
    rng = np.random.default_rng(5)
    B, T, U, V = 2, 5, 3, 7
    logits = rng.standard_normal(
        (B, T, U + 1, V + len(durations))).astype(np.float32)
    labels = rng.integers(0, V - 1, size=(B, U)).astype(np.int32)
    tl, ul = np.array([T, 4]), np.array([U, 2])

    def jloss(lg):
        return jnp.mean(jtdt(lg, jnp.asarray(labels), jnp.asarray(tl),
                             jnp.asarray(ul), durations))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = _t(logits).requires_grad_(True)
    ttdt(x, _t(labels), _t(tl), _t(ul), durations).mean().backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(g[1, 4:]).max() == 0.0


@pytest.mark.parametrize("durations,msg", [((0, 2, 1), "sorted"),
                                           ((0,), "d >= 1"),
                                           ((-1, 1), "sorted")])
def test_tdt_loss_refuses_bad_durations(durations, msg):
    """The JAX package's ValueErrors for an unsorted or negative set and
    for a set without a positive duration."""
    logits = torch.zeros((1, 3, 2, 5 + len(durations)))
    args = (logits, torch.zeros((1, 1), dtype=torch.int64), torch.tensor([3]),
            torch.tensor([1]), durations)
    with pytest.raises(ValueError, match=msg):
        ttdt(*args)
    with pytest.raises(ValueError, match=msg):
        jtdt(jnp.asarray(logits.numpy()), jnp.zeros((1, 1), jnp.int32),
             jnp.asarray([3]), jnp.asarray([1]), durations)


def test_split_tdt_logits():
    x = torch.arange(2 * 9, dtype=torch.float32).reshape(2, 9)
    tok, dur = split_tdt_logits(x, 4)
    assert tok.shape == (2, 5) and dur.shape == (2, 4)
    assert torch.equal(torch.cat([tok, dur], dim=-1), x)
