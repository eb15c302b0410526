"""External label language model for shallow-fusion beam decoding and
second-pass n-best rescoring.

The port's counterpart of `nemotron_tpu/models/lm.py`. An LSTM LM over the
label vocabulary whose log-probs are added to the transducer's label
scores during beam expansion:

    score(y != blank) = log P_rnnt(y) + lm_weight * log P_lm(y | history)
    score(blank)      = log P_rnnt(blank)            (never LM-scored)

Blank is renormalized out of the LM's distribution; the LM state advances
on non-blank emissions, as the prediction network's does. The LM mirrors
the prediction network (embedding, stacked LSTM, output projection), so
`LMParams` carries the LSTM fields `ops.lstm.lstm_step` reads. It ships as
its own GGUF (`lm.*` tensors, architecture `nemo-lm`), so one LM serves
any acoustic checkpoint over the same vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lstm import lstm_step
from .beam import NEG_INF


@dataclasses.dataclass
class LMParams:
    """Embedding + stacked LSTM + output head; embed_dim == hidden so the
    layers stack into one [L, H, 4H]."""

    embedding: Any   # [V, H]
    w_ih: Any        # [L, H, 4H]  gate order [i, f, g, o]
    w_hh: Any        # [L, H, 4H]
    b_ih: Any        # [L, 4H]
    b_hh: Any        # [L, 4H]
    out_w: Any       # [H, V]
    out_b: Any       # [V]


def lm_to_device(lm: LMParams, device) -> LMParams:
    """The LM's leaves as tensors on `device` (numpy leaves converted; a
    leaf already there is the same tensor)."""
    return LMParams(**{
        f.name: torch.as_tensor(getattr(lm, f.name)).to(device)
        for f in dataclasses.fields(LMParams)})


def init_lm_state(lm: LMParams, batch_shape: tuple[int, ...],
                  dtype: torch.dtype, device):
    """Zero (h, c), each [*batch_shape, L, H]."""
    L, H = lm.w_hh.shape[0], lm.w_hh.shape[1]
    shape = tuple(batch_shape) + (L, H)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def lm_logp(lm: LMParams, prev_token: torch.Tensor, h: torch.Tensor,
            c: torch.Tensor, blank: int):
    """One LM step (nemotron_tpu/models/lm.py:61-76): prev_token [B] int32
    (blank = start of sequence, the prediction network's <bos>), h, c
    [B, L, H]. Returns (logp [B, V] f32 with logp[blank] = NEG_INF before
    the log-softmax, h', c')."""
    dt = h.dtype
    emb = lm.embedding.to(dt)[prev_token.long()]
    out, h2, c2 = lstm_step(lm, emb, h, c)
    logits = (out @ lm.out_w.to(dt) + lm.out_b.to(dt)).to(torch.float32)
    logits[..., blank] = NEG_INF
    return torch.log_softmax(logits, dim=-1), h2, c2


def lm_sequence_nll(lm: LMParams, labels: torch.Tensor,
                    lengths: torch.Tensor, blank: int,
                    inputs: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-label negative log-likelihood over a batch of sequences,
    a scalar f32 (nemotron_tpu/models/lm.py:77-110): the LM training
    objective. labels [B, U] int (positions >= lengths ignored); the input
    at step 0 is blank (<bos>) and at step t > 0 the previous label, with
    the distribution lm_logp serves at decode time. `inputs` [B, U]
    overrides the teacher-forced history (a corrupted copy of the shifted
    labels keeps the LM calibrated on the erroneous hypotheses it scores
    during beam fusion). Differentiable."""
    B, U = labels.shape
    dev = labels.device
    h, c = init_lm_state(lm, (B,), torch.float32, dev)
    if inputs is None:
        inputs = torch.cat([torch.full((B, 1), blank, dtype=labels.dtype,
                                       device=dev), labels[:, :-1]], dim=1)
    lengths = lengths.to(dev)
    nlls, valids = [], []
    for t in range(U):
        logp, h, c = lm_logp(lm, inputs[:, t], h, c, blank)
        nll = -torch.gather(logp, 1, labels[:, t:t + 1].long())[:, 0]
        valid = (t < lengths).to(torch.float32)
        nlls.append(nll * valid)
        valids.append(valid)
    return (torch.sum(torch.stack(nlls))
            / torch.clamp(torch.sum(torch.stack(valids)), min=1.0))


def lm_sequence_logp(lm: LMParams, labels: torch.Tensor,
                     lengths: torch.Tensor, blank: int) -> torch.Tensor:
    """Total label log-likelihood per sequence, [B] f32
    (nemotron_tpu/models/lm.py:112-138): teacher-forced over labels [B, U]
    int32 (positions >= lengths ignored; the step-0 input is blank), with
    the distribution shallow fusion uses. The second-pass rescoring
    score."""
    B, U = labels.shape
    dev = labels.device
    h, c = init_lm_state(lm, (B,), torch.float32, dev)
    inputs = torch.cat([torch.full((B, 1), blank, dtype=labels.dtype,
                                   device=dev), labels[:, :-1]], dim=1)
    total = torch.zeros((B,), dtype=torch.float32, device=dev)
    for t in range(U):
        logp, h, c = lm_logp(lm, inputs[:, t], h, c, blank)
        lp = torch.gather(logp, 1, labels[:, t:t + 1].long())[:, 0]
        # where, not multiply: a padded target is blank, whose logp is
        # NEG_INF
        total = total + torch.where(t < lengths, lp, 0.0)
    return total


def rescore_nbest(lm: LMParams, tokens: torch.Tensor, lengths: torch.Tensor,
                  scores: torch.Tensor, blank: int, lm_weight: float,
                  lm_bonus: float = 0.0, length_norm: bool = True):
    """Rerank a beam's n-best list (models/beam.n_best output) by
    raw_score + lm_weight * lm_sequence_logp + lm_bonus * length
    (nemotron_tpu/models/lm.py:141-175). Returns (order [B, N] int32 best
    first, by the combined score / max(length, 1) when length_norm, ties
    to the lower index; combined [B, N] f32 raw)."""
    B, N, U = tokens.shape
    lm_lp = lm_sequence_logp(
        lm, tokens.reshape(B * N, U),
        lengths.reshape(B * N).to(torch.int32), blank).reshape(B, N)
    lengths_f = lengths.to(torch.float32)
    combined = (scores.to(torch.float32) + lm_weight * lm_lp
                + lm_bonus * lengths_f)
    sel = (combined / torch.clamp(lengths_f, min=1.0) if length_norm
           else combined)
    order = torch.sort(sel, dim=1, descending=True, stable=True)[1]
    return order.to(torch.int32), combined


# -- the GGUF artifact (`nemo-lm` architecture) ------------------------------

def random_lm_arrays(vocab_size: int, hidden: int = 32, n_layers: int = 1,
                     seed: int = 0, scale: float = 0.3
                     ) -> dict[str, np.ndarray]:
    """Raw LM weights in the on-disk (PyTorch) naming and layout, the same
    draws as the JAX package's random_lm_arrays for a seed."""
    rng = np.random.default_rng(seed)

    def w(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    t = {"lm.embedding.weight": w(vocab_size, hidden),
         "lm.output.weight": w(vocab_size, hidden),
         "lm.output.bias": w(vocab_size)}
    for i in range(n_layers):
        t[f"lm.lstm.weight_ih_l{i}"] = w(4 * hidden, hidden)
        t[f"lm.lstm.weight_hh_l{i}"] = w(4 * hidden, hidden)
        t[f"lm.lstm.bias_ih_l{i}"] = w(4 * hidden)
        t[f"lm.lstm.bias_hh_l{i}"] = w(4 * hidden)
    return t


def _n_layers(t: dict) -> int:
    return sum(1 for k in t if k.startswith("lm.lstm.weight_ih_l"))


def lm_params_from_arrays(t: dict[str, np.ndarray],
                          device="cuda") -> LMParams:
    """On-disk arrays -> LMParams of f32 tensors on `device`, the matrices
    transposed for row-vector products."""
    device = resolve_device(device)
    ls = range(_n_layers(t))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return LMParams(
        embedding=put(t["lm.embedding.weight"]),
        w_ih=put(np.stack([t[f"lm.lstm.weight_ih_l{i}"].T for i in ls])),
        w_hh=put(np.stack([t[f"lm.lstm.weight_hh_l{i}"].T for i in ls])),
        b_ih=put(np.stack([t[f"lm.lstm.bias_ih_l{i}"] for i in ls])),
        b_hh=put(np.stack([t[f"lm.lstm.bias_hh_l{i}"] for i in ls])),
        out_w=put(t["lm.output.weight"].T),
        out_b=put(t["lm.output.bias"]))


def lm_arrays_from_params(lm: LMParams) -> dict[str, np.ndarray]:
    """Inverse of lm_params_from_arrays (for saving an LM)."""
    def host(x):
        return x.detach().to("cpu", torch.float32).numpy()

    t = {"lm.embedding.weight": host(lm.embedding),
         "lm.output.weight": np.ascontiguousarray(host(lm.out_w).T),
         "lm.output.bias": host(lm.out_b)}
    for i in range(lm.w_ih.shape[0]):
        t[f"lm.lstm.weight_ih_l{i}"] = np.ascontiguousarray(
            host(lm.w_ih[i]).T)
        t[f"lm.lstm.weight_hh_l{i}"] = np.ascontiguousarray(
            host(lm.w_hh[i]).T)
        t[f"lm.lstm.bias_ih_l{i}"] = host(lm.b_ih[i])
        t[f"lm.lstm.bias_hh_l{i}"] = host(lm.b_hh[i])
    return t


def save_lm(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write on-disk LM arrays as a `nemo-lm` GGUF (f32 tensors)."""
    from .. import gguf

    meta = {"general.architecture": "nemo-lm",
            "lm.vocab_size": arrays["lm.embedding.weight"].shape[0],
            "lm.hidden": arrays["lm.embedding.weight"].shape[1],
            "lm.n_layers": _n_layers(arrays)}
    gguf.write_gguf(path, meta, arrays)


def load_lm(path: str, device="cuda") -> LMParams:
    """A `nemo-lm` GGUF as LMParams on `device` (the card unless the
    caller asks for the CPU). Another architecture raises ValueError."""
    from .. import gguf

    g = gguf.read_gguf(path)
    arch = g.metadata.get("general.architecture")
    if isinstance(arch, bytes):
        arch = arch.decode()
    if arch != "nemo-lm":
        raise ValueError(f"{path}: not an LM GGUF "
                         f"(architecture={arch!r}, want 'nemo-lm')")
    return lm_params_from_arrays(
        {k: v.to_numpy() for k, v in g.tensors.items()}, device=device)
