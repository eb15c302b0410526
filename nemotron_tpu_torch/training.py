"""Training: full-lattice joint logits, the transducer losses, and an AdamW
train step that updates the parameters in place.

The port's counterpart of `nemotron_tpu/training.py`. Pieces: the batch
encoder (optionally recomputing each layer in the backward pass), the
prediction network over label prefixes, the joint over the whole
(T, U+1) lattice, the RNN-T or TDT loss (losses/), the hybrid CTC term,
and the optimizer of `scripts/train.py`: global-norm clipping, AdamW with
optax's defaults and a warmup-cosine schedule.

Training runs on dense f32 parameters. The port's CUDA kernels (the Q8_0
and W8A8 matmuls, the ring attention) have no backward, so `loss_fn`
refuses quantized leaves instead of training through them, and the batch
encoder's attention is plain torch, as JAX's is XLA.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .losses.rnnt import rnnt_loss
from .losses.tdt import tdt_loss
from .models.ctc import ctc_logits
from .models.decoder import joint_project_enc
from .models.encoder import encode_batch
from .ops.lstm import lstm_step
from .ops.quant import QTensor, QTensorW8A8
from .params import ModelParams, _containers, flatten, map_leaves

# optax.adamw's defaults, and the weight decay scripts/train.py trains with
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4
CLIP_NORM = 1.0


def check_dense(params: ModelParams) -> None:
    """ValueError if any leaf is a QTensor or QTensorW8A8: the port's
    quantized matmuls are CUDA kernels without a backward, so their
    outputs would carry no gradient and nothing would say so."""
    for name, cls in _containers(params):
        for f in dataclasses.fields(cls):
            if isinstance(getattr(getattr(params, name), f.name),
                          (QTensor, QTensorW8A8)):
                raise ValueError(
                    f"{name}.{f.name} is quantized: training needs dense f32 "
                    "parameters (load_model(..., keep_quantized=False))")


def trainable(params: ModelParams) -> ModelParams:
    """A copy of the parameters whose leaves are fresh tensors that
    require grad (the train step updates them in place; the originals, and
    any numpy arrays they share memory with, are left as they are)."""
    check_dense(params)
    return map_leaves(lambda x: x.detach().clone().requires_grad_(True),
                      params)


def as_batch(batch: dict, device) -> dict:
    """A batch dict (numpy arrays or tensors) as tensors on `device`: mel
    f32, the rest int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v)
        out[k] = t.to(device=device, dtype=torch.float32 if k == "mel"
                      else torch.int64)
    return out


def prediction_network(params: ModelParams, cfg: ModelConfig, labels,
                       history=None) -> torch.Tensor:
    """The LSTM prediction network over label prefixes
    (nemotron_tpu/training.py:26-70).

    labels [B, U] int. Returns dec_out [B, U+1, H]: row u is the output
    after consuming labels[:u], row 0 the start state fed the blank token
    (greedy decode's initial state).

    history [B, R] int (optional): warm-up labels consumed before the
    utterance; the rows then condition on [blank, history, labels[:u]].
    Without it the network can learn the absolute token count ("after
    U_max tokens, always blank") and fall silent on a long stream."""
    # the LSTM's stacked weights unbound once: indexed at every step, each
    # step's backward would add a full-size gradient into them
    dp = dataclasses.replace(params.decoder, **{
        f: getattr(params.decoder, f).unbind(0)
        for f in ("w_ih", "w_hh", "b_ih", "b_hh")})
    B, U = labels.shape
    dev = dp.embedding.device
    parts = [torch.full((B, 1), cfg.blank_token, dtype=torch.int64,
                        device=dev)]
    R = 0
    if history is not None and history.shape[1]:
        R = history.shape[1]
        parts.append(torch.as_tensor(history).to(dev, torch.int64))
    parts.append(torch.as_tensor(labels).to(dev, torch.int64))
    tokens = torch.cat(parts, dim=1)                          # [B, 1+R+U]
    emb = dp.embedding[tokens]
    h = torch.zeros((B, cfg.decoder_layers, cfg.decoder_dim),
                    dtype=emb.dtype, device=dev)
    c = torch.zeros_like(h)
    outs = []
    for i in range(tokens.shape[1]):
        out, h, c = lstm_step(dp, emb[:, i], h, c)
        outs.append(out)
    # row R = the state after [blank, history]: conditioning for label 0
    return torch.stack(outs, dim=1)[:, R:, :]                # [B, U+1, H]


def transducer_logits_from_enc(params: ModelParams, cfg: ModelConfig, enc,
                               labels, history=None) -> torch.Tensor:
    """Joint lattice logits [B, T, U+1, V] f32 from encoder outputs [B, T,
    D] (nemotron_tpu/training.py:96-110; shared with the CTC term, so the
    encoder runs once)."""
    dec = prediction_network(params, cfg, labels, history=history)
    jp = params.joint
    enc_p = joint_project_enc(jp, enc)                       # [B, T, J]
    dec_p = dec @ jp.dec_w.to(dec.dtype) + jp.dec_b.to(dec.dtype)
    h = torch.relu(enc_p[:, :, None, :] + dec_p[:, None, :, :])
    return (h.to(torch.float32) @ jp.out_w.to(h.dtype).to(torch.float32)
            + jp.out_b.to(torch.float32))


def transducer_logits(params: ModelParams, cfg: ModelConfig, mel, labels,
                      remat: bool = False, enc_lengths=None,
                      att_chunk: int | None = None,
                      history=None) -> torch.Tensor:
    """Full-lattice joint logits [B, T, U+1, V] for training
    (nemotron_tpu/training.py:73-93). enc_lengths [B] (encoder frames)
    masks attention past each utterance, so padding cannot leak into the
    loss; att_chunk trains with the visibility of the cache-aware
    streaming step (pass cc.chunk_enc_len)."""
    enc = encode_batch(params, cfg, mel, enc_lengths=enc_lengths,
                       att_chunk=att_chunk, remat=remat)
    return transducer_logits_from_enc(params, cfg, enc, labels,
                                      history=history)


def loss_fn(params: ModelParams, cfg: ModelConfig, batch: dict,
            remat: bool = False, att_chunk: int | None = None,
            delay_penalty: float = 0.0, ctc_weight: float = 0.0,
            tdt_sigma: float = 0.05) -> torch.Tensor:
    """Mean transducer loss over a batch (nemotron_tpu/training.py:113-
    166), a scalar f32 tensor.

    batch: mel [B, Tm, n_mels], labels [B, U], mel_lengths [B] (encoder
    frames), label_lengths [B], optionally history [B, R] (decoder
    warm-up labels); numpy arrays or tensors.

    A TDT config (cfg.tdt_durations) trains with the duration-aware
    lattice (under-normalization tdt_sigma), and refuses delay_penalty,
    which applies to the RNN-T lattice only. ctc_weight > 0 (a hybrid
    checkpoint's CTC head) adds w * mean CTC loss over the same encoder
    output. Quantized parameters raise ValueError (check_dense)."""
    check_dense(params)
    if cfg.tdt_durations and delay_penalty:
        raise ValueError("delay_penalty applies to the RNN-T lattice "
                         "only (TDT trains duration-aware)")
    b = as_batch(batch, params.device)
    enc = encode_batch(params, cfg, b["mel"], enc_lengths=b["mel_lengths"],
                       att_chunk=att_chunk, remat=remat)
    logits = transducer_logits_from_enc(params, cfg, enc, b["labels"],
                                        history=b.get("history"))
    if cfg.tdt_durations:
        losses = tdt_loss(logits, b["labels"], b["mel_lengths"],
                          b["label_lengths"], cfg.tdt_durations,
                          blank=cfg.blank_token, sigma=tdt_sigma)
    else:
        losses = rnnt_loss(logits, b["labels"], b["mel_lengths"],
                           b["label_lengths"], blank=cfg.blank_token,
                           delay_penalty=delay_penalty)
    total = torch.mean(losses)
    if ctc_weight > 0.0:
        lp = torch.log_softmax(ctc_logits(params, enc), dim=-1)  # [B, T, V]
        ctc = F.ctc_loss(lp.transpose(0, 1), b["labels"], b["mel_lengths"],
                         b["label_lengths"], blank=cfg.blank_token,
                         reduction="none")
        total = total + ctc_weight * torch.mean(ctc)
    return total


# -- the optimizer of scripts/train.py ---------------------------------------

def warmup_cosine(count: int, lr: float, steps: int | None) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps,
    end_value=0.1 lr) at `count` (scripts/train.py:250-254), in float32
    and in optax's order of operations: warmup = min(100, max(steps //
    10, 1)) linear steps from 0, then a cosine to 0.1 lr at decay_steps =
    max(steps, warmup + 1). steps=None: the constant lr."""
    if steps is None:
        return lr
    f = np.float32
    warmup = min(100, max(steps // 10, 1))
    decay = max(steps, warmup + 1)
    if count < warmup:
        frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
        return float((f(0.0) - f(lr)) * frac + f(lr))
    alpha = 0.0 if lr == 0.0 else (lr * 0.1) / lr
    c = f(min(count - warmup, decay - warmup))
    cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(decay - warmup)))
    return float(f(lr) * ((f(1) - f(alpha)) * cosine + f(alpha)))


class WarmupCosine(torch.optim.lr_scheduler.LRScheduler):
    """The learning rate of step `count` is warmup_cosine(count): the
    count before the update, as optax indexes its schedules (so step 0
    runs at lr 0 under a schedule)."""

    def __init__(self, optimizer, lr: float, steps: int | None = None):
        self.peak = lr
        self.steps = steps
        super().__init__(optimizer)

    def get_lr(self):
        return [warmup_cosine(self.last_epoch, self.peak, self.steps)
                for _ in self.optimizer.param_groups]

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore the count; the schedule stays this run's (optax builds
        it from the flags, and its state holds only the count), and the
        optimizer's rate becomes this schedule's at the count."""
        peak, steps = self.peak, self.steps
        super().load_state_dict(state_dict)
        self.peak, self.steps = peak, steps
        self._last_lr = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, self._last_lr):
            group["lr"] = lr


def make_optimizer(params: ModelParams, lr: float, steps: int | None = None):
    """(AdamW, WarmupCosine) over every leaf of `params` (scripts/train.py:
    250-254): optax.adamw's betas (0.9, 0.999) and eps 1e-8 with weight
    decay 1e-4 (not torch's 1e-2), the schedule of warmup_cosine. The
    leaves are set to require grad and are updated in place by the train
    step (pass trainable(params) to keep the originals)."""
    check_dense(params)
    leaves = [x.requires_grad_(True) for x in flatten(params).values()]
    opt = torch.optim.AdamW(leaves, lr=warmup_cosine(0, lr, steps),
                            betas=ADAM_BETAS, eps=ADAM_EPS,
                            weight_decay=WEIGHT_DECAY)
    return opt, WarmupCosine(opt, lr, steps)


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float = CLIP_NORM) -> None:
    """optax.clip_by_global_norm in place: each g stays if the global norm
    is below max_norm, else becomes g / norm * max_norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_; no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(cfg: ModelConfig, optimizer, scheduler=None,
                    remat: bool = False, att_chunk: int | None = None,
                    delay_penalty: float = 0.0, ctc_weight: float = 0.0,
                    tdt_sigma: float = 0.05):
    """step(params, batch) -> loss (a detached scalar tensor; reading it
    is the caller's only host sync), updating in place the leaves the
    optimizer holds: zero the grads, backward, zero grads for leaves the
    loss does not reach (optax sees zeros there, so weight decay still
    applies), clip by global norm 1.0, the optimizer step, the schedule
    step (nemotron_tpu/training.py:202-230)."""
    leaves = [p for g in optimizer.param_groups for p in g["params"]]

    def step(params: ModelParams, batch: dict) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, cfg, batch, remat=remat, att_chunk=att_chunk,
                       delay_penalty=delay_penalty, ctc_weight=ctc_weight,
                       tdt_sigma=tdt_sigma)
        loss.backward()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm([p.grad for p in leaves])
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    return step


# -- train state -------------------------------------------------------------

def _structure(params: ModelParams) -> list:
    return [(k, tuple(v.shape), str(v.dtype))
            for k, v in flatten(params).items()]


def save_train_state(path: str, params: ModelParams, optimizer,
                     scheduler=None, step: int = 0) -> None:
    """Checkpoint params, optimizer and schedule state and the step count
    to one file, written to `path`.tmp and renamed, so an interrupted
    write leaves the previous checkpoint whole. The layout is the port's
    own (torch.save); params interchange with the JAX package through
    save_model / load_model."""
    state = {
        "structure": _structure(params),
        "params": {k: v.detach().to("cpu")
                   for k, v in flatten(params).items()},
        "optimizer": optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": int(step),
    }
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, params: ModelParams, optimizer,
                     scheduler=None) -> int:
    """Restore a save_train_state checkpoint into `params` (in place),
    `optimizer` and `scheduler`; returns the step count. A checkpoint of
    another model or optimizer structure raises ValueError."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if list(state["structure"]) != _structure(params):
        raise ValueError(f"{path}: checkpoint structure does not match "
                         "the model")
    saved_groups = state["optimizer"]["param_groups"]
    if [len(g["params"]) for g in saved_groups] != [
            len(g["params"]) for g in optimizer.param_groups]:
        raise ValueError(f"{path}: checkpoint structure does not match "
                         "the optimizer")
    with torch.no_grad():
        for k, v in flatten(params).items():
            v.copy_(state["params"][k])
    optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None and state["scheduler"] is not None:
        scheduler.load_state_dict(state["scheduler"])
    return state["step"]
