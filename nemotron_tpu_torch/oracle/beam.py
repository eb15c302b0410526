"""Plain-Python RNN-T beam search oracle (the port's own copy of
`nemotron_tpu/oracle/beam.py`): the differential ground truth for
`models/beam.py`'s batched on-device search. Single stream, Python lists,
no vectorization tricks -- deliberately the simplest possible statement of
the algorithm (per-frame expansion rounds, blank finishes the frame with
the prediction-network state frozen, top-K merge, force-finish after the
expansion bound). Consumes the raw weight dict like OracleModel."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import MAX_SYMBOLS_PER_STEP, ModelConfig
from . import ops


@dataclasses.dataclass
class Hyp:
    tokens: list
    score: float
    h: np.ndarray      # [L, H]
    c: np.ndarray
    prev: int
    lm_h: np.ndarray = None   # [L_lm, H_lm] (LM shallow fusion only)
    lm_c: np.ndarray = None


def log_softmax(x):
    m = np.max(x)
    e = x - m
    return e - np.log(np.sum(np.exp(e)))


class OracleBeam:
    def __init__(self, t: dict, cfg: ModelConfig, lm: dict | None = None,
                 lm_weight: float = 0.3, lm_bonus: float = 0.0):
        """lm: raw LM weight dict (models/lm.py naming) for shallow
        fusion -- labels score log P_rnnt + lm_weight * log P_lm, blank
        keeps the pure transducer score, LM state advances on non-blank."""
        self.t = t
        self.cfg = cfg
        self.lm = lm
        self.lm_weight = lm_weight
        self.lm_bonus = lm_bonus
        if lm is not None:
            self.lm_layers = sum(1 for k in lm
                                 if k.startswith("lm.lstm.weight_ih_l"))
            self.lm_hidden = lm["lm.embedding.weight"].shape[1]

    def _lm_step(self, prev: int, h, c):
        """LM label log-probs (blank renormalized out) + advanced state."""
        lm = self.lm
        x = lm["lm.embedding.weight"][prev]
        h2, c2 = h.copy(), c.copy()
        for li in range(self.lm_layers):
            h2[li], c2[li] = ops.lstm_cell(
                x, h[li], c[li],
                lm[f"lm.lstm.weight_ih_l{li}"],
                lm[f"lm.lstm.weight_hh_l{li}"],
                lm[f"lm.lstm.bias_ih_l{li}"],
                lm[f"lm.lstm.bias_hh_l{li}"])
            x = h2[li]
        logits = (x @ lm["lm.output.weight"].T
                  + lm["lm.output.bias"]).astype(np.float64)
        logits[self.cfg.blank_token] = -1e30
        return log_softmax(logits), h2, c2

    def _dec_step(self, prev: int, h, c):
        """Embedding + 2-layer LSTM (reference src/nemo-ggml.cpp:1013-1052)."""
        t, cfg = self.t, self.cfg
        x = t["decoder.prediction.embed.weight"][prev]
        h2, c2 = h.copy(), c.copy()
        for li in range(cfg.decoder_layers):
            sfx = f"decoder.prediction.dec_rnn.lstm.weight_ih_l{li}"
            sfx_h = f"decoder.prediction.dec_rnn.lstm.weight_hh_l{li}"
            b_i = t[f"decoder.prediction.dec_rnn.lstm.bias_ih_l{li}"]
            b_h = t[f"decoder.prediction.dec_rnn.lstm.bias_hh_l{li}"]
            h2[li], c2[li] = ops.lstm_cell(x, h[li], c[li],
                                           t[sfx], t[sfx_h], b_i, b_h)
            x = h2[li]
        return x, h2, c2

    def _joint_logp(self, enc_t, dec_out):
        t = self.t
        e = enc_t @ t["joint.enc.weight"].T + t["joint.enc.bias"]
        d = dec_out @ t["joint.pred.weight"].T + t["joint.pred.bias"]
        hj = np.maximum(e + d, 0.0)
        logits = hj @ t["joint.joint_net.2.weight"].T + t["joint.joint_net.2.bias"]
        return log_softmax(logits.astype(np.float64))

    def decode(self, enc: np.ndarray, beam_size: int,
               expansions: int = MAX_SYMBOLS_PER_STEP,
               max_tokens: int = 10 ** 9) -> Hyp:
        """enc [T, D] -> best Hyp. Mirrors models/beam.py exactly,
        including its non-merging of identical prefixes and its empty-slot
        seeding (one live hypothesis at score 0)."""
        cfg = self.cfg
        blank = cfg.blank_token
        L, H = cfg.decoder_layers, cfg.decoder_dim
        zlm = (np.zeros((self.lm_layers, self.lm_hidden), np.float32)
               if self.lm is not None else None)
        live = [Hyp([], 0.0, np.zeros((L, H), np.float32),
                    np.zeros((L, H), np.float32), blank,
                    zlm, zlm)]

        for et in enc:
            fin: list[Hyp] = []
            for _round in range(expansions):
                new_live = []
                cands = []  # (score, parent_idx, label, dec_cache)
                for i, hyp in enumerate(live):
                    dec_out, h2, c2 = self._dec_step(hyp.prev, hyp.h, hyp.c)
                    logp = self._joint_logp(et, dec_out)
                    # blank finishes with the PURE transducer score
                    fin.append(Hyp(hyp.tokens, hyp.score + logp[blank],
                                   hyp.h, hyp.c, hyp.prev,
                                   hyp.lm_h, hyp.lm_c))
                    lm_lp, lmh2, lmc2 = (None, None, None)
                    if self.lm is not None:
                        lm_lp, lmh2, lmc2 = self._lm_step(
                            hyp.prev, hyp.lm_h, hyp.lm_c)
                    for v in range(cfg.vocab_size):
                        if v == blank or len(hyp.tokens) >= max_tokens:
                            continue
                        s = hyp.score + logp[v]
                        if lm_lp is not None:
                            s += self.lm_weight * lm_lp[v] + self.lm_bonus
                        cands.append((s, i, v, (h2, c2, lmh2, lmc2)))
                fin = sorted(fin, key=lambda x: -x.score)[:beam_size]
                cands.sort(key=lambda x: -x[0])
                for score, i, v, (h2, c2, lmh2, lmc2) in cands[:beam_size]:
                    new_live.append(Hyp(live[i].tokens + [v], score,
                                        h2, c2, v, lmh2, lmc2))
                live = new_live

            # force-finish the survivors
            for hyp in live:
                dec_out, _h2, _c2 = self._dec_step(hyp.prev, hyp.h, hyp.c)
                logp = self._joint_logp(et, dec_out)
                fin.append(Hyp(hyp.tokens, hyp.score + logp[blank],
                               hyp.h, hyp.c, hyp.prev,
                               hyp.lm_h, hyp.lm_c))
            live = sorted(fin, key=lambda x: -x.score)[:beam_size]

        return max(live, key=lambda x: x.score)
