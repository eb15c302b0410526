"""Numpy oracle model: batch encoder, streaming encoder, RNN-T decode (the
port's own copy of `nemotron_tpu/oracle/model.py`).

Consumes the raw PyTorch-order weight dict (reference naming,
docs/TENSOR_SHAPES.md). Single sequence, [T, D] arrays, float32. This is the
differential ground truth for tests -- see reference src/reference/ for the
role it plays, and reference src/nemo-stream.cpp for the streaming semantics
replicated by OracleStream.
"""

from __future__ import annotations

import numpy as np

from ..config import CacheConfig, ModelConfig, MAX_SYMBOLS_PER_STEP
from . import ops


class OracleModel:
    def __init__(self, t: dict[str, np.ndarray], cfg: ModelConfig = ModelConfig()):
        self.t = t
        self.cfg = cfg

    # -- encoder ------------------------------------------------------------

    def conv_subsampling(self, mel: np.ndarray) -> np.ndarray:
        """mel [T, n_mels] -> [T//8(+1s), d_model].

        Stage structure: reference src/nemo-ggml.cpp:877-952. Flatten order is
        feature index = c * F' + f (reference src/nemo-ggml.cpp:937-940)."""
        t = self.t
        x = mel[:, :, None]  # [T, F, 1]
        x = ops.causal_conv2d(x, t["encoder.pre_encode.conv.0.weight"],
                              t["encoder.pre_encode.conv.0.bias"], stride=2)
        x = ops.relu(x)
        x = ops.causal_conv2d(x, t["encoder.pre_encode.conv.2.weight"],
                              t["encoder.pre_encode.conv.2.bias"], stride=2,
                              groups=x.shape[-1])
        x = ops.causal_conv2d(x, t["encoder.pre_encode.conv.3.weight"],
                              t["encoder.pre_encode.conv.3.bias"], stride=1)
        x = ops.relu(x)
        x = ops.causal_conv2d(x, t["encoder.pre_encode.conv.5.weight"],
                              t["encoder.pre_encode.conv.5.bias"], stride=2,
                              groups=x.shape[-1])
        x = ops.causal_conv2d(x, t["encoder.pre_encode.conv.6.weight"],
                              t["encoder.pre_encode.conv.6.bias"], stride=1)
        x = ops.relu(x)
        # x: [T', F', C] -> flatten with index c*F' + f -> [T', C*F']
        Tp, Fp, C = x.shape
        flat = x.transpose(0, 2, 1).reshape(Tp, C * Fp)
        return ops.linear(flat, t["encoder.pre_encode.out.weight"],
                          t["encoder.pre_encode.out.bias"])

    def _mha(self, x: np.ndarray, pos_emb: np.ndarray, p: str) -> np.ndarray:
        """Batch rel-pos MHA. x [T, D]; pos_emb [2T-1, D] descending."""
        t, cfg = self.t, self.cfg
        H, DH = cfg.n_heads, cfg.d_head
        T = x.shape[0]
        q = ops.linear(x, t[f"{p}.linear_q.weight"]).reshape(T, H, DH)
        k = ops.linear(x, t[f"{p}.linear_k.weight"]).reshape(T, H, DH)
        v = ops.linear(x, t[f"{p}.linear_v.weight"]).reshape(T, H, DH)
        pos = ops.linear(pos_emb, t[f"{p}.linear_pos.weight"]).reshape(-1, H, DH)

        q_u = q + t[f"{p}.pos_bias_u"]
        q_v = q + t[f"{p}.pos_bias_v"]
        # content: [H, T, T]; position: [H, T, 2T-1]
        content = np.einsum("ihd,jhd->hij", q_u, k)
        pos_raw = np.einsum("ihd,phd->hip", q_v, pos)
        pos_attn = ops.rel_shift(pos_raw)
        scores = (content + pos_attn) / np.sqrt(DH)
        w = ops.softmax(scores, axis=-1)
        ctx = np.einsum("hij,jhd->ihd", w, v).reshape(T, H * DH)
        return ops.linear(ctx, t[f"{p}.linear_out.weight"])

    def _conv_module(self, x: np.ndarray, p: str,
                     cache: np.ndarray | None = None,
                     cache_out: list | None = None) -> np.ndarray:
        t = self.t
        pw1 = t[f"{p}.pointwise_conv1.weight"]
        if pw1.ndim == 3:
            pw1 = pw1.squeeze(2)
        cur = ops.glu(ops.linear(x, pw1))
        dw = t[f"{p}.depthwise_conv.weight"]
        w_kd = dw.squeeze(1).T if dw.ndim == 3 else dw  # [K, D]
        if cache_out is not None:
            K = w_kd.shape[0]
            pad = cache if cache is not None else np.zeros((K - 1, cur.shape[1]), np.float32)
            padded = np.concatenate([pad, cur], axis=0)
            cache_out.append(padded[-(K - 1):].copy())
        cur = ops.causal_conv1d_depthwise(cur, w_kd, cache)
        cur = ops.layer_norm(cur, t[f"{p}.batch_norm.weight"], t[f"{p}.batch_norm.bias"])
        cur = ops.silu(cur)
        pw2 = t[f"{p}.pointwise_conv2.weight"]
        if pw2.ndim == 3:
            pw2 = pw2.squeeze(2)
        return ops.linear(cur, pw2)

    def _ffn(self, x: np.ndarray, p: str) -> np.ndarray:
        t = self.t
        return ops.linear(ops.silu(ops.linear(x, t[f"{p}.linear1.weight"])),
                          t[f"{p}.linear2.weight"])

    def conformer_layer(self, x: np.ndarray, pos_emb: np.ndarray, i: int) -> np.ndarray:
        """Residual structure: reference src/nemo-ggml.cpp:768-813."""
        t = self.t
        p = f"encoder.layers.{i}"
        r = x
        cur = ops.layer_norm(r, t[f"{p}.norm_feed_forward1.weight"],
                             t[f"{p}.norm_feed_forward1.bias"])
        r = r + 0.5 * self._ffn(cur, f"{p}.feed_forward1")
        cur = ops.layer_norm(r, t[f"{p}.norm_self_att.weight"],
                             t[f"{p}.norm_self_att.bias"])
        r = r + self._mha(cur, pos_emb, f"{p}.self_attn")
        cur = ops.layer_norm(r, t[f"{p}.norm_conv.weight"], t[f"{p}.norm_conv.bias"])
        r = r + self._conv_module(cur, f"{p}.conv")
        cur = ops.layer_norm(r, t[f"{p}.norm_feed_forward2.weight"],
                             t[f"{p}.norm_feed_forward2.bias"])
        r = r + 0.5 * self._ffn(cur, f"{p}.feed_forward2")
        return ops.layer_norm(r, t[f"{p}.norm_out.weight"], t[f"{p}.norm_out.bias"])

    def encoder(self, mel: np.ndarray) -> np.ndarray:
        """Full batch encoder: mel [T, n_mels] -> [T', d_model]."""
        x = self.conv_subsampling(mel)
        T = x.shape[0]
        pos_emb = ops.pos_emb_descending(T, self.cfg.d_model)
        for i in range(self.cfg.n_layers):
            x = self.conformer_layer(x, pos_emb, i)
        return x

    # -- decoder / joint / greedy -------------------------------------------

    def decoder_step(self, token: int, h: np.ndarray, c: np.ndarray):
        """One prediction-network step. h, c: [2, 640]."""
        t = self.t
        dp = "decoder.prediction"
        emb = t[f"{dp}.embed.weight"][token]
        h_new = h.copy()
        c_new = c.copy()
        x = emb
        for l in (0, 1):
            hl, cl = ops.lstm_cell(
                x, h[l], c[l],
                t[f"{dp}.dec_rnn.lstm.weight_ih_l{l}"],
                t[f"{dp}.dec_rnn.lstm.weight_hh_l{l}"],
                t[f"{dp}.dec_rnn.lstm.bias_ih_l{l}"],
                t[f"{dp}.dec_rnn.lstm.bias_hh_l{l}"],
            )
            h_new[l], c_new[l] = hl, cl
            x = hl
        return x, h_new, c_new

    def joint(self, enc_frame: np.ndarray, dec_out: np.ndarray) -> np.ndarray:
        t = self.t
        e = ops.linear(enc_frame, t["joint.enc.weight"], t["joint.enc.bias"])
        d = ops.linear(dec_out, t["joint.pred.weight"], t["joint.pred.bias"])
        return ops.linear(ops.relu(e + d), t["joint.joint_net.2.weight"],
                          t["joint.joint_net.2.bias"])

    def greedy_decode(self, enc: np.ndarray, state: dict | None = None,
                      with_confidence: bool = False):
        """Greedy RNN-T over encoder frames [T, D].

        Returns (tokens: list[(token, frame)], state). Blank freezes the LSTM
        state and advances to the next frame; at most MAX_SYMBOLS_PER_STEP
        non-blanks per frame (reference src/nemo-ggml.cpp:1260-1429).
        with_confidence appends each emission's log softmax posterior:
        (token, frame, conf) -- the ground truth for greedy_decode's
        with_confidence output."""
        cfg = self.cfg
        blank = cfg.blank_token
        if state is None:
            state = {
                "h": np.zeros((2, cfg.decoder_dim), np.float32),
                "c": np.zeros((2, cfg.decoder_dim), np.float32),
                "prev_token": blank,
                "frame_offset": 0,
            }
        tokens: list[tuple] = []
        h, c, prev = state["h"], state["c"], state["prev_token"]
        off = state["frame_offset"]
        for ti in range(enc.shape[0]):
            for _ in range(MAX_SYMBOLS_PER_STEP):
                dec_out, h_new, c_new = self.decoder_step(prev, h, c)
                logits = self.joint(enc[ti], dec_out)
                best = int(np.argmax(logits))
                if best == blank:
                    break
                if with_confidence:
                    m = float(logits.max())
                    conf = -float(np.log(np.exp(logits - m).sum()))
                    tokens.append((best, off + ti, conf))
                else:
                    tokens.append((best, off + ti))
                prev = best
                h, c = h_new, c_new
        state = {"h": h, "c": c, "prev_token": prev,
                 "frame_offset": off + enc.shape[0]}
        return tokens, state


class OracleStream:
    """Cache-aware streaming oracle.

    Replicates reference src/nemo-stream.cpp:961-1057 per chunk: subsampling,
    drop_extra_pre_encoded, validity-masked cached MHA, cached depthwise conv,
    sliding K/V window, valid_out truncation, and stateful greedy decode.
    Mel buffering (9-frame zero-seeded overlap, shift_mel advance) mirrors
    nemo_stream_process_incremental (src/nemo-stream.cpp:1074-1134)."""

    def __init__(self, model: OracleModel, cache_cfg: CacheConfig):
        self.m = model
        self.cc = cache_cfg
        cfg = model.cfg
        L, D = cfg.n_layers, cfg.d_model
        C = cache_cfg.att_left_context
        self.k_cache = np.zeros((L, C, D), np.float32)
        self.v_cache = np.zeros((L, C, D), np.float32)
        self.conv_cache = np.zeros((L, cache_cfg.conv_cache_size, D), np.float32)
        self.cache_valid_len = 0
        self.dec_state = None
        self.mel_buffer = np.zeros(
            (cache_cfg.pre_encode_cache_size, cfg.n_mels), np.float32)
        self.tokens: list[tuple[int, int]] = []
        # pos_emb for kv_len, descending (reference src/nemo-stream.cpp:150-159)
        self.pos_emb = ops.pos_emb_descending(cache_cfg.kv_len, cfg.d_model)

    def _cached_mha(self, x: np.ndarray, li: int, mask: np.ndarray) -> np.ndarray:
        m, cc = self.m, self.cc
        t, cfg = m.t, m.cfg
        H, DH = cfg.n_heads, cfg.d_head
        p = f"encoder.layers.{li}.self_attn"
        Q = x.shape[0]
        cache_len = cc.att_left_context

        q = ops.linear(x, t[f"{p}.linear_q.weight"])
        k_new = ops.linear(x, t[f"{p}.linear_k.weight"])
        v_new = ops.linear(x, t[f"{p}.linear_v.weight"])

        k_full = np.concatenate([self.k_cache[li], k_new], axis=0)  # [kv, D]
        v_full = np.concatenate([self.v_cache[li], v_new], axis=0)
        self.k_cache[li] = k_full[-cache_len:]
        self.v_cache[li] = v_full[-cache_len:]

        kv = k_full.shape[0]
        qh = q.reshape(Q, H, DH)
        kh = k_full.reshape(kv, H, DH)
        vh = v_full.reshape(kv, H, DH)
        pos = ops.linear(self.pos_emb, t[f"{p}.linear_pos.weight"]).reshape(-1, H, DH)

        q_u = qh + t[f"{p}.pos_bias_u"]
        q_v = qh + t[f"{p}.pos_bias_v"]
        content = np.einsum("ihd,jhd->hij", q_u, kh)              # [H, Q, kv]
        pos_raw = np.einsum("ihd,phd->hip", q_v, pos)             # [H, Q, P]
        pos_attn = ops.rel_shift_cached(pos_raw, kv)              # [H, Q, kv]
        scores = (content + pos_attn) / np.sqrt(DH) + mask        # mask [kv]
        w = ops.softmax(scores, axis=-1)
        ctx = np.einsum("hij,jhd->ihd", w, vh).reshape(Q, H * DH)
        return ops.linear(ctx, t[f"{p}.linear_out.weight"])

    def _cached_layer(self, x: np.ndarray, li: int, mask: np.ndarray) -> np.ndarray:
        m = self.m
        t = m.t
        p = f"encoder.layers.{li}"
        r = x
        cur = ops.layer_norm(r, t[f"{p}.norm_feed_forward1.weight"],
                             t[f"{p}.norm_feed_forward1.bias"])
        r = r + 0.5 * m._ffn(cur, f"{p}.feed_forward1")
        cur = ops.layer_norm(r, t[f"{p}.norm_self_att.weight"],
                             t[f"{p}.norm_self_att.bias"])
        r = r + self._cached_mha(cur, li, mask)
        cur = ops.layer_norm(r, t[f"{p}.norm_conv.weight"], t[f"{p}.norm_conv.bias"])
        cache_out: list = []
        conv = m._conv_module(cur, f"{p}.conv", cache=self.conv_cache[li],
                              cache_out=cache_out)
        self.conv_cache[li] = cache_out[0]
        r = r + conv
        cur = ops.layer_norm(r, t[f"{p}.norm_feed_forward2.weight"],
                             t[f"{p}.norm_feed_forward2.bias"])
        r = r + 0.5 * m._ffn(cur, f"{p}.feed_forward2")
        return ops.layer_norm(r, t[f"{p}.norm_out.weight"], t[f"{p}.norm_out.bias"])

    def encode_chunk(self, mel_chunk: np.ndarray) -> np.ndarray:
        """mel_chunk [chunk_mel_frames, n_mels] -> valid encoder frames
        [valid_out, d_model]."""
        cc = self.cc
        assert mel_chunk.shape[0] == cc.chunk_mel_frames
        x = self.m.conv_subsampling(mel_chunk)
        x = x[cc.drop_extra_pre_encoded:]
        chunk_len = x.shape[0]

        # validity mask: positions [0, 70-valid) of the cache are -1e9
        offset = cc.att_left_context - self.cache_valid_len
        mask = np.zeros(cc.att_left_context + chunk_len, np.float32)
        mask[:offset] = -1e9

        # per-layer-group lookahead (NeMo per-group right context; the
        # reference's limitation #2, docs/STREAMING.md:540-548): layer li
        # may attend at most rc[li] frames ahead within the current chunk
        rcs = cc.rc_schedule(self.m.cfg.n_layers)
        for li in range(self.m.cfg.n_layers):
            m_l = mask
            if rcs is not None:
                i = np.arange(chunk_len)[:, None]
                j = np.arange(mask.shape[0])[None, :]
                future = (j - cc.att_left_context) - i > rcs[li]
                m_l = mask[None, :] + np.where(
                    future, np.float32(-1e9), np.float32(0.0))
            x = self._cached_layer(x, li, m_l)

        self.cache_valid_len = min(self.cache_valid_len + chunk_len,
                                   cc.att_left_context)
        return x[: cc.valid_out_len]

    def process_mel(self, mel: np.ndarray) -> list[tuple[int, int]]:
        """Append mel frames, run all complete chunks, greedy-decode. Returns
        newly emitted (token, frame) pairs."""
        cc = self.cc
        self.mel_buffer = np.concatenate([self.mel_buffer, mel], axis=0)
        new_tokens: list[tuple[int, int]] = []
        while self.mel_buffer.shape[0] >= cc.chunk_mel_frames:
            enc = self.encode_chunk(self.mel_buffer[: cc.chunk_mel_frames])
            toks, self.dec_state = self.m.greedy_decode(enc, self.dec_state)
            new_tokens.extend(toks)
            self.mel_buffer = self.mel_buffer[cc.shift_mel_frames:]
        self.tokens.extend(new_tokens)
        return new_tokens
