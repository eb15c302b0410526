"""The plain reference: the streaming recogniser written out from its
description, in float32 with TF32 off, over the benchmark's own weights.

It follows the published streaming FastConformer-RNN-T (NeMo's cache-aware
conformer with att_context_size [70, R], the reference C++ port's
docs/STREAMING.md): log-mel DSP, causal conv subsampling, conformer layers
whose attention keeps the last 70 frames of keys and values as a plain
list that grows by concatenation (no ring), relative positions computed
straight from each key's distance, a depthwise-conv cache, then the
2-layer LSTM prediction network and the joint. It imports nothing of the
program and takes no tensor the program made.

Precision follows what a configuration states:
  - matmul "w8a8": each encoder matmul quantizes its weight per column
    (amax / 127) and its input per row in groups of at most 1024 columns
    (max(amax, 1e-12) * (1 / 127)), and multiplies the integers exactly;
  - kv_cache "int8": each chunk's keys and values, once cached, are held
    at one scale per (layer, stream, head, chunk), amax / 127.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
LEVELS = {"dense": None, "int8": 127}
QUANT_FIELDS = ("ffn1_w1", "ffn1_w2", "ffn2_w1", "ffn2_w2", "attn_q_w",
                "attn_k_w", "attn_v_w", "attn_pos_w", "attn_out_w",
                "conv_pw1_w", "conv_pw2_w")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- DSP ---------------------------------------------------------------------

def log_mel(pcm: torch.Tensor, window400: torch.Tensor,
            filterbank: torch.Tensor) -> torch.Tensor:
    """Whole-recording log-mel [B, F, n_mels] of int16 PCM [B, N], framed
    as a streaming frontend frames it: 256 zeros of history ahead of the
    first sample, pre-emphasis 0.97 from a zero sample, 512-sample frames
    every 160 samples, Hann(400) centred in 512, power spectrum, the
    filterbank, log(x + 2^-24). Only whole frames are emitted."""
    x = pcm.to(F32) / 32768.0
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    emph = x - 0.97 * prev
    buf = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, 256), emph],
                    dim=1)
    n_frames = (buf.shape[1] - 512) // 160 + 1
    win = torch.zeros(512, dtype=F32, device=pcm.device)
    win[56:456] = window400.to(F32)
    idx = (torch.arange(n_frames, device=pcm.device)[:, None] * 160
           + torch.arange(512, device=pcm.device)[None, :])
    frames = buf[:, idx] * win                                # [B, F, 512]
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(power @ filterbank.to(F32).T + 2.0 ** -24)


# -- weights -------------------------------------------------------------------

def quantize_weight(w: torch.Tensor, levels: int):
    """Per-column symmetric quantization of [.., in, out]: (integer values
    as f32, scales [.., out])."""
    w = w.to(F32)
    amax = w.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / levels, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -levels, levels)
    return q, scale


class Weights:
    """The benchmark's weights in f32, with each encoder matmul weight
    quantized where the precision asks for it."""

    def __init__(self, w: dict, matmul: str):
        self.w = {k: v.to(F32) for k, v in w.items()}
        self.levels = LEVELS[{"dense": "dense", "w8a8": "int8"}[matmul]]
        self.q = {}
        if self.levels is not None:
            for f in QUANT_FIELDS:
                if f"layers.{f}" in w:
                    self.q[f] = quantize_weight(w[f"layers.{f}"],
                                                self.levels)

    def layer(self, l: int) -> dict:
        return {k.split(".", 1)[1]: v[l] for k, v in self.w.items()
                if k.startswith("layers.")}

    def dense(self, f: str, l: int) -> torch.Tensor:
        """A layer's matmul weight as the model computes with it."""
        if f in self.q:
            q, s = self.q[f]
            return q[l] * s[l][None, :]
        return self.w[f"layers.{f}"][l]

    def matmul(self, x: torch.Tensor, f: str, l: int) -> torch.Tensor:
        if f not in self.q:
            return x @ self.w[f"layers.{f}"][l]
        q, s = self.q[f][0][l], self.q[f][1][l]
        K = x.shape[-1]
        G = next((g for g in (1024, 512, 256) if K % g == 0), K)
        lead = x.shape[:-1]
        x = x.reshape(-1, K)
        inv = torch.tensor(1.0 / self.levels, dtype=F32)
        acc = torch.zeros((x.shape[0], q.shape[1]), dtype=F32,
                          device=x.device)
        for k0 in range(0, K, G):
            xt = x[:, k0:k0 + G]
            sx = torch.clamp_min(xt.abs().amax(dim=1, keepdim=True),
                                 1e-12) * inv
            xq = torch.clamp(torch.round(xt / sx), -self.levels,
                             self.levels)
            # integer products summed over at most 1024 columns stay below
            # 2^24: exact in f32 in any order (TF32 off)
            acc = acc + (xq @ q[k0:k0 + G]) * sx
        return (acc * s).reshape(*lead, q.shape[1])


# -- encoder -------------------------------------------------------------------

def layer_norm(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def causal_conv2d(x, w_hwio, b, stride, groups=1):
    """x [B, C, T, F]; causal pad (k - 1, stride - 1) on time and
    frequency."""
    kT, kF = w_hwio.shape[0], w_hwio.shape[1]
    x = torch.nn.functional.pad(x, (kF - 1, stride - 1, kT - 1, stride - 1))
    return torch.nn.functional.conv2d(x, w_hwio.permute(3, 2, 0, 1), b,
                                      stride=stride, groups=groups)


def subsample(w: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] -> [B, T', d_model]: three stride-2 causal conv
    stages (full, then two depthwise + pointwise), flatten channel-major,
    Linear."""
    C = w["sub.conv0_b"].shape[0]
    x = mel[:, None]
    x = torch.relu(causal_conv2d(x, w["sub.conv0_w"], w["sub.conv0_b"], 2))
    x = causal_conv2d(x, w["sub.conv2_w"], w["sub.conv2_b"], 2, groups=C)
    x = torch.relu(causal_conv2d(x, w["sub.conv3_w"], w["sub.conv3_b"], 1))
    x = causal_conv2d(x, w["sub.conv5_w"], w["sub.conv5_b"], 2, groups=C)
    x = torch.relu(causal_conv2d(x, w["sub.conv6_w"], w["sub.conv6_b"], 1))
    B, Cc, T, Fp = x.shape
    x = x.permute(0, 2, 1, 3).reshape(B, T, Cc * Fp)
    return x @ w["sub.out_w"] + w["sub.out_b"]


def sinusoid(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal embedding of relative distances [P] -> [P, d_model]."""
    i = torch.arange(0, d_model, 2, dtype=torch.float64, device=pos.device)
    ang = pos.double()[:, None] * torch.exp(-i * math.log(10000.0)
                                            / d_model)[None, :]
    out = torch.zeros((pos.shape[0], d_model), dtype=torch.float64,
                      device=pos.device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out.to(F32)


class StreamingModel:
    """B streams of the streaming recogniser, chunk by chunk."""

    def __init__(self, weights: Weights, m: dict, R: int, kv_cache: str,
                 batch: int, device):
        self.W, self.m, self.R = weights, m, R
        self.Q = 1 + R
        self.C = 70
        self.kv_levels = LEVELS[kv_cache]
        L, D = m["n_layers"], m["d_model"]
        self.H, self.Dh = m["n_heads"], m["d_head"]
        z = lambda *s: torch.zeros(s, dtype=F32, device=device)
        # per layer: cached keys / values [B, H, n, Dh] (the last <= 70
        # frames, as the model attends to them) and the conv cache
        self.k = [z(batch, self.H, 0, self.Dh) for _ in range(L)]
        self.v = [z(batch, self.H, 0, self.Dh) for _ in range(L)]
        self.conv = [z(batch, m["kernel_size"] - 1, D) for _ in range(L)]
        self.chunks = 0
        # projected positions for every distance a query can see:
        # d = -(Q - 1) .. C + Q - 1
        self.d0 = self.Q - 1
        dist = torch.arange(-(self.Q - 1), self.C + self.Q, device=device)
        emb = sinusoid(dist, D)
        self.pos = [(emb @ weights.dense("attn_pos_w", l)).reshape(
            -1, self.H, self.Dh) for l in range(L)]
        self.mel_tail = z(batch, 9, m["n_mels"])

    def _cache(self, x: torch.Tensor) -> torch.Tensor:
        """A chunk's keys or values as the cache will hold them."""
        if self.kv_levels is None:
            return x
        amax = x.abs().amax(dim=(-2, -1), keepdim=True)
        sc = torch.clamp_min(amax, 1e-12) / self.kv_levels
        return torch.clamp(torch.round(x / sc), -self.kv_levels,
                           self.kv_levels) * sc

    def _attention(self, l: int, a: torch.Tensor, lp: dict) -> torch.Tensor:
        B, Q, D = a.shape
        H, Dh = self.H, self.Dh
        heads = lambda t: t.reshape(B, Q, H, Dh).transpose(1, 2)
        q = heads(self.W.matmul(a, "attn_q_w", l))
        k = heads(self.W.matmul(a, "attn_k_w", l))
        v = heads(self.W.matmul(a, "attn_v_w", l))
        keys = torch.cat([self.k[l], k], dim=2)              # [B, H, n+Q, Dh]
        vals = torch.cat([self.v[l], v], dim=2)
        n = self.k[l].shape[2]
        # key j of the window (cache then chunk) is at time C - n + j;
        # query i at C + i; distance C + i - (C - n + j) = n + i - j
        i = torch.arange(Q, device=a.device)[:, None]
        j = torch.arange(n + Q, device=a.device)[None, :]
        dist = n + i - j                                      # [Q, n+Q]
        pos = self.pos[l][dist + self.d0]                     # [Q, n+Q, H, Dh]
        q_u = q + lp["pos_bias_u"][None, :, None, :]
        q_v = q + lp["pos_bias_v"][None, :, None, :]
        content = q_u @ keys.transpose(-1, -2)               # [B, H, Q, n+Q]
        position = torch.einsum("bhqd,qjhd->bhqj", q_v, pos)
        scores = (content + position) / math.sqrt(Dh)
        w = torch.softmax(scores, dim=-1)
        ctx = (w @ vals).transpose(1, 2).reshape(B, Q, D)
        self.k[l] = torch.cat([self.k[l], self._cache(k)], 2)[:, :, -self.C:]
        self.v[l] = torch.cat([self.v[l], self._cache(v)], 2)[:, :, -self.C:]
        return self.W.matmul(ctx, "attn_out_w", l)

    def _conv_module(self, l: int, x: torch.Tensor, lp: dict):
        y = self.W.matmul(x, "conv_pw1_w", l)
        c = y.shape[-1] // 2
        y = y[..., :c] * torch.sigmoid(y[..., c:])
        padded = torch.cat([self.conv[l], y], dim=1)
        Kk = lp["conv_dw_w"].shape[0]
        T = y.shape[1]
        out = sum(padded[:, k:k + T] * lp["conv_dw_w"][k] for k in range(Kk))
        self.conv[l] = padded[:, -(Kk - 1):]
        out = torch.nn.functional.silu(layer_norm(out, lp["conv_ln_w"],
                                                  lp["conv_ln_b"]))
        return self.W.matmul(out, "conv_pw2_w", l)

    def _ffn(self, l, x, n):
        h = torch.nn.functional.silu(self.W.matmul(x, f"ffn{n}_w1", l))
        return self.W.matmul(h, f"ffn{n}_w2", l)

    def encode_chunk(self, mel_chunk: torch.Tensor) -> torch.Tensor:
        """One chunk: mel [B, 9 + 8Q, n_mels] (9 frames of overlap first)
        -> the Q encoder frames [B, Q, D]; updates the caches."""
        x = subsample(self.W.w, mel_chunk)[:, 2:]
        for l in range(self.m["n_layers"]):
            lp = self.W.layer(l)
            r = x
            r = r + 0.5 * self._ffn(l, layer_norm(r, lp["norm_ff1_w"],
                                                  lp["norm_ff1_b"]), 1)
            r = r + self._attention(l, layer_norm(r, lp["norm_attn_w"],
                                                  lp["norm_attn_b"]), lp)
            r = r + self._conv_module(l, layer_norm(r, lp["norm_conv_w"],
                                                    lp["norm_conv_b"]), lp)
            r = r + 0.5 * self._ffn(l, layer_norm(r, lp["norm_ff2_w"],
                                                  lp["norm_ff2_b"]), 2)
            x = layer_norm(r, lp["norm_final_w"], lp["norm_final_b"])
        self.chunks += 1
        return x[:, :self.Q]

    def encode(self, mel: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """The first n_chunks chunks of a whole recording's log-mel
        [B, F, n_mels], the 9-frame overlap zero-seeded: [B, n_chunks * Q,
        D]."""
        step = 8 * self.Q
        mel = torch.cat([self.mel_tail, mel], dim=1)
        outs = [self.encode_chunk(mel[:, c * step:c * step + 9 + step])
                for c in range(n_chunks)]
        return torch.cat(outs, dim=1)


# -- decoder -------------------------------------------------------------------

def lstm(w: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Prediction network outputs after each prefix of `tokens` [B, U]
    (blank first): [B, U, decoder_dim]."""
    B, U = tokens.shape
    Hd = w["dec.w_hh"].shape[1]
    h = [torch.zeros((B, Hd), dtype=F32, device=tokens.device)
         for _ in range(2)]
    c = [torch.zeros_like(h[0]) for _ in range(2)]
    outs = []
    for u in range(U):
        x = w["dec.embedding"][tokens[:, u]]
        for l in range(2):
            g = (x @ w["dec.w_ih"][l] + h[l] @ w["dec.w_hh"][l]
                 + w["dec.b_ih"][l] + w["dec.b_hh"][l])
            i, f, gg, o = g.split(Hd, dim=-1)
            c[l] = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(gg)
            h[l] = torch.sigmoid(o) * torch.tanh(c[l])
            x = h[l]
        outs.append(x)
    return torch.stack(outs, dim=1)


def joint(w: dict, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Logits of encoder frames [.., D] against prediction outputs
    [.., decoder_dim]."""
    h = torch.relu(enc @ w["joint.enc_w"] + w["joint.enc_b"]
                   + pred @ w["joint.dec_w"] + w["joint.dec_b"])
    return h @ w["joint.out_w"] + w["joint.out_b"]

