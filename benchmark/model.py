"""The model under test: seeded random weights made on the device, in a few
large calls, at the configuration's widths.

Every weight is drawn N(0, scale^2) (the "bench" init of the port's
`params.random_weight_arrays`, copied here, not called), LayerNorms at
identity. The matmul weights are drawn straight into the port's x @ w
orientation. The DSP takes NeMo's Slaney mel filterbank and a symmetric
Hann(400) window, in f32. The weights come from the configuration's own
seed, the same in every run; `--seed` draws the audio. The joint's blank
bias is the configuration's (`assumed.blank_bias`).

`make_weights` returns plain tensors by name, which both sides take:
`port_params` assembles them into the port's parameter structure (the
program under test), and the reference reads them as they are.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_shapes(m: dict) -> dict[str, tuple]:
    """Name -> shape of every N(0, scale^2) leaf, in the port's layout:
    Linear [in, out], conv2d HWIO, conformer leaves stacked [L, ...]."""
    D, FF, H, DH = m["d_model"], m["d_ff"], m["n_heads"], m["d_head"]
    L, K, C = m["n_layers"], m["kernel_size"], m["subsampling_channels"]
    V, DD, J = m["vocab_size"], m["decoder_dim"], m["joint_dim"]
    f = m["n_mels"]
    for _ in range(3):
        f = f // 2 + 1
    return {
        "sub.conv0_w": (3, 3, 1, C), "sub.conv0_b": (C,),
        "sub.conv2_w": (3, 3, 1, C), "sub.conv2_b": (C,),
        "sub.conv3_w": (1, 1, C, C), "sub.conv3_b": (C,),
        "sub.conv5_w": (3, 3, 1, C), "sub.conv5_b": (C,),
        "sub.conv6_w": (1, 1, C, C), "sub.conv6_b": (C,),
        "sub.out_w": (C * f, D), "sub.out_b": (D,),
        "layers.ffn1_w1": (L, D, FF), "layers.ffn1_w2": (L, FF, D),
        "layers.attn_q_w": (L, D, D), "layers.attn_k_w": (L, D, D),
        "layers.attn_v_w": (L, D, D), "layers.attn_pos_w": (L, D, D),
        "layers.attn_out_w": (L, D, D),
        "layers.pos_bias_u": (L, H, DH), "layers.pos_bias_v": (L, H, DH),
        "layers.conv_pw1_w": (L, D, 2 * D), "layers.conv_dw_w": (L, K, D),
        "layers.conv_pw2_w": (L, D, D),
        "layers.ffn2_w1": (L, D, FF), "layers.ffn2_w2": (L, FF, D),
        "dec.embedding": (V, DD),
        "dec.w_ih": (2, DD, 4 * DD), "dec.w_hh": (2, DD, 4 * DD),
        "dec.b_ih": (2, 4 * DD), "dec.b_hh": (2, 4 * DD),
        "joint.enc_w": (D, J), "joint.enc_b": (J,),
        "joint.dec_w": (DD, J), "joint.dec_b": (J,),
        "joint.out_w": (J, V), "joint.out_b": (V,),
    }


NORMS = ("norm_ff1", "norm_attn", "norm_conv", "conv_ln", "norm_ff2",
         "norm_final")


def make_weights(config: dict, device) -> dict[str, torch.Tensor]:
    """Every weight of the configuration, made on `device` from its
    `weights_seed`: one draw for all the N(0, scale^2) leaves, in the
    served dtype; the joint's blank logit biased by `assumed.blank_bias`."""
    m = config["model"]
    dt = DTYPES[config["compute_dtype"]]
    scale = config["init"]["scale"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["weights_seed"]))
    shapes = weight_shapes(m)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dt)
    flat.mul_(scale)
    out, ofs = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[ofs:ofs + n].view(shape)
        ofs += n
    out["joint.out_b"][m["vocab_size"] - 1] = config["assumed"]["blank_bias"]
    L, D = m["n_layers"], m["d_model"]
    for n in NORMS:
        out[f"layers.{n}_w"] = torch.ones((L, D), dtype=dt, device=device)
        out[f"layers.{n}_b"] = torch.zeros((L, D), dtype=dt, device=device)
    out["pre.filterbank"] = torch.from_numpy(
        mel_filterbank(m["n_mels"])).to(device)
    out["pre.window"] = torch.from_numpy(
        np.hanning(400).astype(np.float32)).to(device)
    return out


def model_config(config: dict):
    """The port's ModelConfig for the configuration's widths."""
    from nemotron_tpu_torch.config import ModelConfig

    return ModelConfig(**config["model"])


def port_params(w: dict[str, torch.Tensor], config: dict):
    """The port's ModelParams over the tensors of `make_weights`, with the
    encoder matmuls quantized by the port's own `quantize_model_params`
    where the configuration serves W8A8."""
    from nemotron_tpu_torch import params as P

    def group(prefix: str, cls, rename=None):
        rename = rename or {}
        return cls(**{f: w[f"{prefix}.{rename.get(f, f)}"]
                      for f in cls.__dataclass_fields__})

    params = P.ModelParams(
        subsampling=group("sub", P.SubsamplingParams),
        layers=group("layers", P.ConformerLayerParams),
        decoder=group("dec", P.DecoderParams),
        joint=group("joint", P.JointParams),
        preprocessor=P.PreprocessorParams(filterbank=w["pre.filterbank"],
                                          window=w["pre.window"]))
    if config["matmul"] == "w8a8":
        params = P.quantize_model_params(params, mode="w8a8")
    return params


def vocab(n: int) -> list[str]:
    """A SentencePiece-like vocabulary of n - 1 pieces and the blank: every
    third piece starts a word. The pieces only give the engine's
    detokenization its text to build."""
    letters = "etaoinshrdlucmfwypvbgkjqxz"
    out = []
    for i in range(n - 1):
        piece, k = "", i
        while True:
            piece += letters[k % 26]
            k //= 26
            if not k:
                break
        out.append(("▁" if i % 3 == 0 else "") + piece)
    return out + ["<blank>"]


def mel_filterbank(n_mels: int = 128, n_fft: int = 512,
                   sample_rate: int = 16000) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft / 2 + 1] (librosa's
    htk=False, norm='slaney'; NeMo's FilterbankFeatures builds it so), 0 Hz
    to Nyquist."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(
            np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(
            logstep * (m - min_log_mel)), f_sp * m)

    fft = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0),
                                n_mels + 2))
    ramps = pts[:, None] - fft[None, :]
    lower = -ramps[:-2] / np.diff(pts)[:-1, None]
    upper = ramps[2:] / np.diff(pts)[1:, None]
    fb = np.maximum(0, np.minimum(lower, upper))
    fb *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return fb.astype(np.float32)
